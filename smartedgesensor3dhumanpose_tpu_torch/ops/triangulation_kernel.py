"""Kernel F1 (csrc/triangulation.cu): the fusion's triangulation of a batch
of person hypotheses in one launch.

`fusion.triangulate_hypotheses` computes, per hypothesis, the view masks,
the weighted DLT in coefficient form with its leave-one-out and three-view
outlier rejection, the score down-weighting, the unscented covariance and
the limb, root and feet gates, and scatters the 17 input joints into the
21-joint fusion layout. Its plain PyTorch body (`fusion._triangulate_plain`)
launches ~1,900 kernels a call on the card, each much shorter than its
launch; F1 runs the same arithmetic, one block per hypothesis, with every
intermediate in shared memory, and writes the persons once.

A rig wider than a block's shared memory holds (`fits`: C <= 91) takes
F1's wide variant (`fits_wide`: C <= 742; triangulation_wide_kernel in
the source), which keeps the per-view arrays the phases write in a slice
of device memory per hypothesis (`wide_bytes`, allocated per launch on
the launch's stream, so a capture records it) and the arithmetic as it
is.

`fusion.triangulation_route` takes F1 for CUDA tensors in float32 whose
camera count fits F1's shared memory (`fits`), its wide variant where
that count fits `fits_wide`, the plain body elsewhere (the CPU, float64,
wider rigs). `triangulate` launches either, by the camera count; it
raises for what neither takes, and never falls back.

`triangulate(..., host=True)` runs the same source built for the host by
a C++ compiler (`_kernels.host_library`): the kernel's phases one task
after another, bit for bit the card's arithmetic. The CPU tests hold it
to the plain body, the card tests the kernel to it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch import _kernels, skeleton
from smartedgesensor3dhumanpose_tpu_torch.config import FusionConfig
from smartedgesensor3dhumanpose_tpu_torch.types import Persons3D

J = skeleton.NUM_INPUT_JOINTS
K = skeleton.NUM_FUSION_JOINTS
# Shared memory one thread block may hold on an H100 (static + dynamic,
# after the opt-in); F1 declares no static shared memory, the reserve is a
# margin for what the runtime adds.
SMEM_PER_BLOCK = 232_448
STATIC_SMEM_RESERVE = 1_024
MAX_THREADS = 512
_SYM = 10  # unique entries of a symmetric 4x4
# csrc/triangulation.cu `Smem`, in 4-byte words: the fixed per-joint and
# fusion-layout arrays, and those that grow with the camera count (the
# camera constants, the keypoints, every view's contribution, the
# leave-one-out and sigma-point results); then two byte masks [17, C].
FIXED_WORDS = 2 * J * _SYM + 3 * J * 3 + 5 * J + 6 * J + K * 13 + 3 * J + K
WORDS_PER_CAMERA = 12 + 5 + 5 * _SYM + 2 * J * 3 + J * _SYM + J * 4 + J * 12
# The wide variant's split of WORDS_PER_CAMERA: the camera's P and its
# norms and the keypoints in shared memory, the rest in device memory.
SHARED_WORDS_PER_CAMERA = 12 + 5 + J * 3
DEVICE_WORDS_PER_CAMERA = WORDS_PER_CAMERA - SHARED_WORDS_PER_CAMERA


def smem_bytes(cameras: int, wide: bool = False) -> int:
    """F1's dynamic shared memory at `cameras` cameras, or its wide
    variant's (triangulation.cu::smem_bytes_for)."""
    per_camera = SHARED_WORDS_PER_CAMERA if wide else WORDS_PER_CAMERA
    return 4 * (FIXED_WORDS + per_camera * cameras) + 2 * J * cameras


def wide_bytes(cameras: int) -> int:
    """The wide variant's device memory for one hypothesis
    (triangulation.cu::device_floats_for, in bytes)."""
    return 4 * DEVICE_WORDS_PER_CAMERA * cameras


def threads(cameras: int) -> int:
    """Threads of a block: one per (joint, solve slot) of the widest phase,
    in whole warps, at most MAX_THREADS (triangulation.cu::threads_for)."""
    return min(-(-J * (cameras + 2) // 32) * 32, MAX_THREADS)


# The most cameras whose working set fits a block, and the most whose
# shared part in the wide variant does.
MAX_CAMERAS = (SMEM_PER_BLOCK - STATIC_SMEM_RESERVE - 4 * FIXED_WORDS) // (
    4 * WORDS_PER_CAMERA + 2 * J)
MAX_CAMERAS_WIDE = (SMEM_PER_BLOCK - STATIC_SMEM_RESERVE - 4 * FIXED_WORDS) // (
    4 * SHARED_WORDS_PER_CAMERA + 2 * J)


def fits(cameras: int) -> bool:
    """Whether F1 takes a rig of `cameras` cameras."""
    return 1 <= cameras <= MAX_CAMERAS


def fits_wide(cameras: int) -> bool:
    """Whether F1's wide variant takes a rig of `cameras` cameras that F1
    does not."""
    return MAX_CAMERAS < cameras <= MAX_CAMERAS_WIDE


class Params(ctypes.Structure):
    """triangulation.cu `Params`, field by field."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("c", ctypes.c_int),
        ("min_kp_score", ctypes.c_float),
        ("reproj_max", ctypes.c_float),
        ("kappa", ctypes.c_float),
        ("two_kappa", ctypes.c_float),
        ("limb_offset", ctypes.c_float),
        ("max_root_dist", ctypes.c_float),
        ("max_feet_height", ctypes.c_float),
        ("min_valid", ctypes.c_int),
        ("to_fusion", ctypes.c_int * J),
        ("from_fusion", ctypes.c_int * K),
        ("limb_parent", ctypes.c_int * J),
        ("limb_len", ctypes.c_float * J),
        ("limb_sigma", ctypes.c_float * J),
        ("shoulder_r", ctypes.c_int),
        ("shoulder_l", ctypes.c_int),
        ("shoulder_dist", ctypes.c_float),
        ("shoulder_sigma", ctypes.c_float),
    ]


def params(config: FusionConfig, n: int, cameras: int) -> Params:
    """The launch's settings: the config's gates as float32 (as the plain
    body's comparisons cast them) and the input model's tables."""
    model = skeleton.input_model(config.pose_method)
    to_fusion = [int(x) for x in model.to_fusion]
    from_fusion = [-1] * K
    for j, fj in enumerate(to_fusion):
        from_fusion[fj] = j
    has_limb = (np.asarray(model.parent) >= 0) & (np.asarray(model.limb_length) > 0)
    r17, l17 = model.shoulder_pair
    p = Params()
    p.n, p.c = n, cameras
    p.min_kp_score = config.min_kp_score
    p.reproj_max = config.reproj_error_max_acceptable
    p.kappa = config.ut_kappa
    p.two_kappa = 2.0 * config.ut_kappa
    p.limb_offset = config.limb_cov_offset_sigma
    p.max_root_dist = config.max_joint_dist_to_root
    p.max_feet_height = config.max_feet_height
    p.min_valid = config.min_num_valid_keypoints
    p.to_fusion[:] = to_fusion
    p.from_fusion[:] = from_fusion
    p.limb_parent[:] = [int(q) if ok else -1 for q, ok in zip(model.parent, has_limb)]
    p.limb_len[:] = [float(x) for x in model.limb_length]
    p.limb_sigma[:] = [float(x) for x in model.limb_sigma]
    p.shoulder_r = to_fusion[r17] if r17 >= 0 else -1
    p.shoulder_l = to_fusion[l17] if r17 >= 0 else -1
    p.shoulder_dist = model.shoulder_dist
    p.shoulder_sigma = model.shoulder_sigma
    return p


def _check(kp, cov, cam_mask, P, F) -> tuple:
    """(hypotheses, cameras) of F1's inputs; raises on what it does not
    take: kp, cov [N, C, 17, 3] float32; cam_mask [N, C] bool; P
    [C, 3, 4] and F [C, C, 3, 3] float32; all on one device; C within
    `fits` or `fits_wide`."""
    if kp.dim() != 4 or kp.shape[2:] != (J, 3):
        raise ValueError(f"kp must be [N, C, {J}, 3]; got {tuple(kp.shape)}")
    n, c = kp.shape[:2]
    want = {"cov": (cov, (n, c, J, 3)), "cam_mask": (cam_mask, (n, c)),
            "P": (P, (c, 3, 4)), "F": (F, (c, c, 3, 3))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} with kp {tuple(kp.shape)}; "
                             f"got {tuple(t.shape)}")
        if t.device != kp.device:
            raise ValueError(f"{name} is on {t.device}, kp on {kp.device}")
    for name, t in (("kp", kp), ("cov", cov), ("P", P), ("F", F)):
        if t.dtype != torch.float32:
            raise TypeError(f"the triangulation kernel takes float32; {name} is {t.dtype}")
    if cam_mask.dtype != torch.bool:
        raise TypeError(f"cam_mask must be bool; got {cam_mask.dtype}")
    if not (fits(c) or fits_wide(c)):
        raise ValueError(f"the triangulation kernel takes 1 to {MAX_CAMERAS_WIDE} cameras; "
                         f"got {c}")
    return n, c


def _outputs(n: int, device) -> Persons3D:
    return Persons3D(
        xyz=torch.empty((n, K, 3), dtype=torch.float32, device=device),
        score=torch.empty((n, K), dtype=torch.float32, device=device),
        cov=torch.empty((n, K, 3, 3), dtype=torch.float32, device=device),
        valid=torch.empty((n,), dtype=torch.bool, device=device),
        person_id=torch.empty((n,), dtype=torch.int32, device=device),
    )


def _drops_ptr(drops, n: int, device) -> int | None:
    """The optional drop-view output's pointer: an int32 [N, 17] tensor on
    the inputs' device, or None."""
    if drops is None:
        return None
    if drops.shape != (n, J) or drops.dtype != torch.int32 or drops.device != torch.device(device) \
            or not drops.is_contiguous():
        raise ValueError(f"drops must be a contiguous int32 [{n}, {J}] tensor on {device}; got "
                         f"{drops.dtype} {tuple(drops.shape)} on {drops.device}")
    return drops.data_ptr()


def _pointers(kp, cov, cam_mask, P, F, out: Persons3D) -> list:
    return [t.data_ptr() for t in (kp, cov, cam_mask, P, F, *out)]


def triangulate(kp, cov, cam_mask, P, F, config: FusionConfig, drops=None,
                host: bool = False) -> Persons3D:
    """F1 on the card: the persons [N, 21, ...] (person_id -1) of N
    hypotheses, kp and cov [N, C, 17, 3], cam_mask [N, C], on the rig's P
    [C, 3, 4] and F [C, C, 3, 3]. One launch (of the wide variant past
    MAX_CAMERAS) on the current stream of the tensors' device; no host
    sync, so a capture records it. `drops`, an int32 [N, 17] tensor,
    receives each joint's dropped view (-1 none). `host` runs F1's host
    build on CPU tensors (CPU tensors out), the kernel's arithmetic bit for
    bit: the tests' handle on it."""
    n, c = _check(kp, cov, cam_mask, P, F)
    if (kp.device.type == "cuda") == host:
        raise ValueError(f"the triangulation kernel{' (host build)' if host else ''} runs on "
                         f"{'CPU' if host else 'CUDA'} tensors; got {kp.device}")
    tensors = [t.contiguous() for t in (kp, cov, cam_mask, P, F)]
    drops_ptr = _drops_ptr(drops, n, kp.device)
    out = _outputs(n, kp.device)
    p = params(config, n, c)
    wide = fits_wide(c)
    if host:
        err = _kernels.host_library().ses3d_triangulation_host(
            ctypes.byref(p), *_pointers(*tensors, out), drops_ptr, int(wide))
        _kernels.check(err, f"triangulation host build (n={n}, cameras={c}, wide={wide})")
        return out
    smem = smem_bytes(c, wide)
    dev = (torch.empty(max(n, 1) * wide_bytes(c) // 4, dtype=torch.float32, device=kp.device)
           if wide else None)
    _kernels.launch("triangulation_wide" if wide else "triangulation", "ses3d_triangulate",
                    kp.device, ctypes.byref(p), *_pointers(*tensors, out), drops_ptr,
                    None if dev is None else dev.data_ptr(), smem,
                    what=f"triangulation launch (n={n}, cameras={c}, wide={wide}, smem={smem})")
    return out
