"""Kernel F1 (csrc/triangulation.cu, ops/triangulation_kernel.py): the
fusion's triangulation of a batch of hypotheses in one launch.

On the CPU: the route (`fusion.triangulation_route`), the wrapper's
argument checks, its shared-memory plan against the source's, its
settings against the input models, and the kernel's arithmetic through
its host build (the same source compiled by a C++ compiler, the block's
phases one task after another) against the plain PyTorch body on the
golden demo frames (their three-view and leave-one-out drops included)
and a 64-camera frame, bit for bit, and inside the pipeline; the wide
variant's (C > 91) on seeded hypotheses at 92, 120 and 480 cameras. On a
card: the kernel against its host build bit for bit, and against the
plain body on the card. This file imports no JAX: the card's
machine has none (test_torch_triangulation_jax.py holds the host build to
the JAX package).
"""

import ctypes
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu_torch import (
    _kernels,
    cameras,
    config,
    fusion,
    pipeline,
    skeleton,
    tracing,
)
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import triangulation_kernel as tk
from smartedgesensor3dhumanpose_tpu_torch.types import Frame

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_golden_demo16.npz")
# (scene, pose method): the golden scenes (the adversarial one drops 32
# views of three-view joints and 25 of wider joints in its first 16
# frames), and the adversarial frames read as H36M keypoints (no shoulder
# pair, a MidHip joint).
CASES = (("benign", "simple"), ("adversarial", "simple"), ("adversarial", "h36m"))
FRAMES = 16
# chip_smoke.py's scaled layout: 64 cameras x 25 persons.
SCALED_SCENE = dict(num_cameras=64, num_people=25, num_frames=2, seed=1)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _scene_frames(scene: str, num_dets: int, frames: int = FRAMES) -> dict:
    if scene == "scaled":
        kw = SCALED_SCENE
    else:
        kw = json.loads(str(np.load(GOLDEN)[f"{scene}/scene"]))
    data = synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw)),
                                       np.float32)
    return {k: v[:frames] for k, v in synthetic.pad_detections(data, num_dets).items()}


def _config(scene: str, pose: str) -> config.PipelineConfig:
    if scene == "scaled":
        return config.PipelineConfig.scaled_64cam()
    cfg = config.PipelineConfig.demo_16cam()
    return dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, pose_method=pose),
                               prior=dataclasses.replace(cfg.prior, pose_method=pose))


def hypotheses(scene: str, pose: str, dtype, device="cpu"):
    """(flattened hypotheses, rig, fusion config) of a scene's first
    frames, as `fusion.fuse_frames` hands them to the triangulation."""
    cfg = _config(scene, pose).fusion
    data = _scene_frames(scene, cfg.max_dets_per_cam)
    rig = cameras.hall_rig(cfg.num_cameras, device=device, dtype=dtype)
    frames = Frame.from_arrays(data, device)
    frames = frames._replace(**{k: getattr(frames, k).to(dtype)
                                for k in ("kp2d", "cov2d", "det_score")})
    frames, _ = pipeline.mask_stale_cameras(frames, cfg.max_sync_diff)
    kp_n, cov_n, det_ok = fusion.normalize_frame(frames, rig, cfg)
    hyps = fusion.associate(kp_n, cov_n, frames.det_score, det_ok, rig, cfg)
    flat = hyps._replace(**{k: getattr(hyps, k).flatten(0, 1)
                            for k in ("kp", "cov", "cam_mask", "obs_score")})
    return flat, rig, cfg


def _views(hyps, cfg):
    """Each joint's view count k [N, 17]."""
    conf = hyps.kp.transpose(1, 2)[..., 2]
    return (hyps.cam_mask[:, None, :] & (conf >= cfg.min_kp_score)).sum(-1)


def assert_as_plain(got, drops, plain32, drops32, plain64, what: str):
    """F1's persons and drops against the plain body's: every decision
    (validity, joint score > 0, dropped view) that of float32; xyz, score
    and covariance no further from float64 than twice float32's worst."""
    assert torch.equal(got.valid, plain32.valid), what
    assert torch.equal(got.score > 0, plain32.score > 0), what
    assert torch.equal(drops, drops32.to(torch.int32)), what
    assert torch.equal(got.person_id, plain32.person_id), what
    for name in ("xyz", "score", "cov"):
        mine = (getattr(got, name).double() - getattr(plain64, name)).abs().max()
        ref = (getattr(plain32, name).double() - getattr(plain64, name)).abs().max()
        assert mine <= 2 * ref, f"{what} {name}: {float(mine):.3e} > 2 x {float(ref):.3e}"


# ------------------------------------------------------------- the route --

@pytest.mark.parametrize("device, dtype, cameras_, want", [
    ("cpu", torch.float32, 16, "plain"),
    ("cpu", torch.float64, 16, "plain"),
    ("cuda", torch.float64, 16, "plain"),
    ("cuda", torch.float32, 16, "kernel"),
    ("cuda", torch.float32, 64, "kernel"),
    ("cuda", torch.float32, tk.MAX_CAMERAS, "kernel"),
    ("cuda", torch.float32, tk.MAX_CAMERAS + 1, "wide"),
    ("cuda", torch.float32, 480, "wide"),
    ("cuda", torch.float32, tk.MAX_CAMERAS_WIDE, "wide"),
    ("cuda", torch.float32, tk.MAX_CAMERAS_WIDE + 1, "plain"),
    ("cuda", torch.float64, 480, "plain"),
    ("cpu", torch.float32, 480, "plain"),
])
def test_route(device, dtype, cameras_, want):
    """F1 on CUDA in float32 where the rig's cameras fit its shared
    memory (the demo's 16 and the scaled 64 do, 91 at most), its wide
    variant past that (the Panoptic dome's 480), the plain body on the
    CPU, in float64 and past the wide variant's limit."""
    assert fusion.triangulation_route(cameras_, torch.device(device), dtype) == want


def test_smem_plan_matches_the_source():
    """The wrapper's shared-memory bytes are the source's at every width it
    takes, and the widest fits a block; the block's threads cover one
    widest phase (17 x (C + 2) slots) in whole warps, at most 512. The
    same for the wide variant, whose device memory per hypothesis is the
    source's too, and which takes at least 512 cameras."""
    lib = _kernels.host_library()
    budget = tk.SMEM_PER_BLOCK - tk.STATIC_SMEM_RESERVE
    for c in (1, 2, 16, 17, 40, 64, tk.MAX_CAMERAS):
        assert lib.ses3d_triangulation_host_smem_bytes(c, 0) == tk.smem_bytes(c), c
    for c in (1, 16, tk.MAX_CAMERAS + 1, 480, tk.MAX_CAMERAS_WIDE):
        assert lib.ses3d_triangulation_host_smem_bytes(c, 1) == tk.smem_bytes(c, wide=True), c
        assert lib.ses3d_triangulation_host_wide_bytes(c) == tk.wide_bytes(c), c
    assert tk.smem_bytes(tk.MAX_CAMERAS) <= budget < tk.smem_bytes(tk.MAX_CAMERAS + 1)
    assert (tk.smem_bytes(tk.MAX_CAMERAS_WIDE, wide=True) <= budget
            < tk.smem_bytes(tk.MAX_CAMERAS_WIDE + 1, wide=True))
    assert tk.MAX_CAMERAS >= 64 and tk.MAX_CAMERAS_WIDE >= 512
    assert [tk.threads(c) for c in (1, 16, 64, 480)] == [64, 320, 512, 512]


@pytest.mark.parametrize("pose", ("simple", "h36m"))
def test_params_mirror_the_input_model(pose):
    model = skeleton.input_model(pose)
    cfg = _config("benign", pose).fusion
    p = tk.params(cfg, 5, 16)
    assert (p.n, p.c) == (5, 16)
    assert list(p.to_fusion) == list(model.to_fusion)
    for fj in range(skeleton.NUM_FUSION_JOINTS):
        j = p.from_fusion[fj]
        assert (model.to_fusion[j] == fj) if j >= 0 else (fj not in model.to_fusion)
    for j in range(skeleton.NUM_INPUT_JOINTS):
        limb = model.parent[j] >= 0 and model.limb_length[j] > 0
        assert p.limb_parent[j] == (model.parent[j] if limb else -1)
    r, l = model.shoulder_pair
    assert (p.shoulder_r, p.shoulder_l) == ((-1, -1) if r < 0 else
                                            (model.to_fusion[r], model.to_fusion[l]))
    assert p.two_kappa == np.float32(2.0 * cfg.ut_kappa)
    assert p.reproj_max == np.float32(cfg.reproj_error_max_acceptable)


def _inputs(n=2, c=4, device="cpu"):
    kp = torch.zeros((n, c, 17, 3), device=device)
    return [kp, kp.clone(), torch.ones((n, c), dtype=torch.bool, device=device),
            torch.zeros((c, 3, 4), device=device), torch.zeros((c, c, 3, 3), device=device)]


@pytest.mark.parametrize("case, error, match", [
    ("cpu", ValueError, "CUDA tensors"),
    ("kp_dtype", TypeError, "float32"),
    ("F_dtype", TypeError, "float32"),
    ("mask_dtype", TypeError, "bool"),
    ("kp_joints", ValueError, "kp must be"),
    ("cov_shape", ValueError, "cov must be"),
    ("P_shape", ValueError, "P must be"),
    ("F_shape", ValueError, "F must be"),
    ("wide", ValueError, "cameras"),
])
def test_wrapper_refuses(case, error, match):
    """`triangulate` raises, before touching the library, on what F1 does
    not take."""
    args = _inputs()
    if case == "kp_dtype":
        args[0] = args[0].double()
    elif case == "F_dtype":
        args[4] = args[4].double()
    elif case == "mask_dtype":
        args[2] = args[2].to(torch.uint8)
    elif case == "kp_joints":
        args[0] = args[0][:, :, :16]
    elif case == "cov_shape":
        args[1] = args[1][:1]
    elif case == "P_shape":
        args[3] = args[3][:3]
    elif case == "F_shape":
        args[4] = args[4][:, :3]
    elif case == "wide":
        args = _inputs(c=tk.MAX_CAMERAS_WIDE + 1)
    with pytest.raises(error, match=match):
        tk.triangulate(*args, config.FusionConfig())


def test_wrappers_check_drops_and_devices():
    args = _inputs()
    cfg = config.FusionConfig()
    with pytest.raises(ValueError, match="drops must be"):
        tk.triangulate(*args, cfg, host=True, drops=torch.zeros((2, 17), dtype=torch.int64))
    with pytest.raises(ValueError, match="drops must be"):
        tk.triangulate(*args, cfg, host=True, drops=torch.zeros((3, 17), dtype=torch.int32))
    empty = tk.triangulate(*_inputs(n=0), cfg, host=True)
    assert empty.xyz.shape == (0, 21, 3) and empty.valid.shape == (0,)


# ---------------------------------------------- the arithmetic, on the CPU --

def assert_equals_plain(flat, rig, cfg, what: str):
    """F1's host build against the plain body in float32, bit for bit:
    every output and every joint's dropped view. Returns the drops."""
    plain, plain_drops = fusion._triangulate_plain(flat, rig, cfg, with_drops=True)
    drops = torch.empty((flat.kp.shape[0], 17), dtype=torch.int32)
    got = tk.triangulate(flat.kp, flat.cov, flat.cam_mask, rig.P, rig.F, cfg, drops=drops,
                         host=True)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(plain, name)), f"{what} {name}"
    assert torch.equal(drops, plain_drops.to(torch.int32)), what
    assert int(got.valid.sum()) > 0
    return drops


@pytest.mark.parametrize("scene, pose", CASES)
def test_host_build_matches_plain(scene, pose):
    """F1 takes the plain body's operations in the order they run on the
    CPU (its sums over views and sigma points as PyTorch's CPU reductions
    take them, its einsums' and 3-vector norms' multiply-add chains): its
    host build equals the plain body in float32 bit for bit on a golden
    scene's first 16 frames (256 hypotheses), drops included."""
    flat, rig, cfg = hypotheses(scene, pose, torch.float32)
    drops = assert_equals_plain(flat, rig, cfg, f"{scene}/{pose}")
    if scene == "adversarial":
        k = _views(flat, cfg)
        assert int(((drops >= 0) & (k == 3)).sum()) > 0
        assert int(((drops >= 0) & (k >= 4)).sum()) > 0


def test_host_build_matches_plain_scaled():
    """The same at 64 cameras (PipelineConfig.scaled_64cam, 40 slots)."""
    flat, rig, cfg = hypotheses("scaled", "simple", torch.float32)
    assert_equals_plain(flat, rig, cfg, "scaled")


# Camera counts of the wide variant's host-build checks: just past F1's
# shared memory, a rig of its own, and the Panoptic dome's VGA array.
WIDE_CAMERAS = (tk.MAX_CAMERAS + 1, 120, 480)


def wide_hypotheses(cameras_: int, seed: int, n: int = 4):
    """Seeded hypotheses of a `cameras_`-camera hall (the rig's rings): n
    persons of one frame of the synthetic scene (each hypothesis one
    person's detections, no association), every other person's keypoints
    swapped in part with another's in 30% of the views (outliers for the
    leave-one-out drop at any width), and hypotheses 1 and 3 seen by three
    and five cameras only, one of them (0.2, -0.12) off in normalized
    coordinates (the three-view drop, and a leave-one-out drop past 91
    views, where one view in hundreds cannot move the error 10%). n is
    even: the plain body's sum over views of an odd number of hypotheses
    takes the last one's last joint in PyTorch's interleaved order instead
    of its cascade (a column past the last whole group of 32)."""
    scene_cfg = synthetic.SceneConfig(num_cameras=cameras_, num_people=n, num_frames=1,
                                      seed=seed, shuffle_detections=False,
                                      identity_swap_rate=0.3)
    data = synthetic.frames_from_scene(synthetic.generate_scene(scene_cfg), np.float32)
    rig = cameras.hall_rig(cameras_, device="cpu")
    cfg = config.PipelineConfig.demo_16cam().fusion
    kp_n, cov_n, det_ok = fusion.normalize_frame(Frame.from_arrays(data, "cpu")._replace(
        **{k: torch.as_tensor(data[k][0]) for k in ("kp2d", "cov2d", "det_valid")}), rig, cfg)
    mask = det_ok.T.contiguous()  # [n, C]
    kp_n = kp_n.clone()
    pick = torch.Generator().manual_seed(seed)
    for h, views in ((1, 3), (3, 5)):
        seen = torch.nonzero(mask[h])[:, 0]
        few = seen[torch.randperm(len(seen), generator=pick)[:views]]
        mask[h] = False
        mask[h, few] = True
        kp_n[few[0], h, :, :2] += torch.tensor([0.2, -0.12])
    unobserved = torch.tensor([0.0, 0.0, -1.0])
    kp = torch.where(mask[..., None, None], kp_n.transpose(0, 1), unobserved).contiguous()
    cov = torch.where(mask[..., None, None], cov_n.transpose(0, 1), 0.0).contiguous()
    flat = fusion.HypothesisSet(kp=kp, cov=cov, cam_mask=mask, obs_score=mask.float(),
                                n_hyp=torch.tensor(n, dtype=torch.int32),
                                n_dropped=torch.tensor(0, dtype=torch.int32))
    return flat, rig, cfg


def _correctly_rounded_sqrt(monkeypatch):
    """torch.sqrt of float32 CPU tensors rounded correctly, as F1's is (its
    vectorized CPU square root is a last bit off in ~0.7% of values: the
    caveat in csrc/triangulation.cu's header)."""
    sqrt = torch.sqrt

    def exact(x, *args, **kwargs):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32 and x.device.type == "cpu":
            return sqrt(x.double(), *args, **kwargs).float()
        return sqrt(x, *args, **kwargs)

    monkeypatch.setattr(torch, "sqrt", exact)


@pytest.mark.parametrize("cameras_", WIDE_CAMERAS)
def test_host_build_matches_plain_wide(cameras_, monkeypatch):
    """The wide variant's host build (its working set laid out as on the
    card, the sums over 92 to 480 views in PyTorch's CPU order: cascades
    past 256 elements, the UT's base product in 64-view chunks) against
    the plain body in float32, bit for bit, square roots rounded
    correctly on both sides: every output and every joint's dropped view,
    with three-view and leave-one-out drops and valid persons among
    them."""
    _correctly_rounded_sqrt(monkeypatch)
    flat, rig, cfg = wide_hypotheses(cameras_, seed=cameras_)
    drops = assert_equals_plain(flat, rig, cfg, f"{cameras_} cameras")
    k = _views(flat, cfg)
    assert int(((drops >= 0) & (k == 3)).sum()) > 0
    assert int(((drops >= 0) & (k >= 4)).sum()) > 0


def test_wide_layout_keeps_the_arithmetic():
    """The wide variant's layout (device memory for the per-view arrays)
    computes what the shared-memory layout computes, at a width both
    take."""
    flat, rig, cfg = wide_hypotheses(16, seed=5)
    lib = _kernels.host_library()
    outs = []
    for wide in (0, 1):
        out = tk._outputs(flat.kp.shape[0], "cpu")
        drops = torch.empty((flat.kp.shape[0], 17), dtype=torch.int32)
        tensors = [t.contiguous() for t in (flat.kp, flat.cov, flat.cam_mask, rig.P, rig.F)]
        assert lib.ses3d_triangulation_host(
            ctypes.byref(tk.params(cfg, flat.kp.shape[0], 16)), *tk._pointers(*tensors, out),
            drops.data_ptr(), wide) == 0
        outs.append((out, drops))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(outs[0][1], outs[1][1])


def _on_f1_arithmetic(monkeypatch):
    """Route the triangulation to F1 and run F1's host build in its
    place."""
    monkeypatch.setattr(fusion, "triangulation_route", lambda c, d, t: "kernel")
    monkeypatch.setattr(tk, "triangulate", functools.partial(tk.triangulate, host=True))


def _counter(records, scope: str, name: str) -> list:
    c = records.counters
    return [int(v) for v in c["value"][(c["scope"] == scope) & (c["name"] == name)]]


def test_pipeline_on_f1_arithmetic(monkeypatch):
    """Pipeline.step and run_offline with F1's host build in the
    triangulation's place: the plain pipeline's outputs bit for bit (the
    host build equals the plain body); a traced call counts the hypotheses
    F1 triangulates per call (`fusion.triangulation.f1`: 16 a step, 8
    frames x 16 a chunk), the plain route 0."""
    cfg = config.PipelineConfig.demo_16cam()
    data = _scene_frames("adversarial", cfg.fusion.max_dets_per_cam)
    rig = cameras.hall_rig(16, device="cpu")
    frames = Frame.from_arrays(data, "cpu")
    plain = pipeline.Pipeline(rig, cfg, device="cpu", fusion_batch=8, trace=True)
    with plain.tracer:
        _, want = plain.run_offline(plain.init_state(), frames)
        _, want_step = plain.step(plain.init_state(), Frame(*(x[0] for x in frames)))
    rec = plain.tracer.drain()
    assert _counter(rec, "Pipeline.run_offline", "fusion.triangulation.f1") == [0, 0]
    assert _counter(rec, "Pipeline.step", "fusion.triangulation.f1") == [0]

    _on_f1_arithmetic(monkeypatch)
    f1 = pipeline.Pipeline(rig, cfg, device="cpu", fusion_batch=8, trace=True)
    with f1.tracer:
        _, got = f1.run_offline(f1.init_state(), frames)
        _, got_step = f1.step(f1.init_state(), Frame(*(x[0] for x in frames)))
    rec = f1.tracer.drain()
    assert _counter(rec, "Pipeline.run_offline", "fusion.triangulation.f1") == [128, 128]
    assert _counter(rec, "Pipeline.step", "fusion.triangulation.f1") == [16]
    for a, b in ((got, want), (got_step, want_step)):
        for persons_a, persons_b in ((a.persons_raw, b.persons_raw), (a.fused, b.fused)):
            for name in persons_b._fields:
                assert torch.equal(getattr(persons_a, name), getattr(persons_b, name)), name
        for name in b.feedback._fields:
            assert torch.equal(getattr(a.feedback, name), getattr(b.feedback, name)), name
    assert int(want.fused.valid.sum()) > 0


def test_untraced_calls_note_nothing():
    """`tracing.note` outside a traced call records nothing and raises
    nothing."""
    tracing.note("triangulation.f1", 16)
    tr = tracing.Tracer()
    with tr:
        tracing.note("triangulation.f1", 16)
    assert len(tr.drain().counters) == 0


# ------------------------------------------------------------ on a card --

def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: F1 is a CUDA kernel")
    from smartedgesensor3dhumanpose_tpu_torch.ops import linalg

    linalg.require_ieee_fp32()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scene, pose", CASES + (("scaled", "simple"),))
def test_kernel_matches_host_build_and_plain_on_card(scene, pose):
    """F1 on the card against its host build bit for bit, and against the
    plain body on the card in float32 (decisions and drops equal, no
    further from the card's float64 than its float32, twice over)."""
    dev = _card()
    flat, rig, cfg = hypotheses(scene, pose, torch.float32, dev)
    # The association fold (K2) takes float32 on the card: the float64
    # hypotheses come from the CPU's plain fold.
    flat64, rig64, _ = hypotheses(scene, pose, torch.float64)
    flat64 = flat64._replace(**{k: getattr(flat64, k).to(dev) for k in ("kp", "cov", "cam_mask")})
    rig64 = rig64._replace(**{k: getattr(rig64, k).to(dev) for k in rig64._fields})
    n = flat.kp.shape[0]
    drops = torch.full((n, 17), -2, dtype=torch.int32, device=dev)
    got = tk.triangulate(flat.kp, flat.cov, flat.cam_mask, rig.P, rig.F, cfg, drops=drops)
    torch.cuda.synchronize()
    cpu = [t.cpu() for t in (flat.kp, flat.cov, flat.cam_mask, rig.P, rig.F)]
    host_drops = torch.empty((n, 17), dtype=torch.int32)
    host = tk.triangulate(*cpu, cfg, drops=host_drops, host=True)
    for a, b in zip(got, host):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(drops.cpu(), host_drops)
    plain32, drops32 = fusion._triangulate_plain(flat, rig, cfg, with_drops=True)
    plain64 = fusion._triangulate_plain(flat64, rig64, cfg)
    assert_as_plain(got, drops, plain32, drops32, plain64, f"{scene}/{pose} on the card")
    assert fusion.triangulation_route(rig.P.shape[0], dev, torch.float32) == "kernel"
    before = _kernels.LAUNCHES["triangulation"]
    fusion.triangulate_hypotheses(flat, rig, cfg)
    assert _kernels.LAUNCHES["triangulation"] == before + 1
