"""Core data types: NamedTuples of tensors flowing through the pipeline.

Field names, shapes and layouts match `smartedgesensor3dhumanpose_tpu.types`
so a state or frame converts field by field (see `convert.py`). Shape
legend: C = cameras, D = detection slots per camera, J = 17 input joints,
K = 21 fusion joints, P = person/hypothesis slots, T = track slots,
W = moving-average window. Every index and id is int32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import skeleton


class Frame(NamedTuple):
    """One synchronized multi-camera set of 2D detections."""

    kp2d: torch.Tensor       # [C, D, J, 3] pixel keypoints (x, y, score)
    cov2d: torch.Tensor      # [C, D, J, 3] pixel covariance packed (xx, xy, yy)
    det_score: torch.Tensor  # [C, D] per-detection score
    det_valid: torch.Tensor  # [C, D] bool
    cam_stamp: torch.Tensor  # [C] per-camera timestamp (s), float32
    fb_delay: torch.Tensor   # [C] measured feedback delay (s), -1 = unmeasured

    @property
    def num_cameras(self) -> int:
        return self.kp2d.shape[0]

    @classmethod
    def from_arrays(cls, data, device) -> "Frame":
        """Frame on `device` from a dict of host arrays in field layout (as
        `io.synthetic.frames_from_scene` returns them); leading axes pass
        through. `cam_stamp` is cast to float32 with no origin rebase, exactly
        as the JAX package does: the stages only difference stamps, and
        scenes start their clocks near zero (at unix-epoch stamps the float32
        step is 128 s, on both sides)."""

        def t(name, dtype=None):
            arr = np.asarray(data[name])
            return torch.as_tensor(arr, dtype=dtype, device=device)

        return cls(
            kp2d=t("kp2d"),
            cov2d=t("cov2d"),
            det_score=t("det_score"),
            det_valid=t("det_valid", torch.bool),
            cam_stamp=t("cam_stamp", torch.float32),
            fb_delay=t("fb_delay"),
        )


class CameraRig(NamedTuple):
    """Static calibration of the camera array (see cameras.build_rig)."""

    K: torch.Tensor           # [C, 4] intrinsics (fx, fy, cx, cy)
    P: torch.Tensor           # [C, 3, 4] extrinsics base->cam
    F: torch.Tensor           # [C, C, 3, 3] fundamental matrices (i -> j)
    image_size: torch.Tensor  # [C, 2] (width, height) in pixels

    @property
    def num_cameras(self) -> int:
        return self.P.shape[0]


class Persons3D(NamedTuple):
    """3D skeletons with per-joint Gaussian uncertainty."""

    xyz: torch.Tensor        # [P, K, 3] joint positions (base frame, meters)
    score: torch.Tensor      # [P, K] per-joint scores; <= 0 means invalid
    cov: torch.Tensor        # [P, K, 3, 3] per-joint covariance
    valid: torch.Tensor      # [P] bool
    person_id: torch.Tensor  # [P] int32 track id (-1 before tracking)

    @staticmethod
    def empty(num_persons: int, dtype=torch.float32, device="cuda") -> "Persons3D":
        """No persons: every slot invalid, ids -1 (on the card unless the
        caller asks for the CPU)."""
        k = skeleton.NUM_FUSION_JOINTS
        return Persons3D(
            xyz=torch.zeros((num_persons, k, 3), dtype=dtype, device=device),
            score=torch.zeros((num_persons, k), dtype=dtype, device=device),
            cov=torch.zeros((num_persons, k, 3, 3), dtype=dtype, device=device),
            valid=torch.zeros((num_persons,), dtype=torch.bool, device=device),
            person_id=torch.full((num_persons,), -1, dtype=torch.int32, device=device),
        )


class Reprojection2D(NamedTuple):
    """Per-camera 2D reprojections of predicted skeletons (feedback)."""

    kp2d: torch.Tensor        # [C, P, J, 3] pixel keypoints (x, y, score)
    cov2d: torch.Tensor       # [C, P, J, 3] packed pixel covariance
    kp_valid: torch.Tensor    # [C, P, J] bool: projected inside the image
    bbox: torch.Tensor        # [C, P, 4] (x0, y0, x1, y1)
    valid: torch.Tensor       # [C, P] bool: >= 1 joint lands in this camera
    fb_delay: torch.Tensor    # [C] predicted latency carried back
    orig_stamp: torch.Tensor  # [C] each camera's original frame stamp


def person_bbox3d(xyz: torch.Tensor, score: torch.Tensor, valid: torch.Tensor):
    """Axis-aligned 3D bounding box per person over its valid joints;
    xyz [..., P, K, 3], leading axes (frames) pass through.

    Returns (center [..., P, 3], size [..., P, 3]); zeros for empty persons.
    """
    ok = ((score > 0) & valid[..., None])[..., None]  # [..., P, K, 1]
    lo = torch.where(ok, xyz, 1e9).amin(dim=-2)
    hi = torch.where(ok, xyz, -1e9).amax(dim=-2)
    any_ok = ok.any(dim=-2)  # [..., P, 1]
    center = torch.where(any_ok, 0.5 * (lo + hi), 0.0)
    size = torch.where(any_ok, hi - lo, 0.0)
    return center, size


class TrackerState(NamedTuple):
    """Carried state of the track manager + smoother (reference
    TrackingHypothesis fields, pose_prior_mult_node.cpp:68-82)."""

    alive: torch.Tensor        # [T] bool
    track_id: torch.Tensor     # [T] int32 stable published id
    estimate: torch.Tensor     # [T, K, 3] previous optimized joints (normalized)
    est_exists: torch.Tensor   # [T, K] bool
    vel_buffer: torch.Tensor   # [T, K, W, 3] velocity ring buffers (m/s)
    t_prev: torch.Tensor       # [T] last observation time (s)
    num_obs: torch.Tensor      # [T] int32 observation count
    height_prev: torch.Tensor  # [T] last height scale (-1 = uninitialized)
    root_prev: torch.Tensor    # [T, 3] last root position (base frame)
    next_id: torch.Tensor      # [] int32 next fresh track id
    frame_nr: torch.Tensor     # [] int32 frame counter
    fb_delay_buffer: torch.Tensor  # [W] feedback-delay moving-average buffer
    t_prev_global: torch.Tensor    # [] previous frame time (s)

    @staticmethod
    def initial(max_tracks: int, n_mov_avg: int = 3, avg_delay: float = 0.10,
                dtype=torch.float32, device="cuda") -> "TrackerState":
        k = skeleton.NUM_FUSION_JOINTS
        t = max_tracks
        f = dict(dtype=dtype, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return TrackerState(
            alive=torch.zeros((t,), dtype=torch.bool, device=device),
            track_id=torch.full((t,), -1, **i32),
            estimate=torch.zeros((t, k, 3), **f),
            est_exists=torch.zeros((t, k), dtype=torch.bool, device=device),
            vel_buffer=torch.zeros((t, k, n_mov_avg, 3), **f),
            t_prev=torch.full((t,), -np.inf, **f),
            num_obs=torch.zeros((t,), **i32),
            height_prev=torch.full((t,), -1.0, **f),
            root_prev=torch.zeros((t, 3), **f),
            next_id=torch.zeros((), **i32),
            frame_nr=torch.zeros((), **i32),
            fb_delay_buffer=torch.full((n_mov_avg,), avg_delay, **f),
            t_prev_global=torch.zeros((), **f),
        )
