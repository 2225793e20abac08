"""A synchronized set of per-camera messages packed as a Frame, plain
NumPy: the packing of the port's `io/replay.py::SynchronizedReplay._pack`
(detections in message order into fixed slots, a slot valid where its
score is positive, stamps from the set's nanoseconds), then the casts of
`Frame.from_arrays` and the live loop's frame builder (keypoints,
covariances, scores and delays in float32, stamps in float32), widened to
`dtype` for the reference's arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.types import Frame


def pack_set(payloads, stamps_ns, max_dets: int, num_joints: int = 17) -> dict:
    """payloads: one (fb_delay, kp2d [n, J, 3], cov2d [n, J, 3], score [n])
    per camera, in camera order; stamps_ns: the set's stamps."""
    c = len(payloads)
    kp2d = np.zeros((c, max_dets, num_joints, 3), np.float32)
    cov2d = np.zeros((c, max_dets, num_joints, 3), np.float32)
    det_score = np.zeros((c, max_dets), np.float32)
    det_valid = np.zeros((c, max_dets), bool)
    fb_delay = np.full((c,), -1.0, np.float32)
    for ci, (fb, kp, cov, score) in enumerate(payloads):
        fb_delay[ci] = fb
        n = min(max_dets, kp.shape[0])
        kp2d[ci, :n] = kp[:n]
        cov2d[ci, :n] = cov[:n]
        det_score[ci, :n] = score[:n]
        det_valid[ci, :n] = score[:n] > 0
    return {
        "kp2d": kp2d, "cov2d": cov2d, "det_score": det_score, "det_valid": det_valid,
        "cam_stamp": np.asarray(stamps_ns, np.float64) * 1e-9, "fb_delay": fb_delay,
    }


def frame(data: dict, dtype=torch.float64, device="cpu") -> Frame:
    """A Frame of host arrays in field layout (leading axes pass through):
    every float field rounded to float32 as the port receives it, then
    held in `dtype`."""

    def f32(name):
        return torch.as_tensor(np.asarray(data[name], np.float32)).to(device=device, dtype=dtype)

    return Frame(
        kp2d=f32("kp2d"),
        cov2d=f32("cov2d"),
        det_score=f32("det_score"),
        det_valid=torch.as_tensor(np.asarray(data["det_valid"], bool), device=device),
        cam_stamp=f32("cam_stamp"),
        fb_delay=f32("fb_delay"),
    )
