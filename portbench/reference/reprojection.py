"""Semantic feedback: reproject predicted 3D skeletons into every camera
(reference skeleton_reproj_mult_node.cpp:139-235): a 7-point UT per joint
into every camera, the in-image gate, per-person bounding boxes and the
stamp echo. Leading axes (frames) of the persons, the latency and the
stamps pass through."""

from __future__ import annotations

import torch

from portbench.reference import skeleton
from portbench.reference.ops import covariance, linalg
from portbench.reference.types import CameraRig, Persons3D, Reprojection2D


def reproject(persons: Persons3D, rig: CameraRig, pose_method: str,
              pred_delta_t, ut_kappa: float = 0.5, ts_per_cam=None) -> Reprojection2D:
    """Project predicted skeletons (with covariance) into all cameras.

    persons: [..., P, K, ...]; pred_delta_t: [...] predicted feedback
    latency carried back per camera; ts_per_cam: [..., C] original
    per-camera stamps echoed on each camera's feedback (zeros when not
    given). Returns [..., C, P, J] layouts.
    """
    model = skeleton.input_model(pose_method)
    dtype = persons.xyz.dtype
    dev = persons.xyz.device
    to_fusion = linalg.constant(model.to_fusion, dev, torch.int64)
    c = rig.P.shape[0]

    xyz = persons.xyz[..., to_fusion, :]      # [..., P, J, 3]
    cov3 = persons.cov[..., to_fusion, :, :]  # [..., P, J, 3, 3]
    score = persons.score[..., to_fusion]     # [..., P, J]
    joint_ok = (score > 0) & persons.valid[..., None]  # (:181)

    mean_px, cov_px = covariance.project_with_covariance(
        xyz, cov3, rig.P.to(dtype), rig.K.to(dtype), kappa=ut_kappa
    )  # [..., P, J, C, 2], [..., P, J, C, 3]

    size = rig.image_size.to(dtype)
    in_img = (
        (mean_px[..., 0] >= 0)
        & (mean_px[..., 0] <= size[:, 0])
        & (mean_px[..., 1] >= 0)
        & (mean_px[..., 1] <= size[:, 1])
    )  # (:207)
    kp_valid = (joint_ok[..., None] & in_img).movedim(-1, -3)  # [..., C, P, J]
    px_c = mean_px.movedim(-2, -4)
    cov_c = cov_px.movedim(-2, -4)

    kp2d = torch.cat(
        [
            torch.where(kp_valid[..., None], px_c, 0.0),
            torch.where(kp_valid, score[..., None, :, :].expand(kp_valid.shape), 0.0)[..., None],
        ],
        dim=-1,
    )
    cov2d = torch.where(kp_valid[..., None], cov_c, 0.0)

    x0 = torch.where(kp_valid, px_c[..., 0], 1e9).amin(dim=-1)
    y0 = torch.where(kp_valid, px_c[..., 1], 1e9).amin(dim=-1)
    x1 = torch.where(kp_valid, px_c[..., 0], -1e9).amax(dim=-1)
    y1 = torch.where(kp_valid, px_c[..., 1], -1e9).amax(dim=-1)
    person_valid = kp_valid.any(dim=-1)  # [..., C, P] (:226)
    bbox = torch.where(
        person_valid[..., None], torch.stack([x0, y0, x1, y1], dim=-1), 0.0
    )
    fb = torch.as_tensor(pred_delta_t, dtype=dtype, device=dev)
    return Reprojection2D(
        kp2d=kp2d,
        cov2d=cov2d,
        kp_valid=kp_valid,
        bbox=bbox,
        valid=person_valid,
        fb_delay=torch.ones(fb.shape + (c,), dtype=dtype, device=dev) * fb[..., None],
        orig_stamp=(
            torch.zeros(fb.shape + (c,), dtype=dtype, device=dev)
            if ts_per_cam is None
            else torch.as_tensor(ts_per_cam, device=dev).to(dtype)
        ),
    )
