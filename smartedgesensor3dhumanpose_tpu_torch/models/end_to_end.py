"""Fully-fused end-to-end variant: camera images -> 3D skeletons on one card.

The reference splits the system across hardware: 2D CNNs on edge sensors,
fusion on a desktop, connected by a network with ~100 ms feedback latency
(README.md:7-11, g_avg_delay skeleton_3d_triang_mult_node.cpp:63). When all
camera streams reach one card, the detector (models.keypoint_cnn), multi-view
fusion, LM smoothing/tracking and reprojection feedback run there back to
back for each frame: the detector's decoded keypoints feed `pipeline.step`,
which launches the association fold (K2) and the tracker's JV (K1). On
CUDA `make_end_to_end` returns the step captured as one CUDA graph
(graphs.py), the detector, the decoder and `pipeline.step` inside it, as
the JAX package jits it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from smartedgesensor3dhumanpose_tpu_torch import graphs
from smartedgesensor3dhumanpose_tpu_torch import pipeline as pl
from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig
from smartedgesensor3dhumanpose_tpu_torch.models import keypoint_cnn
from smartedgesensor3dhumanpose_tpu_torch.types import CameraRig, Frame, TrackerState


def detection_frame(
    images: torch.Tensor,
    cam_stamp: torch.Tensor,
    model: keypoint_cnn.KeypointCNN,
    det_cfg: keypoint_cnn.DetectorConfig,
) -> Frame:
    """[C, H, W, 3] images -> the Frame of the detector's decoded keypoints."""
    kp2d, cov2d, det_score, det_valid = keypoint_cnn.detect(model, images, det_cfg)
    return Frame(
        kp2d=kp2d,
        cov2d=cov2d,
        det_score=det_score,
        det_valid=det_valid,
        cam_stamp=cam_stamp,
        # On-card detection has no sensor feedback loop to measure; the
        # prediction horizon falls back to the configured average delay.
        fb_delay=torch.full((images.shape[0],), -1.0, dtype=kp2d.dtype, device=kp2d.device),
    )


def end_to_end_step(
    state: TrackerState,
    images: torch.Tensor,
    cam_stamp: torch.Tensor,
    model: keypoint_cnn.KeypointCNN,
    det_cfg: keypoint_cnn.DetectorConfig,
    rig: CameraRig,
    config: PipelineConfig,
) -> Tuple[TrackerState, pl.StepOutput]:
    """One fused frame: [C, H, W, 3] images -> detector -> fusion -> tracker
    -> feedback; `model` holds the detector's weights. Like `pipeline.step`,
    it returns a new state and leaves `state` untouched."""
    return pl.step(state, detection_frame(images, cam_stamp, model, det_cfg), rig, config)


def make_end_to_end(
    rig: CameraRig,
    config: PipelineConfig,
    det_cfg: keypoint_cnn.DetectorConfig,
    generator: torch.Generator | None = None,
    device="cuda",
):
    """Build (step, model, initial_state) on `device`, where the rig must
    already live; step(state, images, cam_stamp) closes over the model,
    det_cfg, rig and config. The detector's weights come from `generator`
    (see keypoint_cnn.init_detector); load trained ones into `model` in
    place (`load_state_dict`): on CUDA the step is a captured graph that
    reads the parameters by address."""
    if det_cfg.max_detections != config.fusion.max_dets_per_cam:
        raise ValueError(
            f"det_cfg.max_detections ({det_cfg.max_detections}) must equal "
            f"config.fusion.max_dets_per_cam ({config.fusion.max_dets_per_cam}): "
            "the decoder fills exactly the fusion's detection slots"
        )
    # The device and rig checks and the IEEE-fp32 pin of the online pipeline.
    pipe = pl.Pipeline(rig, config, device=device)
    model = keypoint_cnn.init_detector(det_cfg, generator, pipe.device)
    step = functools.partial(
        end_to_end_step, model=model, det_cfg=det_cfg, rig=rig, config=config
    )
    if pipe.device.type == "cuda":
        step = graphs.CapturedFunction(step, "end_to_end_step")
    return step, model, pipe.init_state()
