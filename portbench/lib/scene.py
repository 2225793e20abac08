"""Inputs of a cell, made from its configuration file and the seed: the
pipeline settings for the port and for the plain reference, the camera
rig, and synthetic hall scenes from the frozen generator
(portbench/traffic/synthetic.py).

The rig is built once in float64 by the reference's copy of the hall
layout, cast to float32 for the port; the reference gets those float32
values back in float64, so both sides read the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import cameras as ref_cameras
from portbench.reference import config as ref_config
from portbench.reference.types import CameraRig as RefRig
from portbench.traffic import synthetic

# Reference arithmetic: float64 on the host.
REF_DTYPE = torch.float64


def make_config(module, config_file: dict):
    """A PipelineConfig of `module` (the port's `config` or the reference's
    copy) from the configuration file's `pipeline` group."""
    p = config_file["pipeline"]
    return module.PipelineConfig(
        fusion=module.FusionConfig(**p["fusion"]),
        prior=module.PriorConfig(**p["prior"]),
        tracker=module.TrackerConfig(**p["tracker"]),
        dtype=p["dtype"],
    )


def ref_pipeline_config(config_file: dict):
    return make_config(ref_config, config_file)


def rig_arrays(config_file: dict) -> list:
    """The rig's fields (K, P, F, image_size) as float32 host tensors."""
    rig = ref_cameras.hall_rig(config_file["rig"]["cameras"], dtype=torch.float64, device="cpu")
    return [t.to(torch.float32) for t in rig]


def ref_rig(arrays: list) -> RefRig:
    return RefRig(*(t.to(REF_DTYPE) for t in arrays))


def scene(config_file: dict, mix: dict, frames: int, seed) -> dict:
    """A hall scene of `frames` frames: the configuration's cameras and
    people, the mix's frame rate and stamp jitter (drawn from the mix's
    `arrival_seed`), the generator's defaults otherwise. Returns the
    padded frame fields (numpy, leading time axis) plus `det_count`, the
    generator's detection slots per camera."""
    rig = ref_cameras.hall_rig(config_file["rig"]["cameras"], dtype=torch.float64, device="cpu")
    cfg = synthetic.SceneConfig(
        num_cameras=config_file["rig"]["cameras"],
        num_frames=frames,
        frame_rate=float(mix["rate_hz"]),
        stamp_jitter=float(mix["stamp_jitter_s"]),
        seed=seed,
        **config_file["scene"],
    )
    data = synthetic.frames_from_scene(synthetic.generate_scene(cfg, rig))
    # The arrivals: every seed gets the same set of stamp jitters (drawn
    # from the mix's own seed, a row of cameras per frame), in an order of
    # its own within each block of `arrival_block_frames` frames, so the
    # synchronizer's waits, which the jitter decides, keep their spread
    # from seed to seed.
    jitter = np.random.default_rng(int(mix["arrival_seed"])).normal(
        0.0, cfg.stamp_jitter, size=data["cam_stamp"].shape)
    rows, block = np.arange(frames), int(mix["arrival_block_frames"])
    rng = seed_stream(seed, 3)
    for b in range(0, frames, block):
        rows[b:b + block] = b + rng.permutation(len(rows[b:b + block]))
    data["cam_stamp"] = np.arange(frames)[:, None] / cfg.frame_rate + jitter[rows]
    dets = config_file["pipeline"]["fusion"]["max_dets_per_cam"]
    out = synthetic.pad_detections(data, dets)
    out["det_count"] = data["kp2d"].shape[2]
    return out


def seed_stream(seed: int, *keys: int) -> np.random.Generator:
    """A generator for one purpose of a run (keys name it), from the seed."""
    return np.random.default_rng([int(seed) % 2**63, *keys])
