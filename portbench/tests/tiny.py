"""A tiny cell for the CPU tests: the demo hall cut to 4 cameras and 2
persons at 10 Hz, run on the host through the port's plain path."""

from __future__ import annotations

import copy
import time

import torch

from portbench.lib import harness, manifest

CAMERAS, PEOPLE = 4, 2


def cell(driver: str) -> manifest.Cell:
    """The tiny cell of a driver ("live" or "offline"), with the real
    cells' metrics and limits."""
    m = manifest.load_manifest()
    name = {"live": "demo16_live_30hz", "offline": "demo16_offline_replay"}[driver]
    real = manifest.load_cell(name, m)
    config = copy.deepcopy(real.config)
    config["pipeline"]["fusion"]["num_cameras"] = CAMERAS
    config["rig"]["cameras"] = CAMERAS
    config["scene"]["num_people"] = PEOPLE
    config["fusion_batch"] = 4
    mix = dict(real.mix, rate_hz=10.0, arrival_block_frames=5)
    if driver == "live":
        mix.update(warmup_frames=14)
        check, trace = dict(start_steps=3, sample_steps=2, gate_px=1.0), dict(frames=4)
    else:
        mix.update(sequence_frames=12, pool=2)
        check, trace = dict(sample_frames=3, gate_px=1.0), dict(calls=1)
    return real._replace(config=config, mix=mix, check=check, trace=trace)


def run(driver: str, seed: int = 7, seconds: float = 1.0, fault=None):
    """(result, checks) of one tiny run on the CPU."""
    torch.set_num_threads(1)
    r = harness.Run(cell(driver), seed, seconds, False, time.perf_counter(),
                    torch.device("cpu"), fault)
    return harness.execute(r)

