"""Time the sharded paths' host threading: how the jobs of a split stage
are spread over host threads.

`parallel.sharding._run` runs the jobs (one per mesh entry) of a split
stage in turn in the caller's thread, each on a CUDA stream of its own.
This script times it beside two ways of spreading the same jobs over host
threads:

  thread_per_card   one thread per distinct device, its jobs in turn
  thread_per_entry  one thread per job

on virtual meshes of `cuda:0` and, where there are several cards, on
meshes over them, in turns with `Pipeline.run_offline` and
`fusion.fuse_frame` as the unsharded times: the benign golden scene
(`demo_16cam`, 64 frames, fusion_batch 32) and the first frame of the
scaled 64 x 25 scene over 4 entries (and over every card).

Usage:  python3 sharding_ab.py [--calls N]
Prints one line per (variant, mesh) with the median and least wall ms of
N warm calls (host clock around a sync of every card), then the first card's
`nvidia-smi` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs


def grouped_run(sharding, group):
    """`_run` with the jobs spread over host threads by `group(device,
    job index)`: one thread per distinct key, its jobs in turn."""
    def run(fn, jobs, home):
        staged, per_key = [], {}
        for i, (dev, args) in enumerate(jobs):
            args = sharding._to(args, dev)
            k = sum(1 for d, _, _, _ in staged if d == dev)
            staged.append((dev, k, args, torch.cuda.current_stream(dev).record_event()))
            per_key.setdefault(group(dev, i), []).append(i)

        def one(i):
            dev, k, args, ready = staged[i]
            with torch.cuda.device(dev):
                stream = sharding._stream(dev, k)
                stream.wait_event(ready)
                sharding._mark(args, stream)
                with torch.cuda.stream(stream):
                    out = fn(dev, *args)
                return out, stream.record_event()

        results = [None] * len(staged)
        with ThreadPoolExecutor(max_workers=len(per_key)) as pool:
            for indices, outs in pool.map(
                    lambda ix: (ix, [one(i) for i in ix]), per_key.values()):
                for i, out in zip(indices, outs):
                    results[i] = out
        gathered = []
        for (dev, _, _, _), (out, done) in zip(staged, results):
            torch.cuda.current_stream(home).wait_event(done)
            local = torch.cuda.current_stream(dev)
            local.wait_event(done)
            sharding._mark(out, local)
            gathered.append(sharding._to(out, home))
        return gathered
    return run


def wall_ms(fn) -> float:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sharding_ab: no CUDA device visible; nothing was run", file=sys.stderr)
        return 2
    from smartedgesensor3dhumanpose_tpu_torch import cameras, fusion, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig
    from smartedgesensor3dhumanpose_tpu_torch.ops import linalg
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding

    linalg.require_ieee_fp32()
    dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    golden = np.load(cs.GOLDEN)
    cfg = PipelineConfig.demo_16cam()
    rig = cameras.hall_rig(16, device=dev)
    data = cs.scene_data(json.loads(str(golden["benign/scene"])), cfg.fusion.max_dets_per_cam)
    frames = cs.stacked_frames(data, dev)
    pipe = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=cs.OFFLINE_FUSION_BATCH)
    s_cfg, s_rig, s_frame = cs.scaled_frame(cs.scaled_setup(dev), dev)
    meshes = {f"virtual{d}x{m}": sharding.make_mesh(d * m, model=m, devices=[dev] * (d * m))
              for d, m in cs.VIRTUAL_MESHES}
    fusion_meshes = {f"virtual1x{cs.FUSION_ENTRIES}": sharding.make_mesh(
        cs.FUSION_ENTRIES, data=1, model=cs.FUSION_ENTRIES, devices=[dev] * cs.FUSION_ENTRIES)}
    if n_cards >= 2:
        meshes[f"cards{n_cards}x1"] = sharding.make_mesh()
        fusion_meshes[f"cards1x{n_cards}"] = sharding.make_mesh(data=1, model=n_cards)
    committed = sharding._run
    variants = {
        "committed": committed,
        "thread_per_card": grouped_run(sharding, lambda d, i: d),
        "thread_per_entry": grouped_run(sharding, lambda d, i: i),
    }

    def sharded(variant, fn):
        def call():
            sharding._run = variants[variant]
            try:
                return fn()
            finally:
                sharding._run = committed
        return call

    calls = {"run_offline": lambda: pipe.run_offline(pipe.init_state(), frames),
             "fuse_frame": lambda: fusion.fuse_frame(s_frame, s_rig, s_cfg.fusion)}
    for variant in variants:
        for label, mesh in meshes.items():
            calls[f"{variant}/replay_{label}"] = sharded(variant, lambda m=mesh: (
                sharding.run_offline_sharded(rig, cfg, m, frames, pipe.init_state(),
                                             fusion_batch=cs.OFFLINE_FUSION_BATCH)))
        for label, mesh in fusion_meshes.items():
            calls[f"{variant}/fusion_{label}"] = sharded(variant, lambda m=mesh: (
                sharding.fuse_frame_sharded(s_frame, s_rig, s_cfg, m)))
    for fn in calls.values():
        fn()
    times = {label: [] for label in calls}
    for _ in range(args.calls):
        for label, fn in calls.items():
            times[label].append(wall_ms(fn))
    for label, t in times.items():
        print(f"{label} median_ms={statistics.median(t)} min_ms={min(t)}")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
