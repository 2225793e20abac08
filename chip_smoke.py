"""Drive the PyTorch port's online and offline pipelines, its demo CLI and its sharded paths on NVIDIA GPUs and check them.

Phases (each prints one line; any failure exits non-zero):
  0 environment: card name and power limit, torch/CUDA versions, TF32 flags,
    the route of the captured loops (the merge a WHILE node,
    csrc/graph_loop.cu; the tree LM one launch of L1) and whether this torch
    has CUDA-graph IF nodes of its own
  1 build: compile kernels K1 (jv_assign.cu), K2 (association_fold.cu), K3
    (tracker_scan.cu), L1 and L2 (lm_prior.cu: the whole LM in one launch
    and the tree marginals), and the captured loops' kernels
    (graph_loop.cu), one nvcc per source, all started together; the
    wrappers' shared-memory plans against the kernels' own byte counts; K1,
    L1 and L2 without local memory (-Xptxas -v), L1's and L2's registers
  2 K1 against its plain PyTorch version and scipy, on the card, at every
    register slot count (n up to 120, with and without row_active) and
    batched up to 64 x 40 x 40 and 8 x 120 x 120
  3 K2 against its plain PyTorch version, on the card, also at h_cap = 120
    (the JV's limit) on scaled-layout frames
  4 the online slice: Pipeline.step (a CUDA graph, captured by its first
    call) over the two golden demo scenes (16 cameras x 6 people, 64 frames
    each) against the JAX reference's outputs stored in
    tests/data/torch_golden_demo16.npz, with the wrappers' launch counts
    (the first call's warm-up and capture)
  5 online times: Pipeline.step, K1/K2 against their plain versions, and
    K1's device time at the tracker's shape (torch.profiler); the kernels
    of 4 step replays counted on the device (torch.profiler), and the
    step timed again after that profiler session
  6 the offline slice: Pipeline.run_offline (fusion_batch=32; a CUDA graph,
    captured by its first call) over the same scenes, with the launch
    counts (K1 = 0, K2 = F1 = 2, K3 = 1 per scene's replay, on the device); its
    fusion and its tracker stage (K3 + reprojection on the reference's own
    tracker inputs) against tests/data/torch_golden_offline16.npz, and the
    whole run against the plain path on the card
  7 K3 against its plain version on the card: the four tracker scenarios of
    the JAX package's test_tracker_pallas.py, both demo scenes' tracker
    inputs, a sequence at the domain's edge P = T = 120 (one staged frame,
    velocity rings in device memory) and one with an odd slot count (a
    dropped spawn and a track merge must occur)
  8 the scaled layout: run_offline with PipelineConfig.scaled_64cam() (64
    cameras x 25 people, 32 frames, fusion_batch=4), K3 and the batched K2
    against their plain versions on its inputs
  9 offline times: run_offline frames/s, its stage split and host syncs,
    and K3 against its plain version
 10 the demo CLI (demo.main) at the JAX demo's configuration, 16 cameras x
    6 people (D 6, H 12, T 12), in every mode with its launch counts: the
    offline replay with --eval --vis-cov --save --checkpoint --record-jsonl
    (128 frames); K2 and K3 against their plain versions at this shape;
    --jsonl (the replayed frames against the scene's, run_offline's
    decisions on both equal); the native synchronizer against its Python
    mirror on the recorded messages; --online at 30 Hz over 64 frames
    (accounting, and the loop's state against stepping its frames again);
    --online --jsonl (accounting); --closed-loop over 64 frames (and the
    horizon's exact convergence on jitter-free stamps); a checkpoint resume;
    profile_stages (each stage a captured graph) against a direct timing of
    run_offline
 11 the end-to-end slice (images -> keypoint CNN -> decode -> Pipeline.step):
    the full-width detector (DetectorConfig(): 480x640, width 128, stride 8,
    bfloat16) on the demo's 16 cameras, 30 steps from seeded random
    weights (finite outputs, K1 and K2 once per step), its heatmaps in
    float32 and bfloat16 compute against the CPU port's and a float64
    evaluation on the same weights and images, its decoding against the
    CPU's on identical heatmaps (integers exact), the detector's, decoder's
    and step's times against Pipeline.step on the same detections;
    then training (models/train.py: the functional loss-gradient-Adam step
    replayed as a CUDA graph, JAX's jitted step_fn): the JAX package's
    test detector on its test scene (300 steps) and the full-width
    detector on the demo's frames (20 steps, 4 cameras), each trained
    eagerly twice and captured once over the same draws (captured equal
    to eager bit for bit where the eager runs agree, else within their
    spread), ms per step of each, peak MiB, 0 host syncs per captured
    step, its graph's nodes; the trained test detector through the
    end-to-end step: every person recovered within 5 cm mean, 8 cm max
 12 the sharded paths (parallel/sharding.py), each shard's stages replayed
    as CUDA graphs (one per stage, device and mesh entry): run_offline_sharded
    (fusion_batch=32) over both golden scenes on make_mesh() (every visible
    card) and on virtual meshes of cuda:0 (data 2 x model 2, 4 x 1), every
    graph captured anew by the mesh's first call (its seconds, memory and
    host launch counts); per warm call 0 host syncs and 0 host launches,
    and on the device K1 = 0, K2 = one per chunk of each data shard,
    K3 = 1; bit for bit the eager sharded replay on the same mesh, each
    shard's LM running the eager loop's trips on the device (its trip
    log); fusion decisions against run_offline and the golden, its
    tracker stage on the golden's inputs against the golden's, the whole
    run against run_offline and the golden (gated on the benign scene);
    the 4 x 1 mesh's entries replaying at once against one at a time;
    fuse_frame_sharded on phase 8's 64-camera frame over 4 entries of
    cuda:0 against fusion.fuse_frame and the eager sharded fusion (one K2
    per replay on the device); sharding.dryrun on 4 entries; with several
    cards the same across them, K1-K3 on cuda:1 tensors while cuda:0 is
    current, and a Pipeline captured on cuda:1 running there alone; wall
    times, in turns, of each mesh captured and eager against the captured
    run_offline, and of the sharded fusion captured and eager against
    fuse_frame captured and eager
 13 the compiled entry points (graphs.py): the captured Pipeline.step over
    both golden scenes against the golden and the eager pipeline.step on
    the card (decisions exact, joints within 1 mm outside each track's
    first published frame), 0 host syncs and 0 host launches per replay,
    K1 = K2 = 1 per replay on the device (torch.profiler), the device's
    idle share and the copies' cost; the stacked run_per_frame_chain
    against per-frame steps; the captured run_offline against the eager
    one (decisions exact, joints within 1e-6 m), and a dropped graph's
    memory released; the captured end-to-end step against the eager
    end_to_end_step (full width, and the trained detector of phase 11);
    eager and captured times, the chain's ms per step, first-call seconds
    and memory, each graph's top-level nodes and the device's idle share
    (back to back against waited for); the loops of every captured path
    (the LM one launch of L1, the merge a WHILE node): the trips each ran
    on the device, from the loops' own log (the tracer's trip log), against the
    eager loops' trips (the LM's iters) and against lm_max_iterations; the
    LM's graph (no WHILE node, no host sync eagerly), its device clock and
    ms per trip run and skipped, against the per-trip route (L1 one trip
    a launch in a WHILE node) and the LM with the plain trip
    (`prior._lm_trip`, 561 kernels)
 14 every configuration the JAX package runs that no earlier phase reaches,
    routed by shape (pipeline.routes): K1's wide routine (n > 120, one block
    per problem) against its plain version bit for bit at n = 121 to 1024
    (with row_active, batched, and the camera scan's discarded 128 x 8
    solve) and against scipy's totals, its device time at n = 128, 256 and
    1024 against its bound; the captured step with the camera scan
    ("cond_while": one K1 per camera) over both golden scenes (every
    decision exact, joints within 1 mm) and with the dense LM solver
    (benign exact; the adversarial scene against the port's CPU dense run),
    each against the eager step bit for bit, with its kernels per replay
    on the device and its p50 beside the default step's; run_offline with
    "pallas" (K1 per camera of each chunk on the device) equal to K2's run;
    max_tracks=128, max_hypotheses=128 (online) and max_tracks=12 (offline,
    K1 per frame) over 16 adversarial frames against the port's CPU float32
    run of the same frames (computed in worker processes while phases 2-13
    run), with their kernels counted on the device
 15 L1 (the whole LM for every person in one launch, in place on the
    carry) and L2 (the tree marginals) against their plain twins
    (ops/lm_prior.py) bit for bit: the one-launch LM from a cold start
    against `lm_solve_plain` and against L1 capped at one trip a launch
    (the per-trip loop), that loop against `lm_trip_plain` after every trip (x,
    err, lam, done, iters and the loop's test), and the marginals at its
    end: the online step's persons (P = 16) on frames 8, 24, 40, 56 of both
    scenes, every offline chunk of both scenes (P = 512) and the scaled
    layout's first chunks (P = 160); the LM with the plain trip beside
    each; the LM's, one trip's and L2's device time at P = 16 and 512
    (torch.profiler), the twins' and the bounds
 16 F1 (the fusion's triangulation in one launch) on the card against its
    host build (the same source compiled for the CPU) bit for bit, and
    against the plain body (fusion._triangulate_plain) on the card in
    float32: validity, joint score > 0 and each joint's dropped view
    equal, xyz, score and covariance over a scene's calls no further from
    the plain body in float64 (on the same hypotheses) than the float32
    plain body is, twice over in the root mean square and four times at
    the worst entry (a covariance entry is a sum of sigma-point scatters
    that cancel, whose rounding the order of the sum decides); how many
    calls the host build equals the plain body on this machine's CPU bit
    for bit (reported: PyTorch's CPU order there is F1's); at the step's
    shape (16 slots, every frame of both scenes) and the offline chunk's
    (32 frames x 16 slots = 512, both chunks of both scenes); F1's device
    time (torch.profiler), the plain body's and the bound from the
    hypotheses' present views at both shapes

 17 the wide rig: the CMU Panoptic Studio's 480 VGA cameras
    (portbench/configs/panoptic480.json, its rig, pipeline settings and
    fusion_batch, one chunk of its 25 Hz mix): kernel E1 (the chunk's
    table of pair costs in one launch) against its plain twin
    (`fusion.pair_costs_plain`) bit for bit; F1's wide
    variant on the chunk's hypotheses against its host build bit for bit,
    and on two frames' against the plain body on the card (phase 16's
    checks); kernels S1 and S2 with K1 between them
    (association.associate_scan_kernels) against the plain camera scan
    (`_scan_camera` per camera) on the card, on the chunk's fold inputs:
    det_slot, n_hyp and n_dropped equal; a warm eager run_offline of the
    chunk with no host sync; the captured run_offline: its capture's
    seconds, the peak device memory of the capture and of a replay, a
    replay's host syncs (none), its graph's kernel nodes, its kernels on
    the device (E1 once, the wide F1 once, K1, S1 and S2 480 times each,
    L1 once, K3 once, F1 not at all) and the traced counters (480 scan
    steps, the chunk's frames on E1, the chunk's hypotheses on the wide
    variant, the triangulation stage's few kernels: no plain body); E1's
    (on the chunk, with its bound),
    S1's, S2's and the wide F1's device times (torch.profiler), their
    plain twins' (the plain triangulation on two frames' slots: on the
    chunk's it takes more than the card's memory) and bounds, F1's
    registers (-Xptxas -v). E1, S1, S2 and
    the wide F1 are also counted on the device in a replay of phase 4's
    step and of phase 6's run_offline (E1 once per step and per chunk,
    the others not at all; E1's table against its twin bit for bit on
    the step's frame and the first chunk), and have entries in the
    kernels line

The second-to-last lines are a JSON object with one entry per kernel and the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {...}}.

Usage:  python3 chip_smoke.py [--profile DIR]
  --profile DIR  also write torch.profiler tables of 10 warm steps and of
                 run_offline to DIR, with the device idle shares
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(_ROOT, "tests", "data", "torch_golden_demo16.npz")
GOLDEN_OFFLINE = os.path.join(_ROOT, "tests", "data", "torch_golden_offline16.npz")
SCENES = ("benign", "adversarial")
OFFLINE_FUSION_BATCH = 32
# The scaled layout (bench.py's scaled cell): 64 cameras x 25 people.
SCALED_SCENE = dict(num_cameras=64, num_people=25, num_frames=32, seed=1)
SCALED_FUSION_BATCH = 4
# K3 at the edge of its domain: persons = track slots = the JV's limit.
EDGE_SLOTS = 120
EDGE_FRAMES = 10
# K3 with an odd slot count and everything on chip: (persons, track slots).
ODD_SHAPE = (7, 9)
# Scaled-layout frames K2 is held to its plain version on at h_cap = EDGE_SLOTS.
EDGE_FOLD_FRAMES = 2
# Batch sizes K1 is launched at here and in kernel_ab.py (phase 1 checks
# every plan of K1's domain at each), and phase 2's batched launches.
K1_PLAN_BATCHES = (1, 7, 8, 64)
K1_BATCHED = ((1, 16, 24), (7, 16, 24), (64, 16, 24), (64, 40, 40), (8, 120, 120))
# Fused and predicted joints must agree with the JAX float32 reference within
# this, outside each track's first published frame (the prediction there
# rides on unpublished warm-up velocities; ROADMAP C5, hazards closed).
JOINT_TOL_M = 1.0e-3
# The prediction horizon is a mean of three float32 delays on both sides.
DELTA_T_TOL_S = 1.0e-6
# Totals of the JV solution against scipy's float64 optimum: the solver
# works in float32, so totals agree to float32 rounding of the sums.
TOTAL_RTOL = 1.0e-5
# K3 against its plain version (both float32 on the card, the same inputs):
# the tolerances of the JAX package's test_tracker_pallas.py, which holds
# the TPU kernel to the XLA scan. The velocity ring and the prediction are
# means of differences over dt ~ 1/30 s, so float32 rounding in another
# summation order shows there first. Integers must be equal.
K3_FLOAT_TOL = {
    "pred_delta_t": 1e-6, "fused.xyz": 1e-6, "fused_pred.xyz": 1e-4,
    "fused_pred.cov": 1e-6, "estimate": 1e-6, "vel_buffer": 1e-3, "t_prev": 0.0,
    "height_prev": 1e-6, "root_prev": 1e-5, "fb_delay_buffer": 1e-7,
    "t_prev_global": 0.0,
}
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s
# and float32 outside the tensor cores. A kernel's bound is the larger of
# its bytes (each input read once, each output written once) over the first
# and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def smi_clocks() -> str:
    """The card's SM clock (MHz) and power draw (W) now, as nvidia-smi
    reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].replace(" ", "")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync_time(fn, reps: int) -> float:
    """Mean device time of `fn` in ms over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_durations(fn, kernel: str, reps: int) -> list:
    """Durations in µs of every launch of `kernel` in a torch.profiler
    trace of `reps` calls of `fn`, in launch order."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if kernel in e.name and e.device_type == DeviceType.CUDA]
    evs.sort(key=lambda e: e.time_range.start)
    return [e.time_range.elapsed_us() for e in evs]


def check_plans() -> int:
    """The wrappers' shared-memory plans (ops/hungarian.py::jv_plan,
    ops/tracker.py::scan_plan, ops/association.py::fold_plan) against the
    byte counts of the kernels' own sources, across K1's domain (R, C <= 120
    at the batch sizes this script launches; past it n x n, n x 8 and 16 x n
    for every n up to 1024 and wider shapes up to MAX_N_WIDE), K3's domain
    (P <= T <= 120, W = 3) and K2's shapes up to the scaled layout and the
    JV's limit. Returns the plans checked."""
    from smartedgesensor3dhumanpose_tpu_torch import _kernels
    from smartedgesensor3dhumanpose_tpu_torch.ops import association, hungarian, tracker

    lib = _kernels.library()
    checked = 0
    for rows in range(1, hungarian.MAX_N + 1):
        for cols in range(1, hungarian.MAX_N + 1):
            for b in K1_PLAN_BATCHES:
                plan = hungarian.jv_plan(b, rows, cols)
                c_bytes = lib.ses3d_jv_assign_smem_bytes(rows, cols, plan.per_block)
                if c_bytes != plan.smem_bytes or plan.smem_bytes > hungarian.SMEM_LIMIT:
                    raise AssertionError(f"K1 plan B={b} {rows}x{cols}: wrapper {plan}, kernel {c_bytes}")
                checked += 1
    # Past 120 columns: register slots up to 255, the block routine past it,
    # the tile staged where it fits.
    wide = [s for n in range(hungarian.MAX_N + 1, 1025) for s in ((n, n), (n, 8), (16, n))]
    wide += [(hungarian.MAX_N_WIDE, 3), (5, hungarian.MAX_N_WIDE),
             (hungarian.MAX_N_WIDE, hungarian.MAX_N_WIDE)]
    for rows, cols in wide:
        for b in (1, 16):
            plan = hungarian.jv_plan(b, rows, cols)
            c_bytes = lib.ses3d_jv_assign_smem_bytes(rows, cols, plan.per_block)
            if c_bytes != plan.smem_bytes or plan.smem_bytes > hungarian.SMEM_LIMIT:
                raise AssertionError(f"K1 wide plan B={b} {rows}x{cols}: wrapper {plan}, kernel {c_bytes}")
            checked += 1
    for t_slots in range(1, tracker.MAX_TRACKS + 1):
        for p in range(1, t_slots + 1):
            plan = tracker.scan_plan(p, t_slots, 3)
            c_bytes = lib.ses3d_tracker_scan_smem_bytes(p, t_slots, 3, plan.stages,
                                                        int(plan.rings_on_chip))
            if c_bytes != plan.smem_bytes:
                raise AssertionError(f"K3 plan {p}x{t_slots}: wrapper {plan}, kernel {c_bytes} bytes")
            checked += 1
    for c in (1, 2, 5, 16, 33, 64):
        for d in (1, 6, 8, 9, 32):
            for h in (1, 4, 16, 40, 120):
                if max(h, association.padded_dets(d)) > 120:
                    continue
                plan = association.fold_plan(c, d, h)
                c_bytes = lib.ses3d_association_fold_smem_bytes(c, d, h, int(plan.prefetch))
                if c_bytes != plan.smem_bytes:
                    raise AssertionError(f"K2 plan C={c} D={d} H={h}: wrapper {plan}, kernel {c_bytes}")
                checked += 1
    return checked


# K1's kernel instances: the register routine at 1-8 slots (8 also with the
# cost read from device memory) and the block routine, staged or not.
K1_INSTANCES = 11


def check_k1_ptxas(build_log) -> str:
    """K1's instances keep their state in registers or shared memory: no
    stack frame and no spill in `nvcc -Xptxas -v`. Returns their register
    counts, or why nothing was checked."""
    if build_log is None:
        return "'not checked: the library was already built'"
    found = {}
    name = None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if re.search(r"jv_assign_(wide_)?kernel", m.group(1)) else None
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            if any(int(x) for x in m.groups()):
                raise AssertionError(f"K1 {name} uses local memory: {line.strip()}")
            found.setdefault(name, "")
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            found[name] = m.group(1)
    if len(found) != K1_INSTANCES:
        raise AssertionError(f"K1: expected {K1_INSTANCES} instances in ptxas output, got {found}")
    return ",".join(v for _, v in sorted(found.items()))


def lm_ptxas(build_log) -> str:
    """L1's and L2's registers, stack frame and spills from `nvcc -Xptxas
    -v`; either with a stack frame or a spill fails."""
    if build_log is None:
        return "'not read: the library was already built'"
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(lm_trip_kernel|lm_marginals_kernel)", line)
        if m:
            name = m.group(1)
        elif "Compiling entry function" in line:
            name = None
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            if any(int(x) for x in m.groups()):
                raise AssertionError(f"{name} uses local memory: {line.strip()}")
            out[name] = f"stack {m.group(1)} spill {m.group(2)}/{m.group(3)}"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name] = f"{out.get(name, '')} registers {m.group(1)}".strip()
    if len(out) != 2:
        raise AssertionError(f"L1 and L2: expected both in ptxas output, got {out}")
    return "'" + "; ".join(f"{k}: {v}" for k, v in sorted(out.items())) + "'"


# ---------------------------------------------------------------- phase 2 --

def k1_cases(rng):
    """(name, cost [R, C] float32, row_active [R] bool or None) cases."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import association

    cases = []
    for n in (1, 2, 8, 16, 24, 40, 64, 120):
        half = max(1, n // 2)
        for shape in sorted({(n, n), (half, n), (n, half)}):
            cases.append((f"rand{shape}", rng.uniform(size=shape), None))
            clipped = rng.uniform(size=shape)
            clipped[rng.uniform(size=shape) < 0.4] = association.ASSIGN_COST_CLIP
            cases.append((f"clip{shape}", clipped, None))
    # The tie tiers the fold builds: infeasible entries on CLIP + eps(d+1)(h+1),
    # unusable detection rows on 2 CLIP (rows = detections, cols = hypotheses).
    for d, h in ((8, 16), (8, 8), (16, 40)):
        base = rng.uniform(0.0, 0.09, size=(d, h))
        infeasible = base > 0.045
        tie = association.SOLVER_TIE_EPS * np.outer(np.arange(1, d + 1), np.arange(1, h + 1))
        tiered = np.where(infeasible, association.ASSIGN_COST_CLIP + tie, base)
        bad_rows = rng.uniform(size=d) < 0.3
        tiered[bad_rows] = association.INVALID_DET_COST
        cases.append((f"tier{d}x{h}", tiered, ~bad_rows if h >= d else None))
    # The tracker's problems: persons x track slots, invalid persons' rows
    # on the clipped max_dist tier and skipped through row_active; the demo
    # shape, the scaled layout's and the domain's edge (S = 1, 3, 4 slots).
    for (p, t_slots), valid_counts in (((16, 24), (0, 3, 6, 16)), ((40, 64), (9, 40)),
                                       ((120, 120), (60, 120))):
        for valid_count in valid_counts:
            cost = rng.uniform(0.0, 8.0, size=(p, t_slots))
            act = np.zeros(p, bool)
            act[rng.permutation(p)[:valid_count]] = True
            cost[~act] = 1.0e3
            cases.append((f"track{p}x{t_slots}v{valid_count}", cost, act))
    # Many exact ties at every slot count: small integer costs.
    for n in (24, 40, 64, 120):
        cases.append((f"ties{n}", rng.integers(0, 3, size=(n, n)).astype(np.float64), None))
    return [(nm, c.astype(np.float32), a) for nm, c, a in cases]


def check_k1_total(name, cost, act, got):
    """A full assignment of the active rows whose total equals scipy's
    float64 optimum within TOTAL_RTOL."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    rows = np.arange(cost.shape[0]) if act is None else np.nonzero(act)[0]
    sub = cost[rows].astype(np.float64)
    if not sub.size:
        return
    r, c = scipy_lsa(sub)
    total = sub[r, c].sum()
    ok = got[rows] >= 0
    if ok.sum() != min(sub.shape) or len(set(got[rows][ok])) != ok.sum():
        raise AssertionError(f"K1 {name}: not a full assignment {got}")
    mine = sub[np.nonzero(ok)[0], got[rows][ok]].sum()
    if abs(mine - total) > TOTAL_RTOL * max(1.0, abs(total)):
        raise AssertionError(f"K1 {name}: total {mine} vs scipy {total}")


def phase_k1(dev, rng):
    from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian

    worst = 0
    checked = 0
    for name, cost, act in k1_cases(rng):
        c_dev = torch.from_numpy(cost).to(dev)
        a_dev = None if act is None else torch.from_numpy(act).to(dev)
        got = hungarian.linear_sum_assignment(c_dev, a_dev)
        torch.cuda.synchronize()
        want = hungarian.linear_sum_assignment_reference(c_dev, a_dev)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        worst = max(worst, int(np.abs(got.astype(np.int64) - want).max(initial=0)))
        if not np.array_equal(got, want):
            raise AssertionError(f"K1 {name}: kernel {got} != plain {want}")
        check_k1_total(name, cost, act, got)
        checked += 1
    for b, r, c in K1_BATCHED:
        cost = rng.uniform(size=(b, r, c)).astype(np.float32)
        if r == 40:  # the clip tier over several problems per block
            cost[rng.uniform(size=cost.shape) < 0.4] = 1.0e3
        c_dev = torch.from_numpy(cost).to(dev)
        got = hungarian.linear_sum_assignment_batched(c_dev).cpu().numpy()
        want = hungarian.linear_sum_assignment_batched_reference(c_dev).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"K1 batched {b}x{r}x{c}: kernel != plain")
        for i in range(b):
            check_k1_total(f"batched {b}x{r}x{c}[{i}]", cost[i], None, got[i])
        checked += b
    log("2 K1 vs plain", problems=checked, max_abs_err=worst, scipy_totals="equal",
        batched="'" + " ".join(f"{b}x{r}x{c}:{hungarian.jv_plan(b, r, c)}" for b, r, c in K1_BATCHED) + "'")
    return worst


# ---------------------------------------------------------------- phase 3 --

def scene_data(kw: dict, num_dets: int, **override):
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic

    scene = synthetic.generate_scene(synthetic.SceneConfig(**{**kw, **override}))
    data = synthetic.frames_from_scene(scene, np.float32)
    return synthetic.pad_detections(data, num_dets)


def frame_at(data: dict, f: int, dev):
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    return Frame.from_arrays({k: v[f] for k, v in data.items()}, dev)


def fold_case(frame, rig, fusion_cfg):
    """(ctab, conf_obs, det_ok) of one frame, as Pipeline.step builds them."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion, pipeline

    frame, _ = pipeline.mask_stale_cameras(frame, fusion_cfg.max_sync_diff)
    kp_n, _, det_ok = fusion.normalize_frame(frame, rig, fusion_cfg)
    ctab, conf = fusion.fold_inputs(kp_n, frame.det_score, rig, fusion_cfg)
    return ctab, conf, det_ok


def phase_k2(dev, golden, rig, cfg, scaled):
    from smartedgesensor3dhumanpose_tpu_torch.ops import association

    f_cfg = cfg.fusion
    cases = []
    for scene in SCENES:
        data = scene_data(json.loads(str(golden[f"{scene}/scene"])), f_cfg.max_dets_per_cam)
        for f in range(0, 64, 8):
            cases.append((f"{scene}{f}", fold_case(frame_at(data, f, dev), rig, f_cfg), f_cfg.max_hypotheses))
    # Over capacity: 4 hypothesis slots for 6 people.
    data = scene_data(json.loads(str(golden["benign/scene"])), f_cfg.max_dets_per_cam)
    for f in range(0, 64, 16):
        cases.append((f"overcap{f}", fold_case(frame_at(data, f, dev), rig, f_cfg), 4))
    dropped = 0
    solved = 0
    for name, (ctab, conf, dok), h_cap in cases:
        args = (h_cap, f_cfg.max_epipolar_error, f_cfg.max_cost)
        got = association.associate_fold(ctab, conf, dok, *args)
        torch.cuda.synchronize()
        want = association.associate_fold_reference(ctab, conf, dok, *args)
        for g, w, what in zip(got, want, ("det_slot", "n_hyp", "n_dropped")):
            if not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"K2 {name} {what}: kernel {g} != plain {w}")
        dropped += int(want[2])
        solved += 1
    if dropped == 0:
        raise AssertionError("K2: the over-capacity frames dropped no spawn")
    # The batched launch (one block per frame) equals frame-by-frame calls.
    ctab = torch.stack([c[1][0] for c in cases[:8]])
    conf = torch.stack([c[1][1] for c in cases[:8]])
    dok = torch.stack([c[1][2] for c in cases[:8]])
    args = (f_cfg.max_hypotheses, f_cfg.max_epipolar_error, f_cfg.max_cost)
    batched = association.associate_fold_batched(ctab, conf, dok, *args)
    for i in range(8):
        single = association.associate_fold(ctab[i], conf[i], dok[i], *args)
        if not all(torch.equal(b[i], s) for b, s in zip(batched, single)):
            raise AssertionError(f"K2 batched frame {i} != single")
    # The JV's limit, h_cap = 120 hypothesis slots, on scaled-layout frames
    # (64 cameras, D = 32, so n = 120 solver columns over 32 detection rows).
    s_cfg, s_rig, s_frames = scaled
    ctab, conf, dok = chunk_fold_inputs(s_frames, s_rig, s_cfg.fusion, EDGE_FOLD_FRAMES)
    args = (EDGE_SLOTS, s_cfg.fusion.max_epipolar_error, s_cfg.fusion.max_cost)
    got = association.associate_fold_batched(ctab, conf, dok, *args)
    torch.cuda.synchronize()
    want = association.associate_fold_batched_reference(ctab, conf, dok, *args)
    for g, w, what in zip(got, want, ("det_slot", "n_hyp", "n_dropped")):
        if not torch.equal(g.cpu(), w.cpu().to(g.dtype)):
            raise AssertionError(f"K2 h_cap={EDGE_SLOTS} {what}: kernel != plain")
    log("3 K2 vs plain", frames=solved, overcap_dropped=dropped, max_abs_err=0,
        hcap120_frames=EDGE_FOLD_FRAMES, hcap120_n_hyp=[int(x) for x in got[1]],
        demo_plan=repr(association.fold_plan(16, f_cfg.max_dets_per_cam, f_cfg.max_hypotheses)),
        hcap120_plan=repr(association.fold_plan(ctab.shape[1], ctab.shape[3], EDGE_SLOTS)))
    return 0


def scaled_setup(dev):
    """The scaled layout (bench.py's scaled cell) on the card: (config, rig,
    stacked frames of SCALED_SCENE)."""
    from smartedgesensor3dhumanpose_tpu_torch import cameras
    from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig.scaled_64cam()
    rig = cameras.hall_rig(SCALED_SCENE["num_cameras"], device=dev)
    data = scene_data(SCALED_SCENE, cfg.fusion.max_dets_per_cam)
    return cfg, rig, stacked_frames(data, dev)


def chunk_fold_inputs(frames, rig, fusion_cfg, n: int):
    """(ctab, conf_obs, det_ok) of the first n frames as fuse_offline's
    chunk builds them."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    chunk, _ = pipeline.mask_stale_cameras(Frame(*(x[:n] for x in frames)), fusion_cfg.max_sync_diff)
    kp_n, _, det_ok = fusion.normalize_frame(chunk, rig, fusion_cfg)
    ctab, conf = fusion.fold_inputs(kp_n, chunk.det_score, rig, fusion_cfg)
    return ctab, conf, det_ok


# ---------------------------------------------------------------- phase 4 --

def step_mismatch(out, golden, scene, f):
    """How one frame's outputs depart from the golden's: (decisions that
    differ, worst fused m, worst pred m, pred_delta_t error s, all joints
    finite). Joints are compared outside the first-published mask."""
    def g(k):
        return golden[f"{scene}/{k}"][f]

    def np_(t):
        return t.detach().cpu().numpy()

    got = {
        "raw_valid": np_(out.persons_raw.valid),
        "fused_valid": np_(out.fused.valid),
        "pred_valid": np_(out.fused_pred.valid),
        "fb_valid": np_(out.feedback.valid),
        "fb_kp_valid": np_(out.feedback.kp_valid),
        "n_dropped_hyp": np_(out.n_dropped_hypotheses),
        "n_dropped_spawns": np_(out.n_dropped_track_spawns),
    }
    bad = [k for k, v in got.items() if not np.array_equal(v, g(k))]
    fv = got["fused_valid"] & g("fused_valid")
    rv = got["raw_valid"] & g("raw_valid")
    if not np.array_equal(np_(out.fused.person_id)[fv], g("fused_id")[fv]):
        bad.append("fused_id")
    if not np.array_equal((np_(out.fused.score) > 0)[fv], g("fused_joint_on")[fv]):
        bad.append("fused_joint_on")
    if not np.array_equal((np_(out.persons_raw.score) > 0)[rv], g("raw_joint_on")[rv]):
        bad.append("raw_joint_on")
    dt_err = abs(float(out.pred_delta_t) - float(g("pred_delta_t")))
    on = fv[:, None] & g("fused_joint_on") & ~g("first_published")[:, None]
    d_fused = np.abs(np_(out.fused.xyz) - g("fused_xyz"))[on].max(initial=0.0)
    d_pred = np.abs(np_(out.fused_pred.xyz) - g("pred_xyz"))[on].max(initial=0.0)
    finite = bool(np.isfinite(np_(out.fused.xyz)).all() and np.isfinite(np_(out.fused_pred.xyz)).all())
    return bad, float(d_fused), float(d_pred), dt_err, finite


def compare_step(out, golden, scene, f):
    """Integer decisions exactly equal; joints within JOINT_TOL_M outside
    the first-published mask. Returns (worst fused m, worst pred m)."""
    bad, d_fused, d_pred, dt_err, finite = step_mismatch(out, golden, scene, f)
    if bad:
        raise AssertionError(f"slice {scene} frame {f}: decisions differ: {bad}")
    if dt_err > DELTA_T_TOL_S:
        raise AssertionError(f"slice {scene} frame {f}: pred_delta_t off by {dt_err} s")
    if not finite:
        raise AssertionError(f"slice {scene} frame {f}: non-finite joints")
    if d_fused > JOINT_TOL_M or d_pred > JOINT_TOL_M:
        raise AssertionError(
            f"slice {scene} frame {f}: fused {d_fused * 1e3:.4f} mm, "
            f"pred {d_pred * 1e3:.4f} mm > {JOINT_TOL_M * 1e3} mm"
        )
    return d_fused, d_pred


# K1, K2, K3, L1, L2 and F1 by name in the host launch count
# (_kernels.LAUNCHES), in read_counts' order.
COUNTED = ("jv_assign", "association_fold", "tracker_scan", "lm_trip", "lm_marginals",
           "triangulation")


def reset_counts():
    from smartedgesensor3dhumanpose_tpu_torch import _kernels

    _kernels.LAUNCHES.clear()


def read_counts():
    """(K1, K2, K3, L1, L2, F1) launches since the last reset_counts()."""
    from smartedgesensor3dhumanpose_tpu_torch import _kernels

    return tuple(_kernels.LAUNCHES[name] for name in COUNTED)


# K1, K2, K3, L1, L2 and F1 by name in a device trace: K1 is the
# register-state kernel up to 255 columns or the block routine's past them.
# A count is a tuple in this order; the gates of K1-K3 read its first three
# entries, check_lm_host and check_lm_device the next two (L1 runs the
# whole LM in one launch, L2 after it), check_f1_device the last (F1
# triangulates a fusion call's hypotheses in one launch).
KERNEL_NAMES = (("jv_assign_kernel", "jv_assign_wide_kernel"), ("association_fold_kernel",),
                ("tracker_scan_kernel",), ("lm_trip_kernel",), ("lm_marginals_kernel",),
                ("triangulation_kernel",))
N_KERNELS = len(KERNEL_NAMES)
L1, L2, F1 = 3, 4, 5


def check_lm_host(what: str, counts, lms: int) -> None:
    """A captured entry point's first call on the host: L1 and L2 once per
    LM in the warm-up and once in the capture."""
    want = (FIRST_CALL_HOST_LAUNCHES * lms,) * 2
    if tuple(counts[L1:L2 + 1]) != want:
        raise AssertionError(f"{what}: (L1, L2) launched {counts[L1:]} on the host over {lms} "
                             f"LMs, expected {want}")


def check_lm_device(what: str, counts, lms: int) -> None:
    """L1 and L2 once per LM on the device."""
    if tuple(counts[L1:L2 + 1]) != (lms, lms):
        raise AssertionError(f"{what}: (L1, L2) ran {counts[L1:]} times on the device, "
                             f"expected {lms} each")


def check_f1_device(what: str, counts, launches: int) -> None:
    """F1 once per fusion call (triangulate_hypotheses) on the device."""
    if counts[F1] != launches:
        raise AssertionError(f"{what}: F1 ran {counts[F1]} times on the device, expected "
                             f"{launches}")


def kernel_index(name: str):
    """0-5 for a K1, K2, K3, L1, L2 or F1 device event's name, else None."""
    for i, keys in enumerate(KERNEL_NAMES):
        if any(k in name for k in keys):
            return i
    return None
# The wrappers count launches on the host. A captured entry point's first
# call launches each kernel of its body twice there: once in its eager
# warm-up (graphs.CapturedFunction) and once recorded by the capture. Its
# replays launch nothing on the host; their kernels are counted on the
# device (device_counts).
FIRST_CALL_HOST_LAUNCHES = 2
# Replays of the captured step (phase 4) and frames of a chain (phase
# 13.2) whose kernels are counted on the device.
STEP_PROFILED = 4


def device_counts(fn):
    """(fn(), (K1, K2, K3, L1, L2) kernels that ran on the device during fn()),
    counted by name in a torch.profiler trace of the card (the kernels of
    a graph replay included)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return result, tuple(sum(kernel_index(n) == i for n in names) for i in range(N_KERNELS))


def first_call(fn):
    """(fn(), seconds, MiB): the wall time of a captured entry point's
    first call (warm-up and capture) and the growth of memory_reserved over
    it, from an emptied cache: the graph's pool, its static buffers and the
    returned copies."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, (torch.cuda.memory_reserved() - reserved) / 2**20


def phase_slice(dev, golden, rig, cfg):
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic

    pipe = pipeline.Pipeline(rig, cfg, device=dev)
    inputs = {}
    for scene in SCENES:
        data = scene_data(json.loads(str(golden[f"{scene}/scene"])), cfg.fusion.max_dets_per_cam)
        if synthetic.frames_digest(data) != str(golden[f"{scene}/input_sha256"]):
            raise AssertionError(f"{scene}: regenerated scene differs from the golden's input")
        inputs[scene] = data

    # Pipeline.step is a CUDA graph: the run's first call captures it, and
    # the wrappers count that call's warm-up and capture. The replays'
    # kernels are counted on the device in phase 5, after its timing: a
    # profiler session slows the graph replays that follow it (PERF.md).
    reset_counts()
    worst_f = worst_p = 0.0
    frames = 0
    persons = 0
    for scene in SCENES:
        data = inputs[scene]
        state = pipe.init_state()
        for f in range(data["kp2d"].shape[0]):
            frame = frame_at(data, f, dev)
            if frames == 0:
                (state, out), capture_s, graph_mib = first_call(lambda: pipe.step(state, frame))
            else:
                state, out = pipe.step(state, frame)
            df, dp = compare_step(out, golden, scene, f)
            worst_f, worst_p = max(worst_f, df), max(worst_p, dp)
            persons += int(out.fused.valid.sum())
            frames += 1
    host = read_counts()
    want_host = (FIRST_CALL_HOST_LAUNCHES,) * 2 + (0,)
    if host[:3] != want_host:
        raise AssertionError(f"launch counts (K1, K2, K3) on the host {host}, expected {want_host}")
    check_lm_host("step", host, 1)
    if host[F1] != FIRST_CALL_HOST_LAUNCHES:
        raise AssertionError(f"step: F1 launched {host[F1]} times on the host, expected "
                             f"{FIRST_CALL_HOST_LAUNCHES}")
    log("4 slice", captured=True, first_call_s=capture_s, first_call_reserved_mib=graph_mib,
        frames=frames, published_persons=persons, decisions="exact",
        worst_fused_mm=worst_f * 1e3, worst_pred_mm=worst_p * 1e3,
        host_launches=list(host))
    return pipe, inputs, {"step": host}


# ---------------------------------------------------------------- phase 5 --

def stage_times(pipe, state, frames):
    """Median wall ms of the step's stages (Pipeline.step's calls, with a
    device sync after each) over `frames`."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion, pipeline, reprojection, tracking

    cfg, rig = pipe.config, pipe.rig
    laps = {"fuse_ms": [], "track_ms": [], "reproject_ms": []}
    for frame in frames:
        t0 = time.perf_counter()
        frame, pivot = pipeline.mask_stale_cameras(frame, cfg.fusion.max_sync_diff)
        persons, _ = fusion.fuse_frame(frame, rig, cfg.fusion, with_stats=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, out = tracking.step(state, persons, pivot.to(persons.xyz.dtype),
                                   frame.fb_delay, cfg.prior, cfg.tracker)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        reprojection.reproject(out.fused_pred, rig, cfg.prior.pose_method,
                               out.pred_delta_t, cfg.fusion.ut_kappa, frame.cam_stamp)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, ms in zip(laps, ((t1 - t0), (t2 - t1), (t3 - t2))):
            laps[key].append(ms * 1e3)
    return {k: statistics.median(v) for k, v in laps.items()}


def phase_times(dev, pipe, golden, rig, cfg, rng, profile_dir):
    from smartedgesensor3dhumanpose_tpu_torch.ops import association, hungarian

    data = scene_data(json.loads(str(golden["benign/scene"])), cfg.fusion.max_dets_per_cam,
                      num_frames=130)
    frames = [frame_at(data, f, dev) for f in range(130)]
    state = pipe.init_state()
    for f in range(20):
        state, _ = pipe.step(state, frames[f])
    torch.cuda.synchronize()
    step_ms = []
    for f in range(20, 120):
        t0 = time.perf_counter()
        state, _ = pipe.step(state, frames[f])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    # Host syncs of one warm step, as torch's sync debug mode reports them.
    sites = sync_sites(lambda: pipe.step(state, frames[120]))
    syncs = len(sites)

    # The kernels of STEP_PROFILED replays, counted on the device; then the
    # same steps timed again after that profiler session.
    on_device = (0,) * N_KERNELS
    for f in range(STEP_PROFILED):
        (state, _), counts = device_counts(lambda: pipe.step(state, frames[121 + f]))
        on_device = tuple(a + b for a, b in zip(on_device, counts))
    if on_device[:3] != (STEP_PROFILED,) * 2 + (0,):
        raise AssertionError(f"step: {on_device} kernels on the device over {STEP_PROFILED} replays")
    check_lm_device("step", on_device, STEP_PROFILED)
    check_f1_device("step", on_device, STEP_PROFILED)
    after = pipe.init_state()
    after_ms = []
    for f in range(120):
        t0 = time.perf_counter()
        after, _ = pipe.step(after, frames[f])
        torch.cuda.synchronize()
        after_ms.append((time.perf_counter() - t0) * 1e3)
    after_ms = after_ms[20:]

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for f in range(121, 130):
                state, _ = pipe.step(state, frames[f])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 9
        averages = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in averages) / 1e3 / 9
        with open(os.path.join(profile_dir, "profile_steps.txt"), "w") as fh:
            fh.write(averages.table(sort_by="self_device_time_total", row_limit=40))
        # A trace may miss kernels of the merge's WHILE body (trips_in_trace):
        # its busy time bounds the device's from below.
        log("5 profile", steps=9, wall_ms_per_step=wall_ms,
            device_busy_ms_per_step_in_trace=busy_ms, device_idle_share_at_most=1.0 - busy_ms / wall_ms)
        log("5 stages", **stage_times(pipe, pipe.init_state(), frames[:30]))

    # K1 at the tracker's shape (16 persons x 24 slots, 6 valid).
    cost = rng.uniform(0.0, 8.0, size=(16, 24)).astype(np.float32)
    act = np.zeros(16, bool)
    act[:6] = True
    cost[~act] = 1.0e3
    c_dev = torch.from_numpy(cost).to(dev)
    a_dev = torch.from_numpy(act).to(dev)
    reset_counts()
    k1_ms = sync_time(lambda: hungarian.linear_sum_assignment(c_dev, a_dev), 200)
    k1_durs = kernel_durations(lambda: hungarian.linear_sum_assignment(c_dev, a_dev),
                               "jv_assign_kernel", 50)
    k1_device_ms = statistics.mean(k1_durs) / 1e3 if k1_durs else "not_measured"
    k1_plain = sync_time(lambda: hungarian.linear_sum_assignment_reference(c_dev, a_dev), 10)
    # K2 at the demo shapes on a real frame (with ambiguous cameras).
    ctab, conf, dok = fold_case(frames[40], rig, cfg.fusion)
    args = (cfg.fusion.max_hypotheses, cfg.fusion.max_epipolar_error, cfg.fusion.max_cost)
    k2_ms = sync_time(lambda: association.associate_fold(ctab, conf, dok, *args), 200)
    k2_plain = sync_time(lambda: association.associate_fold_reference(ctab, conf, dok, *args), 5)
    quart = statistics.quantiles(step_ms, n=10)
    # Bounds: K1 as k1_bound counts it. The fold reads its pair-cost table,
    # flags and writes det_slot; per camera it sums up to c earlier costs
    # for every (hypothesis, detection) and runs one JV over hypotheses.
    k1_b = k1_bound(cost[None], act[None])
    c_cams, _, d = ctab.shape
    h = args[0]
    k2_bound = bound_of(
        ctab.numel() * 4 + conf.numel() * 4 + dok.numel() + h * c_cams * 4 + 8,
        h * d * c_cams * (c_cams - 1) // 2 + c_cams * d * (h + 1) * h * 4,
    )
    log("5 times", steps=len(step_ms), step_ms_median=statistics.median(step_ms),
        step_ms_p10=quart[0], step_ms_p90=quart[-1], step_ms_min=min(step_ms),
        step_ms_max=max(step_ms), host_syncs_per_step=syncs, sync_sites=",".join(sites) or "none",
        replays_profiled=STEP_PROFILED, device_launches=list(on_device),
        after_profiler_step_ms_median=statistics.median(after_ms),
        after_profiler_step_ms_p90=statistics.quantiles(after_ms, n=10)[-1],
        k1_ms=k1_ms, k1_device_ms=k1_device_ms, k1_plain_ms=k1_plain, k1_bound_ms=k1_b[0],
        k2_ms=k2_ms, k2_plain_ms=k2_plain, k2_bound_ms=k2_bound[0])
    return ({"jv_assign": (k1_ms, k1_plain) + k1_b,
             "association_fold": (k2_ms, k2_plain) + k2_bound},
            {"step_replays_on_device": on_device})


# ---------------------------------------------------------------- phase 6 --

def at_frame(tree, f: int):
    """Frame f of a StepOutput (or any tuple of tensors) with a leading
    time axis."""
    if isinstance(tree, torch.Tensor):
        return tree[f]
    return type(tree)(*(at_frame(x, f) for x in tree))


def stacked_frames(data: dict, dev):
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    return Frame.from_arrays(data, dev)


def golden_stage(golden, scene: str, dev):
    """The offline golden's tracker-stage inputs on `dev`: (persons, pivots,
    n_dropped_hypotheses, smooth_cold output) as the JAX reference's fusion
    and cold-start LM gave them. Fields the tracker does not read (the
    persons' covariance, the LM's measurements, whitening, bones, anchor
    scores and marginals) are left as zeros."""
    from smartedgesensor3dhumanpose_tpu_torch import prior
    from smartedgesensor3dhumanpose_tpu_torch.types import Persons3D

    def g(k):
        return torch.as_tensor(golden[f"{scene}/stage_in/{k}"], device=dev)

    xyz = g("person_xyz")
    lead = xyz.shape[:2]
    unread = torch.zeros(lead, dtype=xyz.dtype, device=dev)
    persons = Persons3D(
        xyz=xyz, score=g("person_score"), cov=torch.zeros(xyz.shape + (3,), device=dev),
        valid=g("person_valid"), person_id=torch.full(lead, -1, dtype=torch.int32, device=dev),
    )
    g_in = prior.GraphInputs(
        meas=unread, active=g("graph_active"), inv_cov=unread, bone_active=unread,
        root_xyz=g("graph_root_xyz"), root_score=unread, neck_score=unread,
        height=g("graph_height"), score_out=g("graph_score_out"), num_meas=g("graph_num_meas"),
    )
    result = prior.PriorResult(x=g("result_x"), marg_cov=unread, marg_ok=unread,
                               iters=torch.zeros((), dtype=torch.int32, device=dev))
    return persons, g("pivot"), g("n_dropped_hyp"), (g_in, result, g("xyz_out"), g("cov_out"))


def plain_offline(pipe, state0, frames):
    """run_offline with the plain fold and the plain tracker scan."""
    import dataclasses

    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.ops import tracker

    cfg = pipe.config
    plain = dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, assignment_impl="reference"))
    persons, pivots, n_drop = pipeline.fuse_offline(frames, pipe.rig, plain, pipe.fusion_batch)
    pre = pipeline.smooth_offline(persons, plain, pipe.fusion_batch)
    _, track = tracker.tracker_scan_reference(state0, persons, pivots.to(persons.xyz.dtype),
                                              frames.fb_delay, pre, cfg.prior, cfg.tracker)
    return pipeline.offline_outputs(frames, persons, pivots, n_drop, track, pipe.rig, cfg)


def offline_diff(got, want) -> tuple:
    """How one offline StepOutput departs from another: (integer fields
    that differ, {path: largest joint difference in m})."""
    bad, worst = [], {}
    for path, a, b in zip(("persons_raw", "fused", "fused_pred"), got[:3], want[:3]):
        bad += [f"{path}.{field}" for field in ("valid", "person_id")
                if not torch.equal(getattr(a, field), getattr(b, field))]
        worst[path] = float((a.xyz - b.xyz).abs().max())
    bad += [field for field in ("n_dropped_hypotheses", "n_dropped_track_spawns")
            if not torch.equal(getattr(got, field), getattr(want, field))]
    if not torch.equal(got.feedback.kp_valid, want.feedback.kp_valid):
        bad.append("feedback.kp_valid")
    return bad, worst


def compare_outputs(got, want, name: str) -> float:
    """The main path against the plain path on the card: every integer
    field equal, floats within K3's tolerances (fusion and the LM run the
    same ops on both sides). Returns the largest float difference."""
    bad, worst = offline_diff(got, want)
    if bad:
        raise AssertionError(f"{name}: {bad} differ")
    for path, diff in worst.items():
        tol = K3_FLOAT_TOL["fused_pred.xyz"] if path == "fused_pred" else K3_FLOAT_TOL["fused.xyz"]
        if not diff <= tol:
            raise AssertionError(f"{name} {path}.xyz: off by {diff} > {tol}")
    return max(worst.values())


def phase_offline(dev, golden, rig, cfg, inputs):
    """run_offline over both demo scenes, with the launch counts of each
    call, checked in three ways:
      - its fusion stage against the offline golden: every decision exact;
      - its tracker stage (K3 + reprojection) on the golden's own tracker
        inputs against the golden's tracker stage: every decision exact,
        joints within JOINT_TOL_M outside the first-published mask;
      - end to end against the plain path (plain fold, plain tracker scan)
        on the card: every decision exact.
    End to end against the golden it is reported, not gated: the float32
    cold-start LM of the reference does not converge on some ghost persons,
    where its output depends on the summation order (PERF.md, ROADMAP C2)."""
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
    from smartedgesensor3dhumanpose_tpu_torch.ops import tracker

    pipe = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=OFFLINE_FUSION_BATCH)
    # run_offline is a CUDA graph per sequence shape (both scenes share
    # one): the run's first call captures it (the wrappers count its
    # warm-up and capture), and the kernels of each scene's replay are
    # counted on the device.
    reset_counts()
    _, capture_s, graph_mib = first_call(
        lambda: pipe.run_offline(pipe.init_state(), stacked_frames(inputs[SCENES[0]], dev)))
    host = read_counts()
    on_device = (0,) * N_KERNELS
    report = {}
    for scene in SCENES:
        data = inputs[scene]
        if synthetic.frames_digest(data) != str(golden[f"{scene}/input_sha256"]):
            raise AssertionError(f"{scene}: regenerated scene differs from the offline golden's input")
        frames = stacked_frames(data, dev)
        n = data["kp2d"].shape[0]
        state0 = pipe.init_state()
        reset_counts()
        (_, out), counts = device_counts(lambda: pipe.run_offline(state0, frames))
        host_launches_none(f"offline {scene}")
        want = (0, -(-n // OFFLINE_FUSION_BATCH), 1)
        if counts[:3] != want:
            raise AssertionError(f"offline {scene}: launch counts (K1, K2, K3) on the device = "
                                 f"{counts}, expected {want}")
        check_lm_device(f"offline {scene}", counts, want[1])
        check_f1_device(f"offline {scene}", counts, want[1])
        on_device = tuple(a + b for a, b in zip(on_device, counts))

        e2e_frames = 0
        e2e_fused = e2e_pred = 0.0
        for f in range(n):
            bad, d_fused, d_pred, _, finite = step_mismatch(at_frame(out, f), golden, scene, f)
            fusion_bad = [k for k in bad if k in ("raw_valid", "raw_joint_on", "n_dropped_hyp")]
            if fusion_bad or not finite:
                raise AssertionError(f"offline {scene} frame {f}: fusion decisions differ {fusion_bad}")
            if not bad:
                e2e_frames += 1
                e2e_fused, e2e_pred = max(e2e_fused, d_fused), max(e2e_pred, d_pred)

        persons, pivots, n_drop, pre = golden_stage(golden, scene, dev)
        _, track = tracker.tracker_scan(pipe.init_state(), persons, pivots, frames.fb_delay, pre,
                                        cfg.prior, cfg.tracker)
        stage = pipeline.offline_outputs(frames, persons, pivots, n_drop, track, rig, cfg)
        st_fused = st_pred = 0.0
        for f in range(n):
            d_fused, d_pred = compare_step(at_frame(stage, f), golden, f"{scene}/stage", f)
            st_fused, st_pred = max(st_fused, d_fused), max(st_pred, d_pred)

        plain_err = compare_outputs(out, plain_offline(pipe, state0, frames), f"offline {scene}")
        report[scene] = dict(
            published=int(out.fused.valid.sum()), stage_decisions="exact",
            stage_worst_fused_mm=st_fused * 1e3, stage_worst_pred_mm=st_pred * 1e3,
            plain_decisions="exact", plain_max_abs_err=plain_err,
            golden_frames_exact=f"{e2e_frames}/{n}",
            golden_worst_fused_mm=e2e_fused * 1e3, golden_worst_pred_mm=e2e_pred * 1e3,
        )
    want_host = tuple(FIRST_CALL_HOST_LAUNCHES * k for k in want)
    if host[:3] != want_host:
        raise AssertionError(f"offline: launch counts (K1, K2, K3) on the host = {host}, "
                             f"expected {want_host} (the first call's warm-up and capture)")
    check_lm_host("offline", host, want[1])
    log("6 offline slice", captured=True, first_call_s=capture_s, first_call_reserved_mib=graph_mib,
        fusion_batch=OFFLINE_FUSION_BATCH, frames_per_scene=n, fusion_decisions="exact",
        host_launches=list(host), replays_profiled=len(SCENES), device_launches=list(on_device),
        scenes="'" + json.dumps(report) + "'")
    return pipe, {"run_offline": host, "run_offline_replays_on_device": on_device}


# ---------------------------------------------------------------- phase 7 --

def tracker_inputs(pipe, frames):
    """The tracker scan's inputs as run_offline builds them: (persons,
    pivots, fb_delay, smooth_cold output), stacked over frames."""
    from smartedgesensor3dhumanpose_tpu_torch import pipeline

    persons, pivots, _ = pipeline.fuse_offline(frames, pipe.rig, pipe.config, pipe.fusion_batch)
    pre = pipeline.smooth_offline(persons, pipe.config, pipe.fusion_batch)
    return persons, pivots.to(persons.xyz.dtype), frames.fb_delay, pre


def scenario_inputs(name: str, dev):
    """A tracker scenario of io.synthetic on the card: (state0, persons,
    pivots, fb_delay, smooth_cold output, TrackerConfig)."""
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic

    return sequence_inputs(*synthetic.tracker_scenario(name), dev)


def edge_inputs(dev, persons: int = EDGE_SLOTS, t_slots: int = EDGE_SLOTS):
    """A merge-heavy synthetic sequence of EDGE_FRAMES frames, by default at
    the edge of K3's domain, P = T = EDGE_SLOTS (the JV's limit), where K3's
    layout keeps the velocity rings in device memory and stages one frame at
    a time. As scenario_inputs."""
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic

    f = EDGE_FRAMES
    arrays = synthetic.person_sequence(np.random.default_rng(5), f, persons, merge_heavy=True)
    pivots = (np.arange(f) / 30.0).astype(np.float32)
    fb = np.full((f, 4), 0.1, np.float32)
    return sequence_inputs(arrays, pivots, fb, t_slots, 2, dev)


def sequence_inputs(arrays, pivots, fb, t_slots, min_obs, dev):
    """A person sequence of io.synthetic on the card, with its cold-start
    smoothing and a fresh tracker state: (state0, persons, pivots,
    fb_delay, smooth_cold output, TrackerConfig)."""
    from smartedgesensor3dhumanpose_tpu_torch import config, tracking
    from smartedgesensor3dhumanpose_tpu_torch.types import Persons3D, TrackerState

    persons = Persons3D(**{
        k: torch.as_tensor(v, dtype=torch.float32 if v.dtype == np.float64 else None, device=dev)
        for k, v in arrays.items()
    })
    tcfg = config.TrackerConfig(max_tracks=t_slots, min_num_obs=min_obs)
    state0 = TrackerState.initial(t_slots, tcfg.n_mov_avg, tcfg.avg_delay, device=dev)
    pre = tracking.smooth_cold(persons, config.PriorConfig())
    return (state0, persons, torch.as_tensor(pivots, device=dev),
            torch.as_tensor(fb, device=dev), pre, tcfg)


def count_merges(state0, persons, pivots, fb, pre, prior_cfg, tcfg) -> int:
    """Tracks the plain scan removes by merging: alive before a frame, dead
    after it, and not decayed."""
    from smartedgesensor3dhumanpose_tpu_torch import tracking
    from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian, tracker

    state = state0
    merged = 0
    for f in range(pivots.shape[0]):
        new, _ = tracking.step(
            state, tracker._frame(persons, f), pivots[f], fb[f], prior_cfg, tcfg,
            precomputed=tracker._frame(pre, f), assign=hungarian.linear_sum_assignment_reference,
        )
        fresh = (pivots[f] - new.t_prev) <= tcfg.max_unobserved_time
        merged += int((state.alive & ~new.alive & fresh).sum())
        state = new
    return merged


def compare_scan(got, want, name: str) -> float:
    """K3 against the plain scan: integers equal, floats within
    K3_FLOAT_TOL. Returns the largest float difference."""
    st_g, out_g = got
    st_w, out_w = want
    exact = {
        "publish": (out_g.fused.valid, out_w.fused.valid),
        "person_id": (out_g.fused.person_id, out_w.fused.person_id),
        "pred ids": (out_g.fused_pred.person_id, out_w.fused_pred.person_id),
        "n_dropped_spawns": (out_g.n_dropped_spawns, out_w.n_dropped_spawns),
    }
    for field in ("alive", "track_id", "num_obs", "next_id", "frame_nr", "est_exists"):
        exact[field] = (getattr(st_g, field), getattr(st_w, field))
    bad = [k for k, (a, b) in exact.items() if not torch.equal(a.cpu(), b.cpu())]
    if bad:
        raise AssertionError(f"K3 {name}: integer outputs differ from the plain scan: {bad}")
    floats = {
        "pred_delta_t": (out_g.pred_delta_t, out_w.pred_delta_t),
        "fused.xyz": (out_g.fused.xyz, out_w.fused.xyz),
        "fused_pred.xyz": (out_g.fused_pred.xyz, out_w.fused_pred.xyz),
        "fused_pred.cov": (out_g.fused_pred.cov, out_w.fused_pred.cov),
    }
    for field in ("estimate", "vel_buffer", "t_prev", "height_prev", "root_prev",
                  "fb_delay_buffer", "t_prev_global"):
        floats[field] = (getattr(st_g, field), getattr(st_w, field))
    worst = 0.0
    for k, (a, b) in floats.items():
        a = a.detach().double().cpu()
        b = b.detach().double().cpu()
        both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a) == torch.sign(b))
        diff = torch.where(both_inf, 0.0, (a - b).abs())
        if torch.isnan(diff).any() or float(diff.max()) > K3_FLOAT_TOL[k]:
            raise AssertionError(
                f"K3 {name} {k}: off by {float(diff.max())} > {K3_FLOAT_TOL[k]}"
            )
        worst = max(worst, float(diff.max()))
    return worst


def check_k3(name, state0, persons, pivots, fb, pre, prior_cfg, tcfg):
    """K3 against its plain version on one sequence; returns (largest float
    difference, spawns dropped, tracks merged, frames)."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import tracker

    got = tracker.tracker_scan(state0, persons, pivots, fb, pre, prior_cfg, tcfg)
    torch.cuda.synchronize()
    want = tracker.tracker_scan_reference(state0, persons, pivots, fb, pre, prior_cfg, tcfg)
    err = compare_scan(got, want, name)
    if int(want[1].fused.valid.sum()) == 0:
        raise AssertionError(f"K3 {name}: the plain scan published nothing")
    drops = int(want[1].n_dropped_spawns.sum())
    merges = count_merges(state0, persons, pivots, fb, pre, prior_cfg, tcfg)
    return err, drops, merges, int(pivots.shape[0])


def phase_k3(dev, pipe, inputs):
    from smartedgesensor3dhumanpose_tpu_torch import config
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
    from smartedgesensor3dhumanpose_tpu_torch.ops import tracker

    prior_cfg = config.PriorConfig()
    worst = 0.0
    drops = merges = frames = 0
    per_case = {}
    for name in synthetic.TRACKER_SCENARIOS:
        state0, persons, pivots, fb, pre, tcfg = scenario_inputs(name, dev)
        e, d, m, n = check_k3(name, state0, persons, pivots, fb, pre, prior_cfg, tcfg)
        worst, drops, merges, frames = max(worst, e), drops + d, merges + m, frames + n
        per_case[name] = (d, m)
    for scene in SCENES:
        persons, pivots, fb, pre = tracker_inputs(pipe, stacked_frames(inputs[scene], dev))
        e, d, m, n = check_k3(scene, pipe.init_state(), persons, pivots, fb, pre,
                              pipe.config.prior, pipe.config.tracker)
        worst, drops, merges, frames = max(worst, e), drops + d, merges + m, frames + n
        per_case[scene] = (d, m)
    # The domain's edge, P = T = 120: the plan stages one frame at a time
    # and keeps the velocity rings in device memory.
    state0, persons, pivots, fb, pre, tcfg = edge_inputs(dev)
    plan = tracker.scan_plan(EDGE_SLOTS, EDGE_SLOTS, state0.vel_buffer.shape[2])
    if plan.stages == 2 and plan.rings_on_chip:
        raise AssertionError(f"K3 edge: {plan} keeps everything on chip; the case tests nothing")
    e, d, m, n = check_k3(f"edge{EDGE_SLOTS}", state0, persons, pivots, fb, pre, prior_cfg, tcfg)
    worst, drops, merges, frames = max(worst, e), drops + d, merges + m, frames + n
    per_case[f"edge{EDGE_SLOTS}"] = (d, m)
    # An odd slot count with everything on chip: the state after the rings
    # [T, 21, 3, 3] f32 must stay 8-byte aligned whatever T is.
    state0, persons, pivots, fb, pre, tcfg = edge_inputs(dev, *ODD_SHAPE)
    e, d, m, n = check_k3("odd", state0, persons, pivots, fb, pre, prior_cfg, tcfg)
    worst, drops, merges, frames = max(worst, e), drops + d, merges + m, frames + n
    per_case["odd"] = (d, m)
    if drops == 0 or merges == 0:
        raise AssertionError(f"K3: no dropped spawn or no merge was exercised {per_case}")
    log("7 K3 vs plain", sequences=len(per_case), frames=frames, decisions="exact",
        max_abs_err=worst, dropped_spawns=drops, merged_tracks=merges,
        per_case="'" + json.dumps(per_case) + "'", edge_plan=repr(plan),
        demo_plan=repr(tracker.scan_plan(16, 24, 3)))
    return worst


# ---------------------------------------------------------------- phase 8 --

def phase_scaled(dev, scaled):
    """The scaled layout end to end, then K3 and the batched K2 against
    their plain versions on its inputs."""
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.ops import association, tracker

    cfg, rig, frames = scaled
    n = frames.kp2d.shape[0]
    pipe = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=SCALED_FUSION_BATCH)
    # The first call captures run_offline's graph at this shape: the
    # wrappers count its warm-up and capture, and the replay nothing.
    reset_counts()
    t0 = time.perf_counter()
    pipe.run_offline(pipe.init_state(), frames)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, out = pipe.run_offline(pipe.init_state(), frames)
    torch.cuda.synchronize()
    counts = read_counts()
    wall_s = time.perf_counter() - t0
    want = (0, FIRST_CALL_HOST_LAUNCHES * -(-n // SCALED_FUSION_BATCH), FIRST_CALL_HOST_LAUNCHES)
    if counts[:3] != want:
        raise AssertionError(f"scaled: launch counts (K1, K2, K3) = {counts}, expected {want}")
    check_lm_host("scaled", counts, -(-n // SCALED_FUSION_BATCH))
    published = int(out.fused.valid.sum())
    pub = out.fused.valid
    if published == 0:
        raise AssertionError("scaled: run_offline published nobody")
    if not (torch.isfinite(out.fused.xyz[pub]).all() and torch.isfinite(out.fused_pred.xyz[pub]).all()):
        raise AssertionError("scaled: non-finite published joints")

    persons, pivots, fb, pre = tracker_inputs(pipe, frames)
    state0 = pipe.init_state()
    err, drops, merges, _ = check_k3("scaled64", state0, persons, pivots, fb, pre,
                                     cfg.prior, cfg.tracker)
    k3_ms = sync_time(lambda: tracker.tracker_scan(state0, persons, pivots, fb, pre,
                                                   cfg.prior, cfg.tracker), 10)
    ctab, conf, det_ok = chunk_fold_inputs(frames, rig, cfg.fusion, SCALED_FUSION_BATCH)
    args = (cfg.fusion.max_hypotheses, cfg.fusion.max_epipolar_error, cfg.fusion.max_cost)
    got = association.associate_fold_batched(ctab, conf, det_ok, *args)
    torch.cuda.synchronize()
    ref = association.associate_fold_batched_reference(ctab, conf, det_ok, *args)
    for g, w, what in zip(got, ref, ("det_slot", "n_hyp", "n_dropped")):
        if not torch.equal(g.cpu(), w.cpu().to(g.dtype)):
            raise AssertionError(f"scaled K2 batched {what}: kernel != plain")
    log("8 scaled", cams=SCALED_SCENE["num_cameras"], people=SCALED_SCENE["num_people"],
        frames=n, dets=cfg.fusion.max_dets_per_cam, hyps=cfg.fusion.max_hypotheses,
        tracks=cfg.tracker.max_tracks, first_call_s=first_call_s, replay_s=wall_s,
        host_launches=list(counts), published_persons=published,
        k3_vs_plain="exact", k3_max_abs_err=err, k3_dropped=drops, k3_merged=merges, k3_ms=k3_ms,
        k2_batched_frames=SCALED_FUSION_BATCH, k2_vs_plain="exact",
        n_hyp=[int(x) for x in got[1]])
    return err


# ---------------------------------------------------------------- phase 9 --

def sync_sites(fn) -> list:
    """Where the host syncs of one call of `fn` happen, as torch's sync
    debug mode reports them: the innermost line outside torch that led
    there, then torch's own line (file:line>file:line)."""
    sites = []
    running = [False]

    # Only warnings raised while fn runs: the first set_sync_debug_mode
    # call warns by itself (torch 2.11).
    def record(message, category, filename, lineno, file=None, line=None):
        if running[0] and "synchroniz" in str(message):
            outside = [f for f in traceback.extract_stack()
                       if f"{os.sep}torch{os.sep}" not in f.filename
                       and not f.filename.endswith("warnings.py")]
            caller = f"{os.path.basename(outside[-2].filename)}:{outside[-2].lineno}"
            sites.append(f"{caller}>{os.path.basename(filename)}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        running[0] = True
        try:
            fn()
        finally:
            running[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return sites


def count_syncs(fn) -> int:
    """Host syncs of one call of `fn`, as torch's sync debug mode reports."""
    return len(sync_sites(fn))


def k3_bound(persons, state0, has_dets) -> tuple:
    """(bound ms, what bounds it) of K3 on these inputs: the kernel's input,
    state and output bytes once each, and the operations these frames need
    (the cost of valid persons against every slot, their JV searches at
    most n + 1 steps of n lanes, the per-joint velocity update, and the
    [T, T] merge distances on frames with detections)."""
    f, p, k, _ = persons.xyz.shape
    t_slots = state0.alive.shape[0]
    w = state0.vel_buffer.shape[2]
    n_valid = int(persons.valid.sum())
    n_det_frames = int(has_dets.sum())
    inputs = (f * p * k * 3 * 4 * 2          # fusion joints, LM result
              + f * p * (3 + 1) * 4          # root, height
              + f * p * k * 2 + f * p * 2    # joint and person flags
              + f * 5 * 4 + k * 4)           # frame scalars, vel sigmas
    state = sum(x.numel() * x.element_size() for x in (
        state0.estimate, state0.est_exists, state0.vel_buffer, state0.t_prev,
        state0.height_prev, state0.root_prev, state0.alive, state0.track_id,
        state0.num_obs)) + 4
    outputs = f * p * k * 3 * 4 + f * p * (1 + 4) + f * 4
    nbytes = inputs + 2 * state + outputs
    ops = (n_valid * t_slots * k * 19                      # association cost
           + n_valid * (t_slots + 1) * t_slots * 4         # JV searches
           + n_valid * k * 3 * (8 + w)                     # velocity ring, offset
           + n_det_frames * t_slots * (t_slots - 1) // 2 * k * 16)  # merge
    return bound_of(nbytes, ops)


def k1_bound(cost: np.ndarray, act=None) -> tuple:
    """(bound ms, what bounds it) of K1 on cost [B, R, C] float32 and act
    [B, R] bool or None: the cost and mask read once and col_of_row written
    once; the row reduction (R x n compares) and, per search step the plain
    version takes on these inputs, n relaxations of ~4 operations."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian

    b, r, c = cost.shape
    n = max(r, c)
    before = hungarian.PLAIN_SEARCH_STEPS
    hungarian.linear_sum_assignment_batched_reference(
        torch.from_numpy(cost), None if act is None else torch.from_numpy(act))
    steps = hungarian.PLAIN_SEARCH_STEPS - before
    nbytes = cost.nbytes + (0 if act is None else act.nbytes) + b * r * 4
    return bound_of(nbytes, b * r * n + steps * n * 4)


def bound_of(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_offline_times(dev, pipe, inputs, profile_dir):
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.ops import tracker

    cfg, rig = pipe.config, pipe.rig
    data = inputs["benign"]
    frames = stacked_frames(data, dev)
    n = data["kp2d"].shape[0]
    pipe.run_offline(pipe.init_state(), frames)
    torch.cuda.synchronize()
    run_s = []
    for _ in range(5):
        state0 = pipe.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run_offline(state0, frames)
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t0)
    syncs = count_syncs(lambda: pipe.run_offline(pipe.init_state(), frames))

    # Stage split, a sync after each stage (run_offline's own calls).
    laps = {"fuse_ms": [], "smooth_ms": [], "track_ms": [], "reproject_ms": []}
    for _ in range(3):
        state0 = pipe.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        persons, pivots, n_drop = pipeline.fuse_offline(frames, rig, cfg, pipe.fusion_batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre = pipeline.smooth_offline(persons, cfg, pipe.fusion_batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        _, track = tracker.tracker_scan(state0, persons, pivots.to(persons.xyz.dtype),
                                        frames.fb_delay, pre, cfg.prior, cfg.tracker)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pipeline.offline_outputs(frames, persons, pivots, n_drop, track, rig, cfg)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, dt in zip(laps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            laps[key].append(dt * 1e3)

    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                pipe.run_offline(pipe.init_state(), frames)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 3
        averages = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in averages) / 1e3 / 3
        with open(os.path.join(profile_dir, "profile_offline.txt"), "w") as fh:
            fh.write(averages.table(sort_by="self_device_time_total", row_limit=40))
        log("9 profile", runs=3, wall_ms_per_run=wall_ms, device_busy_ms_per_run_in_trace=busy_ms,
            device_idle_share_at_most=1.0 - busy_ms / wall_ms)

    # K3 at the demo shape (64 frames, 16 persons, 24 slots), wrapper call
    # (frame-local precompute, packing, one launch) against the plain scan.
    persons, pivots, fb, pre = tracker_inputs(pipe, frames)
    state0 = pipe.init_state()
    reset_counts()
    k3_ms = sync_time(lambda: tracker.tracker_scan(state0, persons, pivots, fb, pre,
                                                   cfg.prior, cfg.tracker), 20)
    k3_plain = sync_time(lambda: tracker.tracker_scan_reference(state0, persons, pivots, fb, pre,
                                                                cfg.prior, cfg.tracker), 2)
    bound_ms, bound_by = k3_bound(persons, state0, persons.valid.any(dim=1))
    med = statistics.median(run_s)
    log("9 offline times", runs=len(run_s), frames=n, fusion_batch=pipe.fusion_batch,
        run_ms_median=med * 1e3, run_ms_min=min(run_s) * 1e3, run_ms_max=max(run_s) * 1e3,
        fused_fps_median=n / med, host_syncs_per_run=syncs,
        **{k: statistics.median(v) for k, v in laps.items()},
        k3_ms=k3_ms, k3_plain_ms=k3_plain, k3_bound_ms=bound_ms, k3_bound_by=bound_by)
    return {"tracker_scan": (k3_ms, k3_plain, bound_ms, bound_by)}


# --------------------------------------------------------------- phase 10 --

# The JAX demo's own configuration (demo.build_demo, the CLI's defaults):
# 16 cameras x 6 people, 128 frames, seed 42; D 6, H 12, T 12.
DEMO_CAMS, DEMO_PEOPLE, DEMO_SEED = 16, 6, 42
DEMO_DEVICE = "cuda"
DEMO_FRAMES = 128
DEMO_LOOP_FRAMES = 64
# The closed loop's injected latencies (the CLI's defaults), s.
LOOP_PROC_S, LOOP_NET_S = 0.05, 0.03
# Measured delays and horizons are float64 host sums of float32 stamps, the
# horizon a float32 mean of three of them.
LOOP_TOL_S = 1.0e-5
# Floats after a checkpoint round trip, and of the online loop's state
# against stepping its frames again.
RESUME_TOL = 1.0e-5
# Replayed keypoints against the scene's (the JSONL rounds them to 1e-4 px):
# the atol of the JAX package's test_replay.py.
REPLAY_TOL = 1.0e-3
# profile_stages' `full` against a direct timing of run_offline: the
# run-to-run spread PERF.md records for run_offline, medians 396-777 ms
# across calls on one tree (PR 4), a factor of 2.
PROFILE_FULL_RATIO = 2.0


def demo_main(argv):
    """demo.main on the card with the counts set to 0 just before; returns
    (DemoRun, (K1, K2, K3, L1, L2) launches of that run, wall seconds)."""
    from smartedgesensor3dhumanpose_tpu_torch import demo

    reset_counts()
    t0 = time.perf_counter()
    run = demo.main(["--cameras", str(DEMO_CAMS), "--people", str(DEMO_PEOPLE),
                     "--seed", str(DEMO_SEED), "--device", DEMO_DEVICE] + argv)
    torch.cuda.synchronize()
    return run, read_counts(), time.perf_counter() - t0


def compact(data: dict) -> dict:
    """Frames as a JSONL recording carries them: each camera's valid
    detections moved to the front slots in order, the rest zero."""
    out = {k: np.array(v) for k, v in data.items()}
    for k in ("kp2d", "cov2d", "det_score", "det_valid"):
        out[k] = np.zeros_like(out[k])
    t_n, c_n = data["det_valid"].shape[:2]
    for t in range(t_n):
        for c in range(c_n):
            ok = data["det_valid"][t, c]
            m = int(ok.sum())
            for k in ("kp2d", "cov2d", "det_score", "det_valid"):
                out[k][t, c, :m] = data[k][t, c][ok]
    return out


def decisions(out) -> dict:
    """The integer decisions of a run_offline StepOutput, on the host."""
    return {
        "raw_valid": out.persons_raw.valid, "fused_valid": out.fused.valid,
        "person_id": out.fused.person_id, "pred_valid": out.fused_pred.valid,
        "fb_kp_valid": out.feedback.kp_valid,
        "n_dropped_hyp": out.n_dropped_hypotheses,
        "n_dropped_spawns": out.n_dropped_track_spawns,
    }


def same_state(got, want, what: str) -> None:
    """Integers and masks equal, floats within RESUME_TOL (infinities equal)."""
    for name, a, b in zip(got._fields, got, want):
        if a.dtype.is_floating_point:
            both_inf = torch.isinf(a) & torch.isinf(b) & (torch.sign(a) == torch.sign(b))
            diff = torch.where(both_inf, 0.0, (a.double() - b.double()).abs())
            if torch.isnan(diff).any() or float(diff.max()) > RESUME_TOL:
                raise AssertionError(f"{what} {name}: off by {float(diff.max())} > {RESUME_TOL}")
        elif not torch.equal(a, b):
            raise AssertionError(f"{what} {name}: differs")


def sync_sets(messages, stamps_ns, prefer_native: bool):
    from smartedgesensor3dhumanpose_tpu_torch import sync

    s = sync.make_synchronizer(DEMO_CAMS, prefer_native=prefer_native)
    sets = []
    for i, (camera, _, _, _) in enumerate(messages):
        s.push(camera, stamps_ns[i], i + 1)
        while (got := s.pop()) is not None:
            sets.append(got)
    return sets


def phase_demo(dev):
    """The demo CLI on the card in every mode at build_demo(16, 6, ...), with
    the launch counts of each mode and the nine checks of the demo phase."""
    import tempfile

    from smartedgesensor3dhumanpose_tpu_torch import checkpoint, profiling, viz
    from smartedgesensor3dhumanpose_tpu_torch.io import replay, sensors, synthetic
    from smartedgesensor3dhumanpose_tpu_torch.ops import association
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    from smartedgesensor3dhumanpose_tpu_torch import sync

    t0 = time.perf_counter()
    runtime = sync.build()  # g++ on this machine, unless this source state was built here
    log("10.0 native runtime", library=runtime.name, seconds=time.perf_counter() - t0,
        compiler=repr(subprocess.run([sync.compiler(), "--version"], capture_output=True, text=True,
                                     check=True).stdout.splitlines()[0]))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "demo.jsonl")
        f_n = ["--frames", str(DEMO_FRAMES)]

        # 1. The offline demo with every output.
        run, counts, wall = demo_main(f_n + [
            "--eval", "--vis-cov", "--save", os.path.join(tmp, "out.npz"),
            "--checkpoint", os.path.join(tmp, "state.npz"), "--record-jsonl", rec])
        pipe, cfg, frames, outs = run.pipe, run.config, run.frames, run.outs
        chunks = -(-DEMO_FRAMES // pipe.fusion_batch)
        # Two run_offline calls, the first of which captures: the wrappers
        # count its warm-up and capture, the replays nothing.
        runs = FIRST_CALL_HOST_LAUNCHES
        if counts[:3] != (0, runs * chunks, runs):
            raise AssertionError(f"demo offline: launch counts {counts}, expected "
                                 f"(0, {runs * chunks}, {runs})")
        launches["demo_offline"] = counts
        if tuple(outs.fused.xyz.shape) != (DEMO_FRAMES, 2 * DEMO_PEOPLE, 21, 3):
            raise AssertionError(f"demo offline: fused shape {tuple(outs.fused.xyz.shape)}")
        pub = outs.fused.valid
        if not (torch.isfinite(outs.fused.xyz[pub]).all() and pub[-1].sum() == DEMO_PEOPLE):
            raise AssertionError("demo offline: non-finite joints or not everyone published")
        if not (run.mpjpe_m < 0.05 and run.pck_015 >= 0.95):
            raise AssertionError(f"demo offline: MPJPE {run.mpjpe_m} m, PCK@0.15 {run.pck_015}")
        saved = checkpoint.load_tracker_state(os.path.join(tmp, "state.npz"), device=dev)
        same_state(saved, run.final_state, "demo --checkpoint")
        log("10.1 demo offline", frames=DEMO_FRAMES, fusion_batch=pipe.fusion_batch,
            fused_fps=DEMO_FRAMES / run.seconds, run_ms=run.seconds * 1e3, wall_s=wall,
            mpjpe_mm=run.mpjpe_m * 1e3, pck_015=run.pck_015, launches=list(counts))

        # 2. K2 and K3 at the demo's shape (D 6, H 12, P = T = 12).
        f_cfg = cfg.fusion
        args = (f_cfg.max_hypotheses, f_cfg.max_epipolar_error, f_cfg.max_cost)
        for f in range(0, DEMO_FRAMES, 16):
            ctab, conf, dok = fold_case(at_frame(frames, f), pipe.rig, f_cfg)
            got = association.associate_fold(ctab, conf, dok, *args)
            torch.cuda.synchronize()
            want = association.associate_fold_reference(ctab, conf, dok, *args)
            for g, w, what in zip(got, want, ("det_slot", "n_hyp", "n_dropped")):
                if not torch.equal(g.cpu(), w.cpu()):
                    raise AssertionError(f"K2 demo shape frame {f} {what}: kernel != plain")
        persons, pivots, fb, pre = tracker_inputs(pipe, frames)
        k3_err, k3_drops, k3_merges, _ = check_k3("demo_build", pipe.init_state(), persons, pivots,
                                                 fb, pre, cfg.prior, cfg.tracker)
        log("10.2 demo shape K2 K3 vs plain", k2_frames=DEMO_FRAMES // 16, k2_max_abs_err=0,
            k2_plan=repr(association.fold_plan(DEMO_CAMS, f_cfg.max_dets_per_cam, f_cfg.max_hypotheses)),
            k3_frames=DEMO_FRAMES, k3_decisions="exact", k3_max_abs_err=k3_err,
            k3_dropped=k3_drops, k3_merged=k3_merges)

        # 3. --jsonl: the recording replayed through the native synchronizer.
        run_j, counts_j, _ = demo_main(f_n + ["--jsonl", rec])
        m = run_j.frames.kp2d.shape[0]
        scene_data = compact(synthetic.frames_from_scene(run.scene))
        want_frames = Frame.from_arrays({k: v[:m] for k, v in scene_data.items()}, dev)
        if m < DEMO_FRAMES - 3:
            raise AssertionError(f"--jsonl: {m} of {DEMO_FRAMES} frames replayed")
        for name, g, w in zip(Frame._fields, run_j.frames, want_frames):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"--jsonl {name}: {g.shape} {g.dtype} != {w.shape} {w.dtype}")
            if g.dtype == torch.bool:
                if not torch.equal(g, w):
                    raise AssertionError(f"--jsonl {name}: differs from the scene's")
            elif float((g - w).abs().max()) > REPLAY_TOL:
                raise AssertionError(f"--jsonl {name}: off by {float((g - w).abs().max())}")
        _, want_outs = pipe.run_offline(pipe.init_state(), want_frames)
        got_d, want_d = decisions(run_j.outs), decisions(want_outs)
        bad = [k for k in got_d if not torch.equal(got_d[k], want_d[k])]
        if bad:
            raise AssertionError(f"--jsonl: run_offline decisions differ from the scene's: {bad}")
        log("10.3 demo jsonl", frames_replayed=m, frames_recorded=DEMO_FRAMES,
            floats_within=REPLAY_TOL, decisions="exact", launches=list(counts_j))

        # 4. The native synchronizer against its Python mirror on the
        # recorded messages, and with camera 0 silent for the second
        # quarter of the frames (its queues overflow).
        messages = list(replay.load_jsonl_messages(rec))
        cases = {"recorded": messages}
        t_lo, t_hi = DEMO_FRAMES / 4 / 30.0, DEMO_FRAMES / 2 / 30.0
        cases["stalled"] = [mg for mg in messages if not (mg[0] == 0 and t_lo <= mg[1] <= t_hi)]
        n_sets = {}
        for name, msgs in cases.items():
            ns = [int(round(mg[1] * 1e9)) for mg in msgs]
            native, mirror = sync_sets(msgs, ns, True), sync_sets(msgs, ns, False)
            if native != mirror:
                raise AssertionError(f"native sync != Python mirror on the {name} messages")
            n_sets[name] = len(native)
        if not n_sets["recorded"] >= DEMO_FRAMES - 3 or n_sets["stalled"] >= n_sets["recorded"]:
            raise AssertionError(f"sync sets {n_sets}")
        log("10.4 native sync vs mirror", messages=len(messages), sets="'" + json.dumps(n_sets) + "'",
            equal=True)

        # 5. --online at 30 Hz over 64 frames; then the processed frames
        # stepped again from the same initial state (a plain step loop).
        loop_n = ["--frames", str(DEMO_LOOP_FRAMES)]
        run_o, counts_o, _ = demo_main(loop_n + ["--online", "--feed-hz", "30"])
        rep = run_o.report
        h = rep.processed_handles
        if rep.dropped + len(h) != rep.produced or rep.produced != DEMO_LOOP_FRAMES:
            raise AssertionError(f"--online accounting: {rep.dropped} + {len(h)} != {rep.produced}")
        if not all(a < b for a, b in zip(h, h[1:])) or h[-1] != DEMO_LOOP_FRAMES - 1:
            raise AssertionError(f"--online handles {h}")
        # The demo's warm-up step captures (the wrappers count its warm-up
        # and capture); the loop's steps are replays.
        if counts_o[:3] != (FIRST_CALL_HOST_LAUNCHES,) * 2 + (0,):
            raise AssertionError(f"--online launch counts {counts_o} for {len(h)} replays + capture")
        launches["demo_online"] = counts_o
        state = run_o.pipe.init_state()
        plain_ms = []
        for i in h:
            t0 = time.perf_counter()
            state, _ = run_o.pipe.step(state, at_frame(run_o.frames, i))
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
        same_state(state, run_o.final_state, "--online replayed")
        plain_p50 = statistics.median(plain_ms)
        log("10.5 demo online", frames=DEMO_LOOP_FRAMES, feed_hz=30, processed=len(h),
            dropped=rep.dropped, dropped_share=rep.dropped / rep.produced,
            step_ms_p50=rep.step_ms_p50, step_ms_p90=float(np.percentile(rep.step_ms, 90)), plain_step_ms_p50=plain_p50,
            replay_state="equal", launches=list(counts_o))

        # 6. --online --jsonl: messages -> native sync -> native slot -> step.
        run_s, counts_s, _ = demo_main(loop_n + ["--online", "--jsonl", rec])
        rep = run_s.report
        if rep.processed_frames + rep.slot_dropped != rep.frames_synced:
            raise AssertionError(f"--online --jsonl accounting: {rep}")
        if rep.messages_unconsumed != rep.produced_messages - rep.frames_synced * DEMO_CAMS:
            raise AssertionError(f"--online --jsonl unconsumed: {rep.messages_unconsumed}")
        if counts_s[:3] != (FIRST_CALL_HOST_LAUNCHES,) * 2 + (0,):
            raise AssertionError(f"--online --jsonl launch counts {counts_s}")
        launches["demo_online_synced"] = counts_s
        log("10.6 demo online synced", messages=rep.produced_messages, synced=rep.frames_synced,
            unconsumed=rep.messages_unconsumed, processed=rep.processed_frames,
            slot_dropped=rep.slot_dropped, step_ms_p50=rep.step_ms_p50, e2e_ms_p50=rep.e2e_ms_p50,
            plain_step_ms_p50=plain_p50, step_over_plain=rep.step_ms_p50 / plain_p50,
            launches=list(counts_s))

        # 7. --closed-loop over 64 frames; the exact convergence on the same
        # shape with jitter-free stamps (with jitter every camera measures
        # the latency plus its lag behind the pivot).
        run_c, counts_c, _ = demo_main(loop_n + ["--closed-loop"])
        rep = run_c.report
        if counts_c[:3] != (FIRST_CALL_HOST_LAUNCHES,) * 2 + (0,):
            raise AssertionError(f"--closed-loop launch counts {counts_c}")
        launches["demo_closed_loop"] = counts_c
        loop_s = LOOP_PROC_S + LOOP_NET_S
        if rep.n_feedback_received != DEMO_LOOP_FRAMES or not (
                rep.fb_delay_measured[-1] >= loop_s - LOOP_TOL_S).all():
            raise AssertionError(f"--closed-loop: {rep.n_feedback_received} deliveries, "
                                 f"last delays {rep.fb_delay_measured[-1]}")
        exact = synthetic.generate_scene(synthetic.SceneConfig(
            num_cameras=DEMO_CAMS, num_people=DEMO_PEOPLE, num_frames=DEMO_LOOP_FRAMES,
            seed=DEMO_SEED, stamp_jitter=0.0))
        ex_frames = Frame.from_arrays(synthetic.frames_from_scene(exact), dev)
        sens = sensors.VirtualSensorArray(DEMO_CAMS, network_latency=LOOP_NET_S)
        _, _, ex = sensors.run_closed_loop(run_c.pipe.step, run_c.pipe.init_state(), ex_frames,
                                           sens, processing_latency=LOOP_PROC_S)
        first = int(np.argmax(ex.fb_delay_measured[:, 0] > 0))
        settle = first + cfg.tracker.n_mov_avg
        last_err = float(np.abs(ex.fb_delay_measured[-1] - loop_s).max())
        pred_err = float(np.abs(ex.pred_delta_t[settle:] - loop_s).max())
        if ex.n_feedback_received != DEMO_LOOP_FRAMES or last_err > LOOP_TOL_S or pred_err > LOOP_TOL_S:
            raise AssertionError(f"closed loop: deliveries {ex.n_feedback_received}, last delay "
                                 f"off by {last_err}, horizon off by {pred_err} after frame {settle}")
        log("10.7 demo closed loop", frames=DEMO_LOOP_FRAMES, ms_per_frame=run_c.seconds * 1e3 / DEMO_LOOP_FRAMES,
            pred_delta_t_last_ms=rep.pred_delta_t[-1] * 1e3, exact_settled_from=settle,
            exact_last_delay_err_s=last_err, exact_horizon_err_s=pred_err, launches=list(counts_c))

        # 8. Checkpoint resume: run_offline over the first half, save, load,
        # the second half from the loaded state against from the kept one.
        half = DEMO_FRAMES // 2
        first_half = Frame(*(x[:half] for x in frames))
        second_half = Frame(*(x[half:] for x in frames))
        mid, _ = pipe.run_offline(pipe.init_state(), first_half)
        path = os.path.join(tmp, "mid.npz")
        checkpoint.save_tracker_state(path, mid)
        loaded = checkpoint.load_tracker_state(path, device=dev)
        same_state(loaded, mid, "checkpoint round trip")
        end_a, out_a = pipe.run_offline(loaded, second_half)
        end_b, out_b = pipe.run_offline(mid, second_half)
        same_state(end_a, end_b, "resumed final state")
        da, db = decisions(out_a), decisions(out_b)
        bad = [k for k in da if not torch.equal(da[k], db[k])]
        diff = float((out_a.fused.xyz - out_b.fused.xyz).abs().max())
        if bad or diff > RESUME_TOL:
            raise AssertionError(f"resumed second half: decisions {bad}, joints off by {diff}")
        log("10.8 checkpoint resume", frames=f"{half}+{DEMO_FRAMES - half}", decisions="exact",
            max_abs_err=diff, published_after=int(out_a.fused.valid[-1].sum()))

        # 9. profile_stages (a captured graph per stage) on the demo scene
        # against run_offline timed directly.
        stages = profiling.profile_stages(pipe, frames, reps=3)
        direct = []
        for _ in range(3):
            state0 = pipe.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run_offline(state0, frames)
            torch.cuda.synchronize()
            direct.append((time.perf_counter() - t0) * 1e3 / DEMO_FRAMES)
        direct_ms = statistics.median(direct)
        ratio = stages["full"] / direct_ms
        if not 1 / PROFILE_FULL_RATIO <= ratio <= PROFILE_FULL_RATIO:
            raise AssertionError(f"profile_stages full {stages['full']} ms/frame vs direct {direct_ms}")
        log("10.9 profile_stages", unit="ms/frame", captured="fuse,smooth_cold,tracker,reproj,full",
            **stages, stage_sum=sum(v for k, v in stages.items() if k != "full"),
            direct_run_offline=direct_ms, full_over_direct=ratio)

        # --viz / --live on this machine: matplotlib or a clear ImportError.
        try:
            viz.require_matplotlib()
            viz_state = "matplotlib present"
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise
            try:
                demo_main(["--frames", "2", "--viz", os.path.join(tmp, "x.png")])
            except ImportError as e2:
                if "matplotlib" not in str(e2):
                    raise
                viz_state = "ImportError names matplotlib"
            else:
                raise AssertionError("--viz ran without matplotlib")
        log("10 demo", viz=repr(viz_state))
    return launches, k3_err


# --------------------------------------------------------------- phase 11 --

# The end-to-end slice at full width: DetectorConfig()'s defaults (480x640,
# width 128, stride 8, 17 joints, D 6, bfloat16 compute) on the demo's rig and
# config (build_demo(16, 6, ...): D 6, H 12, T 12), random weights from this
# seed; 5 warm-up steps, then E2E_TIMED timed ones.
E2E_SEED = 0
E2E_WARM, E2E_TIMED = 5, 25
# Images the card's heatmaps are held to the CPU port's on.
E2E_COMPARE_IMAGES = 2
# Heatmaps of the same weights and images, card against CPU, in float32
# (IEEE, TF32 off) and in bfloat16 compute. This random full-width network
# is sensitive to rounding: the CPU port's float32 heatmaps lie up to
# 4.1e-4 (mean 5.0e-6) from a float64 evaluation of the same weights and
# images, its bfloat16 ones up to 1.6e-2 (mean 2.9e-4), since a bfloat16
# rounding that lands the other way in one stage grows through the next
# three (this phase prints them). Card and CPU round at other places, so
# each may be that far from float64 in another direction: on an H100 they
# came out 4.1e-4 (float32) and 9.4e-3 (bfloat16) apart.
# Besides, the card's mean distance from float64 must stay within
# E2E_HEAT_MEAN_RATIO of the CPU's: the card computes the detector as
# accurately as the CPU port does.
E2E_HEAT_TOL = {"float32": 1.0e-3, "bfloat16": 4.0e-2}
E2E_HEAT_MEAN_RATIO = 2.0
# Decoded floats on identical heatmaps (same code, sums in another order):
# positions in px, covariances relative (px^2).
E2E_POS_TOL_PX = 1.0e-4
E2E_COV_RTOL = 1.0e-5
# The accuracy check of the JAX package's tests/test_models.py: its
# detector, its scene and its thresholds.
E2E_TRAIN_DETECTOR = dict(image_size=(96, 128), heatmap_stride=4, width=32, max_detections=3,
                          nms_radius=4, joint_radius=9, window=7, min_peak_score=0.15,
                          seed_joints=(11, 12))
E2E_TRAIN_STEPS = 300
E2E_TRAIN_FRAMES = 4
E2E_MAX_LOSS, E2E_MEAN_M, E2E_MAX_M = 5.0e-3, 0.05, 0.08
E2E_TRAIN_LR = 2e-3
# The full-width detector (DetectorConfig()) trained on build_demo(16, 6,
# ...)'s frames: steps of each run, cameras per batch.
E2E_FULL_TRAIN_STEPS = 20
E2E_FULL_TRAIN_CAMS = 4
# Rounds of the steady training loop timed per step, eager and captured in
# turns (each round TRAIN_TIMED_STEPS steps, a sync at its end).
TRAIN_TIMED_ROUNDS = 2
TRAIN_TIMED_STEPS = 50


def match_to_gt(xyz, score, valid, gt, to_fusion, max_dist=0.5):
    """Greedy-match fused persons to ground truth (the JAX package's
    tests/test_fusion.py helper): per GT person the mean joint error of its
    best unused match, inf when none lies within max_dist."""
    errs, used = [], set()
    for g in range(gt.shape[0]):
        best, best_p = np.inf, None
        for p in np.nonzero(valid)[0]:
            ok = score[p][to_fusion] > 0
            if p in used or ok.sum() < 5:
                continue
            e = np.linalg.norm(xyz[p][to_fusion][ok] - gt[g][ok], axis=-1).mean()
            if e < best:
                best, best_p = e, p
        if best_p is not None and best < max_dist:
            used.add(best_p)
            errs.append(best)
        else:
            errs.append(np.inf)
    return np.array(errs)


def rendered(frames, t: int, image_size):
    """The scene's frame t drawn as the synthetic camera images."""
    from smartedgesensor3dhumanpose_tpu_torch.models import train

    kp = frames.kp2d[t]
    ok = frames.det_valid[t][..., None] & (kp[..., 2] > 0)
    return train.render_images(kp[..., :2], ok, image_size)


def timed_steps(step_fn, state, inputs):
    """Wall ms of each call of step_fn(state, *inputs[t]), a device sync
    after each; returns (state, outputs, ms)."""
    outs, ms = [], []
    for args in inputs:
        t0 = time.perf_counter()
        state, out = step_fn(state, *args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return state, outs, ms


def compare_decode(heat, det_cfg) -> float:
    """decode_heatmaps on the card against the CPU on the same heatmaps:
    seeds, claimed cells, scores and validity equal, floats within the
    E2E tolerances; returns the largest position difference (px)."""
    from smartedgesensor3dhumanpose_tpu_torch.models import keypoint_cnn

    peaks = [keypoint_cnn.find_peaks(h, det_cfg) for h in (heat, heat.cpu())]
    for name, g, w in zip(keypoint_cnn.Peaks._fields, *peaks):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"decode {name}: card != CPU on identical heatmaps")
    got = [x.cpu() for x in keypoint_cnn.decode_heatmaps(heat, det_cfg)]
    want = keypoint_cnn.decode_heatmaps(heat.cpu(), det_cfg)
    for name, g, w in zip(("kp2d", "cov2d", "det_score", "det_valid"), got, want):
        if g.dtype == torch.bool or name == "det_score":
            same = torch.equal(g, w)
        elif name == "kp2d":
            same = torch.equal(g[..., 2], w[..., 2]) and bool(
                (g[..., :2] - w[..., :2]).abs().max() <= E2E_POS_TOL_PX)
        else:
            same = bool(((g - w).abs() <= E2E_COV_RTOL * w.abs() + E2E_POS_TOL_PX).all())
        if not same:
            raise AssertionError(f"decode {name}: card != CPU on identical heatmaps")
    return float((got[0][..., :2] - want[0][..., :2]).abs().max())


@contextlib.contextmanager
def eager_training():
    """train_detector on the card with its step run op by op (the step
    function itself instead of its CUDA graph), for comparison."""
    from smartedgesensor3dhumanpose_tpu_torch import graphs

    captured = graphs.CapturedFunction
    graphs.CapturedFunction = lambda fn, name: fn
    try:
        yield
    finally:
        graphs.CapturedFunction = captured


def training_fields(runs: dict, loop: dict) -> dict:
    """The log fields of train_runs' and train_loop_times' results."""
    r = runs["runs"]
    return dict(
        captured_vs_eager_params_max_abs_diff=runs["diff"],
        eager_vs_eager_params_max_abs_diff=runs["spread"],
        final_loss_eager=r["eager"][1], final_loss_captured=r["captured"][1],
        run_ms_per_step_eager=r["eager"][2], run_ms_per_step_captured=r["captured"][2],
        peak_mib_eager=r["eager"][3], peak_mib_captured=r["captured"][3],
        loop_ms_per_step_eager=loop["loop_ms"]["eager"],
        loop_ms_per_step_captured=loop["loop_ms"]["captured"],
        loop_ms_rounds="'" + json.dumps(loop["loop_ms_all"]) + "'",
        step_only_ms_eager=loop["step_ms"]["eager"],
        step_only_ms_captured=loop["step_ms"]["captured"],
        host_syncs_per_captured_step=loop["syncs_step"],
        host_syncs_per_captured_iteration=loop["syncs_iteration"],
        graph_nodes=nodes_str(loop["nodes"]))


def params_diff(a, b) -> float:
    """Largest absolute difference of two models' parameters."""
    return max(float((p - q).abs().max())
               for p, q in zip(a.state_dict().values(), b.state_dict().values()))


def train_runs(det_cfg, data, steps: int, batch_cams: int, dev) -> dict:
    """train_detector on the card over the same draws: eagerly twice (the
    eager step against itself) and captured (its default). Each run's
    (model, final loss, wall ms per step with its first call, peak MiB);
    the captured model must equal the eager one bit for bit where the
    eager runs agree bit for bit, else differ by no more than they do.
    Peak MiB: the most allocated during the run over what was allocated
    before it."""
    from smartedgesensor3dhumanpose_tpu_torch.models import train

    runs = {}
    for name in ("eager", "eager_again", "captured"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with eager_training() if name.startswith("eager") else contextlib.nullcontext():
            model, loss = train.train_detector(det_cfg, data, steps=steps, batch_cams=batch_cams,
                                               lr=E2E_TRAIN_LR, seed=0, device=dev)
        torch.cuda.synchronize()
        runs[name] = (model, loss, (time.perf_counter() - t0) / steps * 1e3,
                      (torch.cuda.max_memory_allocated(dev) - base) / 2**20)
    spread = params_diff(runs["eager"][0], runs["eager_again"][0])
    diff = params_diff(runs["captured"][0], runs["eager"][0])
    if not all(np.isfinite(r[1]) for r in runs.values()):
        raise AssertionError(f"training: non-finite loss {[r[1] for r in runs.values()]}")
    if diff > spread:
        raise AssertionError(f"training: captured differs from eager by {diff}, the eager "
                             f"runs from each other by {spread}")
    return {"runs": runs, "spread": spread, "diff": diff}


def train_loop_times(det_cfg, data, batch_cams: int, dev) -> dict:
    """The steady training loop (each step's batch rendered, then the step)
    with the eager and the captured step, in turns, ms per step; the step
    alone (CUDA events); host syncs of one captured step and of one whole
    iteration; the captured step's graph nodes."""
    from smartedgesensor3dhumanpose_tpu_torch import graphs
    from smartedgesensor3dhumanpose_tpu_torch.models import keypoint_cnn, train

    model = keypoint_cnn.init_detector(det_cfg, torch.Generator().manual_seed(0), dev)
    eager = train.make_train_step(model, E2E_TRAIN_LR)
    steps = {"eager": eager, "captured": graphs.CapturedFunction(eager, "train_step")}
    num_frames, num_cams = data["kp2d"].shape[:2]
    draws = torch.as_tensor(train.training_draws(num_frames, num_cams, TRAIN_TIMED_STEPS,
                                                 batch_cams, 1), device=dev)
    kp_all = torch.as_tensor(data["kp2d"], device=dev).flatten(0, 1)
    valid_all = torch.as_tensor(data["det_valid"], device=dev).flatten(0, 1)
    noise = torch.Generator(device=dev).manual_seed(1)

    def batch(it):
        return train._batch(kp_all.index_select(0, draws[it]),
                            valid_all.index_select(0, draws[it]), det_cfg, noise)

    def loop(step):
        params = train.initial_params(model)
        state = train.adam_init(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(TRAIN_TIMED_STEPS):
            params, state, _ = step(params, state, *batch(it))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TRAIN_TIMED_STEPS * 1e3

    params = train.initial_params(model)
    state = train.adam_init(params)
    images, targets = batch(0)
    steps["captured"](params, state, images, targets)  # the capture
    ms = {k: [] for k in steps}
    for _ in range(TRAIN_TIMED_ROUNDS):
        for name in ("eager", "captured", "captured", "eager"):
            ms[name].append(loop(steps[name]))
    step_ms = {k: sync_time(lambda f=f: f(params, state, images, targets), 20)
               for k, f in steps.items()}
    syncs_step = count_syncs(lambda: steps["captured"](params, state, images, targets))
    syncs_iteration = count_syncs(lambda: steps["captured"](params, state, *batch(1)))
    if syncs_step or syncs_iteration:
        raise AssertionError(f"captured training: {syncs_step} host syncs per step, "
                             f"{syncs_iteration} per iteration with its batch")
    nodes = graph_nodes(eager, params, state, images, targets)
    return {"loop_ms": {k: statistics.median(v) for k, v in ms.items()},
            "loop_ms_all": ms, "step_ms": step_ms, "syncs_step": syncs_step,
            "syncs_iteration": syncs_iteration, "nodes": nodes}


def phase_end_to_end(dev, smi: str):
    """The end-to-end slice (images -> detector -> Pipeline.step): the
    full-width detector on the demo's 16 cameras with its launch counts,
    its heatmaps and decoding against the CPU port, its times; then the
    trained detector's accuracy on the JAX test's scene."""
    from smartedgesensor3dhumanpose_tpu_torch import cameras, demo, skeleton
    from smartedgesensor3dhumanpose_tpu_torch.config import (
        FusionConfig,
        PipelineConfig,
        TrackerConfig,
    )
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
    from smartedgesensor3dhumanpose_tpu_torch.models import end_to_end, keypoint_cnn, train
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    # 1. Full width on the demo's 16 cameras, random weights.
    det_cfg = keypoint_cnn.DetectorConfig()
    n_frames = E2E_WARM + E2E_TIMED
    scene16, cfg, frames, pipe = demo.build_demo(DEMO_CAMS, DEMO_PEOPLE, n_frames, DEMO_SEED,
                                                 device=dev)
    scene16 = synthetic.frames_from_scene(scene16)
    step, model, state = end_to_end.make_end_to_end(
        pipe.rig, cfg, det_cfg, torch.Generator().manual_seed(E2E_SEED), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    images = [rendered(frames, t, det_cfg.image_size) for t in range(n_frames)]
    inputs = [(images[t], frames.cam_stamp[t]) for t in range(n_frames)]
    reset_counts()
    state, outs, e2e_ms = timed_steps(step, state, inputs)
    counts = counts_e2e = read_counts()
    # The step is a CUDA graph: the wrappers count its first call's warm-up
    # and capture, the replays nothing (phase 13.4 counts theirs on the device).
    if counts[:3] != (FIRST_CALL_HOST_LAUNCHES,) * 2 + (0,):
        raise AssertionError(f"end to end: launch counts {counts}, expected "
                             f"{FIRST_CALL_HOST_LAUNCHES} (warm-up and capture)")
    for t, out in enumerate(outs):
        if not all(bool(torch.isfinite(x).all()) for x in (
                out.persons_raw.xyz, out.fused.xyz, out.fused_pred.xyz, out.feedback.kp2d)):
            raise AssertionError(f"end to end: non-finite output at step {t}")
    raw_persons = [int(out.persons_raw.valid.sum()) for out in outs]
    # Pipeline.step alone on the very detections the end-to-end steps
    # decoded (their step without the detector), and on the scene's frames.
    det_frames = [(end_to_end.detection_frame(*inputs[t], model, det_cfg),) for t in range(n_frames)]
    _, _, det_pipe_ms = timed_steps(pipe.step, pipe.init_state(), det_frames)
    scene_frames = [(at_frame(frames, t),) for t in range(n_frames)]
    _, _, scene_pipe_ms = timed_steps(pipe.step, pipe.init_state(), scene_frames)
    e2e_q = statistics.quantiles(e2e_ms[E2E_WARM:], n=10)
    log("11.1 end to end full width", gpu=repr(smi), cams=DEMO_CAMS,
        image="x".join(map(str, det_cfg.image_size)), width=det_cfg.width,
        stride=det_cfg.heatmap_stride, params=n_params, steps=n_frames, finite=True,
        launches=list(counts), raw_persons_per_step=statistics.mean(raw_persons),
        step_ms_p50=statistics.median(e2e_ms[E2E_WARM:]), step_ms_p90=e2e_q[-1],
        pipeline_step_same_detections_ms_p50=statistics.median(det_pipe_ms[E2E_WARM:]),
        pipeline_step_scene_frames_ms_p50=statistics.median(scene_pipe_ms[E2E_WARM:]))

    # 2. The card's heatmaps against the CPU port's and a float64 evaluation
    # of the same weights and images; its decoding against the CPU's.
    few = images[0][:E2E_COMPARE_IMAGES]

    def heatmaps(compute, device):
        m = keypoint_cnn.init_detector(dataclasses.replace(det_cfg, compute_dtype=compute),
                                       device=device)
        m.load_state_dict(model.state_dict())
        with torch.no_grad():
            return m(few.to(device)).cpu().double()

    def dist(a, b):
        d = (a - b).abs()
        return float(d.max()), float(d.mean())

    exact = heatmaps(torch.float64, "cpu")
    heat_err = {}
    for name, compute in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        card, cpu = heatmaps(compute, dev), heatmaps(compute, "cpu")
        heat_err[name] = {"card_vs_cpu": dist(card, cpu), "card_vs_f64": dist(card, exact),
                          "cpu_vs_f64": dist(cpu, exact)}
        e = heat_err[name]
        if not (e["card_vs_cpu"][0] <= E2E_HEAT_TOL[name]
                and e["card_vs_f64"][1] <= E2E_HEAT_MEAN_RATIO * e["cpu_vs_f64"][1]):
            raise AssertionError(f"{name} heatmaps (max, mean): {e}")
    with torch.no_grad():
        heat = model(images[0])
    pos_err = compare_decode(heat, det_cfg)
    valid = keypoint_cnn.decode_heatmaps(heat, det_cfg)[3]
    log("11.2 detector card vs CPU", images=E2E_COMPARE_IMAGES,
        heat_max_mean_abs_err="'" + json.dumps(heat_err) + "'",
        heat_tol="'" + json.dumps(E2E_HEAT_TOL) + "'", mean_ratio_tol=E2E_HEAT_MEAN_RATIO,
        decode_images=DEMO_CAMS,
        decode_integers="exact", decode_pos_max_abs_err_px=pos_err,
        valid_detections=int(valid.sum()))

    # 3. Detector and decode times at full width (16 x 480 x 640), and the
    # forward's device time by kernel.
    with torch.no_grad():
        fwd_ms = sync_time(lambda: model(images[0]), 20)
        dec_ms = sync_time(lambda: keypoint_cnn.decode_heatmaps(heat, det_cfg), 20)
        det_ms = sync_time(lambda: keypoint_cnn.detect(model, images[0], det_cfg), 20)
        by_kernel = device_ms_by_kernel(lambda: model(images[0]), 5)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    log("11.3 detector times", gpu=repr(smi), images=DEMO_CAMS, forward_ms=fwd_ms,
        decode_ms=dec_ms, detect_ms=det_ms, forward_gflop=2 * conv_macs(det_cfg) * DEMO_CAMS / 1e9,
        forward_device_ms=sum(by_kernel.values()),
        top_kernels_ms="'" + json.dumps({k[:60]: round(v, 4) for k, v in top}) + "'")
    del images, inputs, outs, heat, det_frames

    # 4. Training on the card, eager and captured over the same draws: the
    # JAX test's detector on its scene (tests/test_models.py), then the
    # full-width detector on the demo's frames; then the trained detector's
    # accuracy through the end-to-end step.
    t_cfg = keypoint_cnn.DetectorConfig(**E2E_TRAIN_DETECTOR)
    cams, people = 6, 2
    P = cameras.ring_extrinsics(cams, radius=2.2, heights=(3.4, 4.0, 4.6), look_at_z=0.8)
    K = np.tile(np.asarray((100.0, 100.0, 64.0, 48.0)), (cams, 1))
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(num_cameras=cams, num_people=people, num_frames=10,
                              pixel_noise=0.0, keypoint_dropout=0.0, detection_dropout=0.0,
                              area=(3.4, 3.4), seed=19),
        rig=cameras.build_rig(P, K, (128, 96), dtype=torch.float64, device="cpu"),
    )
    data = synthetic.frames_from_scene(scene)
    reset_counts()
    small = train_runs(t_cfg, data, E2E_TRAIN_STEPS, 3, dev)
    trained, loss = small["runs"]["captured"][:2]
    small_loop = train_loop_times(t_cfg, data, 3, dev)
    log("11.4a training", gpu=repr(smi), detector="test", steps=E2E_TRAIN_STEPS, batch=3,
        params=sum(p.numel() for p in trained.parameters()),
        **training_fields(small, small_loop))
    full = train_runs(det_cfg, scene16, E2E_FULL_TRAIN_STEPS, E2E_FULL_TRAIN_CAMS, dev)
    full_loop = train_loop_times(det_cfg, scene16, E2E_FULL_TRAIN_CAMS, dev)
    log("11.4b training full width", gpu=repr(smi), detector="DetectorConfig()",
        steps=E2E_FULL_TRAIN_STEPS, batch=E2E_FULL_TRAIN_CAMS, params=n_params,
        **training_fields(full, full_loop))
    del full, full_loop
    t_pipe_cfg = PipelineConfig(
        fusion=FusionConfig(num_cameras=cams, max_dets_per_cam=3, max_hypotheses=6),
        tracker=TrackerConfig(max_tracks=6),
    )
    step2, model2, state = end_to_end.make_end_to_end(
        cameras.build_rig(P, K, (128, 96), device=dev), t_pipe_cfg, t_cfg, device=dev)
    model2.load_state_dict(trained.state_dict())
    t_frames = Frame.from_arrays(data, dev)
    to_fusion = np.asarray(skeleton.SIMPLE_MODEL.to_fusion)
    errs = []
    for t in range(E2E_TRAIN_FRAMES):
        state, out = step2(state, rendered(t_frames, t, t_cfg.image_size), t_frames.cam_stamp[t])
        raw = out.persons_raw
        errs.append(match_to_gt(raw.xyz.cpu().numpy(), raw.score.cpu().numpy(),
                                raw.valid.cpu().numpy(), scene["gt_xyz"][t], to_fusion))
    # The counts since training began: training launches none of K1-K3,
    # the trained end-to-end step's first call K1 and K2 twice each.
    counts = read_counts()
    errs = np.concatenate(errs)
    if counts[:3] != (FIRST_CALL_HOST_LAUNCHES,) * 2 + (0,):
        raise AssertionError(f"training, then the trained end to end: launch counts {counts}")
    if not loss < E2E_MAX_LOSS:
        raise AssertionError(f"trained detector: final loss {loss} >= {E2E_MAX_LOSS}")
    if not (np.isfinite(errs).all() and errs.shape[0] == E2E_TRAIN_FRAMES * people):
        raise AssertionError(f"trained end to end: not every person recovered: {errs}")
    if not (errs.mean() < E2E_MEAN_M and errs.max() < E2E_MAX_M):
        raise AssertionError(f"trained end to end: joint errors {errs} m")
    log("11.4 trained end to end", gpu=repr(smi), train_steps=E2E_TRAIN_STEPS,
        final_loss=loss, frames=E2E_TRAIN_FRAMES, persons_recovered=f"{int(np.isfinite(errs).sum())}/{errs.shape[0]}",
        mean_err_mm=errs.mean() * 1e3, max_err_mm=errs.max() * 1e3, launches=list(counts))
    trained = (model2, t_cfg, t_pipe_cfg, cameras.build_rig(P, K, (128, 96), device=dev),
               [(rendered(t_frames, t, t_cfg.image_size), t_frames.cam_stamp[t])
                for t in range(E2E_TRAIN_FRAMES)])
    return {"end_to_end": counts_e2e, "train_then_end_to_end": counts}, trained


def device_ms_by_kernel(fn, reps: int) -> dict:
    """Device ms per call of `fn` by kernel name, from a torch.profiler
    trace of `reps` calls."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def conv_macs(det_cfg) -> int:
    """Multiply-adds of one image through the detector's convolutions."""
    from smartedgesensor3dhumanpose_tpu_torch.models import keypoint_cnn

    h, w = det_cfg.image_size
    macs = 0
    for c_in, c_out, stride in keypoint_cnn.stage_plan(det_cfg):
        h, w = -(-h // stride), -(-w // stride)
        macs += h * w * c_out * c_in * 9
    return macs + h * w * c_out * det_cfg.num_joints


# --------------------------------------------------------------- phase 12 --

# The sharded replay's meshes of virtual entries on one card: (data, model).
VIRTUAL_MESHES = ((2, 2), (4, 1))
# The virtual mesh whose entries' replays at once are held to the same
# replays one at a time.
CONCURRENT_MESH = (4, 1)
# Entries of the sharded fusion's model axis on one card (phase 8's frame).
FUSION_ENTRIES = 4
# Warm calls timed, in turns: the captured paths and run_offline in every
# one of SHARDED_TIMED rounds, the eager sharded paths in the first
# EAGER_SHARDED_TIMED.
SHARDED_TIMED = 5
EAGER_SHARDED_TIMED = 2


def to_device(tree, dev):
    """A tensor, or a (named) tuple of them nested, on `dev`; other leaves
    (PriorResult.iters) as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple):
        values = [to_device(x, dev) for x in tree]
        return type(tree)(*values) if hasattr(tree, "_fields") else tuple(values)
    return tree


def sharded_k2_launches(n: int, data: int) -> int:
    """K2 launches of run_offline_sharded over n frames: one per fusion
    chunk of each data shard (torch.tensor_split's shard sizes)."""
    sizes = [len(s) for s in torch.tensor_split(torch.arange(n), data)]
    return sum(-(-size // OFFLINE_FUSION_BATCH) for size in sizes)


@contextlib.contextmanager
def eager_sharded():
    """The sharded paths run eagerly on the card, for comparison: each
    shard's stages dispatched op by op on its stream, the LM testing its
    loop on the host."""
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding

    captured = sharding._captured
    sharding._captured = lambda stage, device, k: stage.body
    try:
        yield
    finally:
        sharding._captured = captured


def eagerly(fn):
    """`fn` with the sharded paths eager (eager_sharded)."""
    def run():
        with eager_sharded():
            return fn()
    return run


@contextlib.contextmanager
def one_stream_per_device():
    """Every entry of a device on that device's first shard stream, so that
    the entries' replays run one at a time, in job order."""
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding

    stream = sharding._stream
    sharding._stream = lambda device, k: stream(device, 0)
    try:
        yield
    finally:
        sharding._stream = stream


def fresh_sharded_graphs() -> None:
    """Drop every graph the sharded paths keep, so that the next call
    captures anew."""
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding

    sharding._GRAPHS.clear()
    torch.cuda.synchronize()


def sharded_graph_cost() -> dict:
    """The captured functions and graphs the sharded paths keep, and the
    MiB of their loops' body pools (ops/loops.py: one per graph)."""
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding

    kept = [g for f in sharding._GRAPHS.values() for g in f.graphs.values()]
    return {"functions": len(sharding._GRAPHS), "graphs": len(kept),
            "body_pools_mib": pools_mib(g.bodies.pool.id for g in kept)}


def pools_mib(pool_ids) -> float:
    """MiB of the caching allocator's segments in these memory pools."""
    ids = {tuple(p) for p in pool_ids}
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) in ids) / 2**20


def overlap_share(spans) -> float:
    """1 - (the length of the union of the [start, end) spans) / (the sum
    of their lengths): 0 when no two overlap."""
    total = sum(b - a for a, b in spans)
    union, reach = 0, None
    for a, b in sorted(spans):
        if reach is None or a >= reach:
            union += b - a
            reach = b
        elif b > reach:
            union += b - reach
            reach = b
    return 1.0 - union / total if total else 0.0


def lm_spans(log) -> list:
    """Each loop's [start, end) on the device clock (ns) in its last
    replay, from the trip log."""
    torch.cuda.synchronize()
    return [(int(stamps[0]), int(stamps[int(trips)])) for trips, stamps in log]


def check_sharded_replay(label, mesh, rig, cfg, golden, inputs, unsharded):
    """run_offline_sharded over both golden scenes on `mesh`, every graph
    captured anew by the first call (benign) with the loops' trip log on
    (the tracer's trip log), checked:
      - the first call: the wrappers count each kernel of every graph
        twice (warm-up and capture): K1 = 0, K2 = 2 per chunk of each data
        shard, K3 = 2; its seconds and the memory it reserves;
      - every warm call: 0 host syncs, 0 launches on the host, and on the
        device K1 = 0, K2 one per chunk of each data shard, K3 = 1; the
        input state unwritten; bit for bit the eager sharded replay on
        the same mesh, and each shard's LM ran on the device (its trip
        log) the trips of the eager loop;
      - its fusion stage against run_offline's in the same call and
        against the offline golden: every decision exact, joints within
        JOINT_TOL_M of run_offline's;
      - its tracker stage (track_sharded: K3 on the home device, the
        reprojection split over the data rows) on the golden's own tracker
        inputs against the golden's tracker stage, as phase 6 checks
        run_offline's;
      - the whole run against run_offline in the same call (every
        decision exact, joints within K3's tolerances) and against the
        golden (every decision exact, joints reported as phase 6 reports
        run_offline's): gated on the benign scene, reported on the
        adversarial one (ROADMAP C2).
    Returns ((K1, K2, K3, L1, L2) of the first call on the host, the same
    of the checked replays on the device, report, trip log)."""
    from smartedgesensor3dhumanpose_tpu_torch import tracing
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding
    from smartedgesensor3dhumanpose_tpu_torch.types import TrackerState

    dev = rig.P.device
    frames = {scene: stacked_frames(inputs[scene], dev) for scene in SCENES}
    n = frames["benign"].kp2d.shape[0]
    want_counts = (0, sharded_k2_launches(n, mesh.shape["data"]), 1)
    state0 = TrackerState.initial(cfg.tracker.max_tracks, cfg.tracker.n_mov_avg,
                                  cfg.tracker.avg_delay, device=dev)

    def call(scene):
        return sharding.run_offline_sharded(rig, cfg, mesh, frames[scene], state0,
                                            fusion_batch=OFFLINE_FUSION_BATCH)

    fresh_sharded_graphs()
    reset_counts()
    with tracing.Tracer() as tracer:
        _, first_s, first_mib = first_call(lambda: call("benign"))
    trip_log = tracer.trip_log()
    first = read_counts()
    if first[:3] != tuple(FIRST_CALL_HOST_LAUNCHES * c for c in want_counts):
        raise AssertionError(f"sharded {label}: the first call counted (K1, K2, K3) = {first} "
                             f"on the host, expected {FIRST_CALL_HOST_LAUNCHES} x {want_counts}")
    report = {"first_call_s": first_s, "first_call_reserved_mib": first_mib,
              **sharded_graph_cost(), "host_syncs_per_call": count_syncs(lambda: call("benign"))}
    if report["host_syncs_per_call"]:
        raise AssertionError(f"sharded {label}: {report['host_syncs_per_call']} host syncs")
    on_device = [0] * N_KERNELS
    for scene in SCENES:
        before = [t.clone() for t in state0]
        reset_counts()
        got, counts = device_counts(lambda: call(scene))
        host = read_counts()
        if any(host) or counts[:3] != want_counts:
            raise AssertionError(f"sharded {label} {scene}: launch counts (K1, K2, K3) = {host} on "
                                 f"the host, {counts} on the device; expected (0, 0, 0), "
                                 f"{want_counts}")
        # The fusion stage triangulates each data shard's chunks, one F1
        # each, as K2 folds them.
        check_f1_device(f"sharded {label} {scene}", counts, want_counts[1])
        on_device = [a + b for a, b in zip(on_device, counts)]
        if not all(torch.equal(a, b) for a, b in zip(before, state0)):
            raise AssertionError(f"sharded {label} {scene}: the input state was written")
        trips = log_trips(trip_log)
        eager = []
        with eager_sharded():
            want_trips = eager_trips(lambda: eager.append(call(scene)))
        bad, diffs = tree_diff(got, eager[0])
        if bad or any(diffs.values()):
            raise AssertionError(f"sharded {label} {scene}: captured != eager: {bad} "
                                 f"{ {k: v for k, v in diffs.items() if v} }")
        if trips != want_trips:
            raise AssertionError(f"sharded {label} {scene}: the LMs ran {trips} trips on the "
                                 f"device, eager {want_trips}")
        _, out = got

        # Fusion stage.
        want = unsharded[scene]
        raw, raw_w = out.persons_raw, want.persons_raw
        if not (torch.equal(raw.valid, raw_w.valid) and torch.equal(raw.score > 0, raw_w.score > 0)
                and torch.equal(out.n_dropped_hypotheses, want.n_dropped_hypotheses)):
            raise AssertionError(f"sharded {label} {scene}: fusion decisions != run_offline's")
        fusion_mm = float((raw.xyz - raw_w.xyz).abs().max()) * 1e3
        if not fusion_mm <= JOINT_TOL_M * 1e3:
            raise AssertionError(f"sharded {label} {scene}: fused joints {fusion_mm} mm off")
        golden_frames = 0
        golden_fused = golden_pred = 0.0
        for f in range(n):
            bad, d_fused, d_pred, _, finite = step_mismatch(at_frame(out, f), golden, scene, f)
            fusion_bad = [k for k in bad if k in ("raw_valid", "raw_joint_on", "n_dropped_hyp")]
            if fusion_bad or not finite:
                raise AssertionError(f"sharded {label} {scene} frame {f}: fusion decisions "
                                     f"differ from the golden {fusion_bad}")
            if bad and scene == "benign":
                raise AssertionError(f"sharded {label} {scene} frame {f}: decisions differ "
                                     f"from the golden {bad}")
            if not bad:
                golden_frames += 1
                golden_fused, golden_pred = max(golden_fused, d_fused), max(golden_pred, d_pred)

        # Tracker stage on the golden's own inputs.
        persons, pivots, n_drop, pre = golden_stage(golden, scene, dev)
        _, stage = sharding.track_sharded(rig, cfg, mesh, frames[scene], state0, persons, pivots,
                                          n_drop, pre)
        stage_mm = 0.0
        for f in range(n):
            stage_mm = max(stage_mm, *compare_step(at_frame(stage, f), golden,
                                                   f"{scene}/stage", f))
        # The whole run against run_offline (its joints against the golden
        # are reported: phase 6 reports run_offline's, which exceed
        # JOINT_TOL_M on some benign frames of the card).
        bad, worst = offline_diff(out, want)
        if scene == "benign":
            compare_outputs(out, want, f"sharded {label} {scene} vs run_offline")
        report[scene] = dict(
            vs_eager="equal", lm_trips_on_device=",".join(map(str, trips)),
            fusion_vs_run_offline_mm=fusion_mm, stage_worst_mm=stage_mm * 1e3,
            run_offline_differs=bad, run_offline_worst_mm={k: v * 1e3 for k, v in worst.items()},
            golden_frames_exact=f"{golden_frames}/{n}", golden_worst_fused_mm=golden_fused * 1e3,
            golden_worst_pred_mm=golden_pred * 1e3,
        )
    return first, tuple(on_device), report, trip_log


def check_concurrent_replays(label, mesh, rig, cfg, inputs, trip_log) -> dict:
    """The entries of `mesh` (all on one card) replaying at once, each on
    its stream, against the same replays one at a time (every entry on one
    stream): equal bit for bit. How much the entries' LMs overlapped on the
    device clock (overlap_share of their spans in the trip log), at once
    and one at a time, and how much the device events of a torch.profiler
    trace of one call overlapped (kernels and copies of one stream never
    do; a trace may miss some of a WHILE body's kernels)."""
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding
    from smartedgesensor3dhumanpose_tpu_torch.types import TrackerState

    dev = rig.P.device
    frames = stacked_frames(inputs["adversarial"], dev)
    state0 = TrackerState.initial(cfg.tracker.max_tracks, cfg.tracker.n_mov_avg,
                                  cfg.tracker.avg_delay, device=dev)

    def call():
        return sharding.run_offline_sharded(rig, cfg, mesh, frames, state0,
                                            fusion_batch=OFFLINE_FUSION_BATCH)

    at_once = call()
    spans_at_once = lm_spans(trip_log)
    trace = [(e.time_range.start, e.time_range.end) for e in traced(call)]
    with one_stream_per_device():
        one_at_a_time = call()
    spans_in_turn = lm_spans(trip_log)
    bad, diffs = tree_diff(at_once, one_at_a_time)
    if bad or any(diffs.values()):
        raise AssertionError(f"sharded {label}: replays at once != one at a time: {bad} "
                             f"{ {k: v for k, v in diffs.items() if v} }")
    return {"at_once_vs_one_at_a_time": "equal", "lms": len(spans_at_once),
            "lm_overlap_share_at_once": overlap_share(spans_at_once),
            "lm_overlap_share_one_at_a_time": overlap_share(spans_in_turn),
            "trace_events": len(trace), "trace_overlap_share_at_once": overlap_share(trace)}


def scaled_frame(scaled, dev):
    """The first frame of phase 8's scaled scene on `dev`, stale cameras
    masked: (config, rig, frame)."""
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    cfg, rig, frames = scaled
    frame, _ = pipeline.mask_stale_cameras(Frame(*(x[0].to(dev) for x in frames)),
                                           cfg.fusion.max_sync_diff)
    return cfg, to_device(rig, dev), frame


def check_sharded_fusion(label, mesh, scaled):
    """fuse_frame_sharded on the first frame of phase 8's scaled scene on
    `mesh`'s model axis, every graph captured anew by the first call (K2
    counted twice on the host: warm-up and capture), then a warm call: 0
    host syncs, 0 launches on the host, K2 = 1 on the device, bit for bit
    the eager sharded fusion; against fusion.fuse_frame on the home
    device: valid and the drop count equal, published joints within
    JOINT_TOL_M. Returns ((K1, K2, K3, L1, L2) of the first call on the host,
    (K1, K2, K3, L1, L2) of the replay on the device, report)."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding

    home = mesh.home
    cfg, rig, frame = scaled_frame(scaled, home)
    want, want_drop = fusion.fuse_frame(frame, rig, cfg.fusion, with_stats=True)

    def call():
        return sharding.fuse_frame_sharded(frame, rig, cfg, mesh, with_stats=True)

    fresh_sharded_graphs()
    reset_counts()
    _, first_s, first_mib = first_call(call)
    first = read_counts()
    # F1 once per entry of the model axis that holds hypotheses.
    shards = min(len(mesh.axis("model")), cfg.fusion.max_hypotheses)
    if first != (0, FIRST_CALL_HOST_LAUNCHES, 0, 0, 0, FIRST_CALL_HOST_LAUNCHES * shards):
        raise AssertionError(f"sharded fusion {label}: the first call counted (K1, K2, K3, L1, "
                             f"L2, F1) = {first} on the host")
    syncs = count_syncs(call)
    reset_counts()
    (got, got_drop), on_device = device_counts(call)
    host = read_counts()
    if syncs or any(host) or on_device != (0, 1, 0, 0, 0, shards):
        raise AssertionError(f"sharded fusion {label}: {syncs} host syncs, launch counts (K1, K2, "
                             f"K3) = {host} on the host, {on_device} on the device, expected F1 "
                             f"{shards} times")
    bad, diffs = tree_diff((got, got_drop), eagerly(call)())
    if bad or any(diffs.values()):
        raise AssertionError(f"sharded fusion {label}: captured != eager: {bad} {diffs}")
    if not (torch.equal(got.valid, want.valid) and torch.equal(got_drop, want_drop)):
        raise AssertionError(f"sharded fusion {label}: valid or drops differ from fuse_frame")
    on = want.valid[:, None] & (want.score > 0)
    diff = (got.xyz - want.xyz).abs()[on]
    if diff.numel() == 0:
        raise AssertionError(f"sharded fusion {label}: no published joint to compare")
    worst = float(diff.max())
    if not worst < JOINT_TOL_M:
        raise AssertionError(f"sharded fusion {label}: worst joint {worst} m > {JOINT_TOL_M}")
    return first, on_device, {
        "vs_eager": "equal", "host_syncs_per_call": syncs, "first_call_s": first_s,
        "first_call_reserved_mib": first_mib, **sharded_graph_cost(),
        "joints_compared": int(diff.numel()), "worst_mm": worst * 1e3}


def check_cross_device(home, other, rig, cfg, inputs) -> dict:
    """K1, K2 and K3 launched on tensors of `other` while `home` is the
    current device, each against its plain version on the same tensors;
    then a Pipeline on `other`, captured after the ones on `home` of the
    phases before: its step's replay runs on `other` alone (every kernel
    of a profiler trace of it) and equals the eager step there."""
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.ops import association, hungarian

    rig = to_device(rig, other)
    pipe = pipeline.Pipeline(rig, cfg, device=other, fusion_batch=OFFLINE_FUSION_BATCH)
    frames = stacked_frames(inputs["adversarial"], other)
    rng = np.random.default_rng(12)
    with torch.cuda.device(home):
        cost = torch.as_tensor(rng.random((16, 24), dtype=np.float32), device=other)
        got = hungarian.linear_sum_assignment(cost)
        if not torch.equal(got, hungarian.linear_sum_assignment_reference(cost)):
            raise AssertionError(f"K1 on {other} with {home} current != plain")
        ctab, conf, det_ok = chunk_fold_inputs(frames, rig, cfg.fusion, 4)
        args = (cfg.fusion.max_hypotheses, cfg.fusion.max_epipolar_error, cfg.fusion.max_cost)
        got = association.associate_fold_batched(ctab, conf, det_ok, *args)
        ref = association.associate_fold_batched_reference(ctab, conf, det_ok, *args)
        if not all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, ref)):
            raise AssertionError(f"K2 on {other} with {home} current != plain")
        persons, pivots, fb, pre = tracker_inputs(pipe, frames)
        k3_err, _, _, _ = check_k3(f"on {other}", pipe.init_state(), persons, pivots, fb, pre,
                                   cfg.prior, cfg.tracker)

        # The captured step on `other`.
        from torch.autograd import DeviceType

        state, frame = pipe.init_state(), frame_at(inputs["benign"], 0, other)
        got = pipe.step(state, frame)
        torch.cuda.synchronize(other)
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            pipe.step(state, frame)
            torch.cuda.synchronize(other)
        cards = collections.Counter(e.device_index for e in prof.events()
                                    if e.device_type == DeviceType.CUDA)
        bad, diffs = tree_diff(got, pipeline.step(state, frame, rig, cfg))
        if set(cards) != {other.index} or bad or any(diffs.values()):
            raise AssertionError(f"the step captured on {other}: kernels by card {dict(cards)}, "
                                 f"against eager {bad} {diffs}")
        if torch.cuda.current_device() != home.index:
            raise AssertionError("a kernel wrapper or a capture left another device current")
    torch.cuda.synchronize(other)
    return {"home": str(home), "tensors_on": str(other), "k1": "exact", "k2": "exact",
            "k3_max_abs_err": k3_err, "captured_step_kernels_by_card": dict(cards),
            "captured_step_vs_eager": "equal"}


def wall_ms(fn, dev) -> float:
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


def in_turns(calls: dict, dev, eager_calls: dict) -> dict:
    """Median wall ms of each call, warm: every call of `calls` once per
    round for SHARDED_TIMED rounds, those of `eager_calls` in the first
    EAGER_SHARDED_TIMED rounds only."""
    for fn in {**calls, **eager_calls}.values():
        fn()
    times = {label: [] for label in {**calls, **eager_calls}}
    for i in range(SHARDED_TIMED):
        for label, fn in {**calls, **(eager_calls if i < EAGER_SHARDED_TIMED else {})}.items():
            times[label].append(wall_ms(fn, dev))
    return {label: statistics.median(v) for label, v in times.items()}


def phase_sharded(dev, smi, golden, rig, cfg, inputs, scaled):
    """parallel/sharding.py on the card, each shard's stages replayed as
    CUDA graphs: run_offline_sharded over every visible card (make_mesh())
    and on virtual meshes of `dev`, the sharded fusion of phase 8's frame,
    the dry run, the same across real cards where there are several (with
    launches and a captured step on another card's tensors); each against
    the eager sharded path on the same mesh (bit for bit), the entries of
    one card replaying at once against one at a time, and the wall times
    of each mesh, captured and eager, against the captured run_offline on
    the benign scene, and of the sharded fusion against fuse_frame, eager
    and captured. Returns {path: (K1, K2, K3, L1, L2)}: the sharded paths' first
    calls on the host and their checked replays on the device."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion, graphs, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding

    pipe = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=OFFLINE_FUSION_BATCH)
    unsharded = {scene: pipe.run_offline(pipe.init_state(), stacked_frames(inputs[scene], dev))[1]
                 for scene in SCENES}
    torch.cuda.synchronize()
    offline_body_mib = pools_mib(g.bodies.pool.id for g in pipe._offline.graphs.values())
    n_cards = torch.cuda.device_count()
    meshes = {"cards": sharding.make_mesh()}
    for d, m in VIRTUAL_MESHES:
        meshes[f"virtual{d}x{m}"] = sharding.make_mesh(d * m, model=m, devices=[dev] * (d * m))
    fusion_meshes = {f"virtual1x{FUSION_ENTRIES}": sharding.make_mesh(
        FUSION_ENTRIES, data=1, model=FUSION_ENTRIES, devices=[dev] * FUSION_ENTRIES)}
    if n_cards >= 2:
        if n_cards % 2 == 0:
            meshes[f"cards{n_cards // 2}x2"] = sharding.make_mesh(model=2)
        fusion_meshes[f"cards1x{n_cards}"] = sharding.make_mesh(data=1, model=n_cards)

    launches = {path: [0] * N_KERNELS for path in (
        "run_offline_sharded", "run_offline_sharded_replays_on_device",
        "fuse_frame_sharded", "fuse_frame_sharded_replays_on_device")}

    def add(path, counts):
        launches[path] = [a + b for a, b in zip(launches[path], counts)]

    concurrent = "virtual{}x{}".format(*CONCURRENT_MESH)
    for label, mesh in meshes.items():
        first, on_device, report, trip_log = check_sharded_replay(label, mesh, rig, cfg, golden,
                                                                  inputs, unsharded)
        add("run_offline_sharded", first)
        add("run_offline_sharded_replays_on_device", on_device)
        if label == concurrent:
            report["concurrent"] = check_concurrent_replays(label, mesh, rig, cfg, inputs, trip_log)
        log("12 sharded replay", gpu=repr(smi), mesh=label,
            shape=repr(mesh.shape).replace(" ", ""),
            devices=len({d for row in mesh.devices for d in row}),
            first_call_host_launches=",".join(map(str, first)),
            replays_on_device=",".join(map(str, on_device)), host_launches_per_replay="0,0,0,0,0",
            report="'" + json.dumps(report) + "'")
    for label, mesh in fusion_meshes.items():
        first, on_device, report = check_sharded_fusion(label, mesh, scaled)
        add("fuse_frame_sharded", first)
        add("fuse_frame_sharded_replays_on_device", on_device)
        log("12 sharded fusion", gpu=repr(smi), mesh=label, cams=SCALED_SCENE["num_cameras"],
            people=SCALED_SCENE["num_people"], valid="exact",
            first_call_host_launches=",".join(map(str, first)),
            replay_on_device=",".join(map(str, on_device)), host_launches_per_replay="0,0,0,0,0",
            report="'" + json.dumps(report) + "'")
    fresh_sharded_graphs()
    dry = sharding.dryrun(4, [dev] * 4)
    log("12 dryrun", entries=4, device=str(dev), captured=True,
        report="'" + json.dumps(dry) + "'")
    if n_cards >= 2:
        cross = check_cross_device(torch.device("cuda", 0), torch.device("cuda", 1), rig, cfg,
                                   inputs)
        log("12 multi card", multi_card="checked", count=n_cards,
            cross_device="'" + json.dumps(cross) + "'")
    else:
        log("12 multi card", multi_card="not_run", count=n_cards)

    # Wall times on the benign scene, warm, in turns.
    fresh_sharded_graphs()
    frames = stacked_frames(inputs["benign"], dev)
    calls = {"run_offline": lambda: pipe.run_offline(pipe.init_state(), frames)}
    eager_calls = {}
    for label, mesh in meshes.items():
        calls[label] = (lambda m=mesh: sharding.run_offline_sharded(
            rig, cfg, m, frames, pipe.init_state(), fusion_batch=OFFLINE_FUSION_BATCH))
        eager_calls[f"eager_{label}"] = eagerly(calls[label])
    medians = in_turns(calls, dev, eager_calls)
    # One scaled frame's fusion, unsharded and over each fusion mesh.
    s_cfg, s_rig, s_frame = scaled_frame(scaled, dev)
    fuse_graph = graphs.CapturedFunction(lambda fr, rg: fusion.fuse_frame(fr, rg, s_cfg.fusion),
                                         "fuse_frame")
    fuse = {"fuse_frame": lambda: fuse_graph(s_frame, s_rig)}
    eager_fuse = {"eager_fuse_frame": lambda: fusion.fuse_frame(s_frame, s_rig, s_cfg.fusion)}
    for label, mesh in fusion_meshes.items():
        fuse[label] = (lambda m=mesh: sharding.fuse_frame_sharded(s_frame, s_rig, s_cfg, m))
        eager_fuse[f"eager_{label}"] = eagerly(fuse[label])
    fuse_medians = in_turns(fuse, dev, eager_fuse)
    log("12 sharded times", gpu=repr(smi), frames=frames.kp2d.shape[0], rounds=SHARDED_TIMED,
        eager_rounds=EAGER_SHARDED_TIMED, fusion_batch=OFFLINE_FUSION_BATCH,
        run_offline_body_pool_mib=offline_body_mib,
        replay_median_ms="'" + json.dumps(medians) + "'",
        replay_over_run_offline="'" + json.dumps({k: v / medians["run_offline"]
                                                  for k, v in medians.items()}) + "'",
        fusion_median_ms="'" + json.dumps(fuse_medians) + "'",
        fusion_over_fuse_frame="'" + json.dumps({k: v / fuse_medians["fuse_frame"]
                                                 for k, v in fuse_medians.items()}) + "'")
    return {path: tuple(c) for path, c in launches.items()}


# --------------------------------------------------------------- phase 13 --

# The captured run_offline against the eager one on the card: the same
# kernels on the same inputs, and loops that equal the early exit bit for
# bit, so any difference is a fault; this bound only names the budget.
CAPTURED_OFFLINE_TOL_M = 1.0e-6
# Calls timed: run_offline eager and captured in turns; chains of 64 frames.
CAPTURED_OFFLINE_TIMED = 4
CHAIN_TIMED = 3
# End-to-end steps timed at full width, eager and captured in turns.
CAPTURED_E2E_STEPS = 12
# LM trips profiled at the online step's shape (one golden frame's persons).
LM_TRIPS = 32
# Replays profiled for device busy time and kernels (13.1, 13.4).
PROFILED_REPLAYS = 3
# The captured loops' kernels (csrc/graph_loop.cu), by name in a trace.
LOOP_BEGIN, LOOP_NEXT = "loop_begin_kernel", "loop_next_kernel"
# Rounds of the LM graphs timed in turns (13.5).
LM_TIMED_ROUNDS = 5
# Frames of each golden scene at which the step's loops are counted on the
# device (13.5), each from the state the captured chain reaches there.
TRIP_FRAMES = (8, 24, 40, 56)
# Replays timed, a sync after each, for the fixed-trip step graph (13.5).
FIXED_STEP_TIMED = 30
# Every BUSY_STRIDE-th frame of each scene's captured steps is replayed
# again for the trips and device time of its loops (13.1).
BUSY_STRIDE = 4
# Back-to-back calls timed for the copies' cost (13.1).
COPY_TIMED = 50
# The shorter sequence of the graph release check (13.3).
RELEASE_FRAMES = 16


def named_leaves(tree, prefix=""):
    """(dotted field path, tensor) of every tensor of a tuple tree."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    names = getattr(tree, "_fields", [str(i) for i in range(len(tree))])
    return [leaf for name, x in zip(names, tree)
            for leaf in named_leaves(x, f"{prefix}.{name}" if prefix else name)]


def tree_diff(got, want) -> tuple:
    """(integer and mask fields that differ, {float field: largest
    difference}) of two trees of tensors; infinities and NaNs equal where
    both sides hold them."""
    bad, worst = [], {}
    for (name, a), (_, b) in zip(named_leaves(got), named_leaves(want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            bad.append(name)
        elif a.dtype.is_floating_point:
            d = torch.where((a == b) | (a.isnan() & b.isnan()), 0.0, (a - b).abs())
            worst[name] = float(d.max()) if d.numel() else 0.0
        elif not torch.equal(a, b):
            bad.append(name)
    return bad, worst


def quantiles(ms) -> dict:
    q = statistics.quantiles(ms, n=10)
    return {"p50": statistics.median(ms), "p90": q[-1]}


def traced(fn) -> list:
    """The device events of one call of `fn` in a torch.profiler trace of
    it alone (kernels of a graph replay included), in the order they
    started."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(evs, key=lambda e: e.time_range.start)


def profile_device(fn, reps: int) -> tuple:
    """(device busy ms per call, device events per call, (K1, K2, K3, L1, L2)
    kernels over the `reps` calls) in torch.profiler traces of `reps`
    calls of `fn`, one trace each, after one untraced call."""
    fn()
    evs = [e for _ in range(reps) for e in traced(fn)]
    counts = tuple(sum(kernel_index(e.name) == i for e in evs) for i in range(N_KERNELS))
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / reps, len(evs) / reps, counts


def captured_with_log(fn, *args):
    """(fn captured anew as graphs.CapturedFunction and called on `args`,
    the trip log of its loops): a tracer records while it captures, so
    every replay writes, on the device, the trips each loop ran and the
    device clock at the loop's start and at each trip's end."""
    from smartedgesensor3dhumanpose_tpu_torch import graphs, tracing

    captured = graphs.CapturedFunction(fn, "trip log")
    with tracing.Tracer() as tracer:
        captured(*args)
    return captured, tracer.trip_log()


def loop_body_nodes(fn, *args) -> list:
    """The nodes of each WHILE body of `fn`'s graph, captured anew for
    `args`: one trip's kernels and copies, the trip's test included (the
    tracer's `loop.body_nodes` counters)."""
    from smartedgesensor3dhumanpose_tpu_torch import graphs, tracing

    captured = graphs.CapturedFunction(fn, "body nodes")
    with tracing.Tracer() as tracer:
        captured(*args)
    return tracer.body_nodes()


def log_trips(log) -> list:
    """The trips each loop of the last replay ran, read from the device."""
    torch.cuda.synchronize()
    return [int(trips) for trips, _ in log]


def log_spans_ms(log) -> list:
    """Each loop's span in the last replay on the device clock, from the
    loop's start to its last trip's end, in ms."""
    torch.cuda.synchronize()
    return [float(stamps[int(trips)] - stamps[0]) / 1e6 for trips, stamps in log]


def trips_in_trace(fn) -> list:
    """The trips each loop of one call of `fn` shows in a torch.profiler
    trace: the loop_next kernels after each loop_begin kernel. A cross
    check of the device's own log only: such traces showed every trip of
    a WHILE node's body in some runs on the card, some trips or none in
    others, so no busy time is taken from a trace of a graph with loops."""
    shown = []
    for e in traced(fn):
        if LOOP_BEGIN in e.name:
            shown.append(0)
        elif LOOP_NEXT in e.name and shown:
            shown[-1] += 1
    return shown


def waited_and_back_to_back(fn, reps: int) -> tuple:
    """(median ms of a call of `fn` that the caller waits for, a sync after
    each; ms per call of `reps` calls queued back to back, by CUDA
    events). Back to back the device never waits for the host, so the
    second bounds the device's time per call from above (its own gaps
    included), and 1 - second / first bounds from below the share of a
    waited-for call in which the device idles."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), sync_time(fn, reps)


def eager_trips(fn) -> list:
    """The trips each loop of one eager call of `fn` ran, in order: each
    `loops.while_loop` (the loop's host test, counted) and each one-launch
    LM (`lm_prior.lm_solve`: the gain of its `iters`, read after it)."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior, loops

    counts = []
    while_loop, lm_solve = loops.while_loop, lm_prior.lm_solve

    def counted(cond, body, carry, max_trips):
        counts.append(0)

        def trip(c):
            counts[-1] += 1
            return body(c)

        return while_loop(cond, trip, carry, max_trips)

    def solved(carry, *args, **kw):
        before = int(carry[4])
        out = lm_solve(carry, *args, **kw)
        counts.append(int(out[4]) - before)
        return out

    loops.while_loop, lm_prior.lm_solve = counted, solved
    try:
        fn()
    finally:
        loops.while_loop, lm_prior.lm_solve = while_loop, lm_solve
    return counts


@contextlib.contextmanager
def fixed_trips():
    """PR 8's captured loops, for comparison: while this is on, a
    `loops.while_loop` runs all of its `max_trips` trips with no test (its
    trips after the loop's end change nothing), so a function captured now
    records every trip."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import loops

    def fixed(cond, body, carry, max_trips):
        for _ in range(max_trips):
            carry = body(carry)
        return carry

    while_loop = loops.while_loop
    loops.while_loop = fixed
    try:
        yield
    finally:
        loops.while_loop = while_loop


def graph_nodes(fn, *args) -> dict:
    """The nodes of the top level of `fn`'s CUDA graph, as
    graphs.CapturedFunction captures it for `args`, by type (the driver's
    cuGraphGetNodes and cuGraphNodeGetType): all, kernel, memcpy, memset,
    conditional (a WHILE node's body is one conditional node here)."""
    import ctypes

    from smartedgesensor3dhumanpose_tpu_torch import graphs

    captured = graphs.CapturedFunction(fn, "node count")
    captured.keep_graph = True
    captured(*args)
    raw = ctypes.c_void_p(next(iter(captured.graphs.values())).graph.raw_cuda_graph())
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise AssertionError("cuGraphGetNodes failed")
    kinds = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds[kind.value] += 1
    # CUgraphNodeType: KERNEL 0, MEMCPY 1, MEMSET 2, CONDITIONAL 13.
    return {"all": n.value, "kernel": kinds[0], "memcpy": kinds[1], "memset": kinds[2],
            "conditional": kinds[13]}


def nodes_str(nodes: dict) -> str:
    return ",".join(f"{k}:{v}" for k, v in nodes.items())


def host_launches_none(what: str) -> None:
    """A replay launches nothing on the host: the wrappers' counts since
    the last reset_counts() are 0."""
    counts = read_counts()
    if any(counts):
        raise AssertionError(f"{what}: the wrappers counted {counts} launches in a replay")


def phase_captured_step(dev, smi, golden, rig, cfg, inputs, pipe):
    """13.1-13.2: the captured step against the golden and the eager step,
    its syncs per replay, its kernels per replay on the device, eager and
    captured times, the copies' cost and the device's idle share, and the
    trips and device time of its loops on every BUSY_STRIDE-th frame; the
    stacked chain against the per-frame replays. Returns the chain's
    kernel counts on the device."""
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.ops import tracker
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    worst = {"golden_fused_mm": 0.0, "golden_pred_mm": 0.0}
    eager_worst = {}
    wall = {"eager": [], "captured": []}
    event_ms = []
    clocks = []
    per_frame = {}
    # Busy ms, wall ms and (LM, merge) trips of sampled frames' replays.
    sampled = []
    step_fn = lambda s, f: pipeline.step(s, f, rig, cfg)  # noqa: E731
    logged, trip_log = captured_with_log(step_fn, pipe.init_state(), frame_at(inputs["benign"], 0, dev))
    fns = {"captured": pipe.step,
           "eager": lambda state, frame: pipeline.step(state, frame, rig, cfg)}
    for i, scene in enumerate(SCENES):
        data = inputs[scene]
        n = data["kp2d"].shape[0]
        frames = [frame_at(data, f, dev) for f in range(n)]
        runs = {}
        # Each path over the whole scene in a block, a device sync after
        # every step; the two blocks in turns across the scenes.
        for name in (("captured", "eager") if i % 2 == 0 else ("eager", "captured")):
            state, outs = pipe.init_state(), []
            for f, frame in enumerate(frames):
                torch.cuda.synchronize()
                reset_counts()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                state, out = fns[name](state, frame)
                end.record()
                torch.cuda.synchronize()
                wall[name].append((time.perf_counter() - t0) * 1e3)
                if name == "captured":
                    event_ms.append(start.elapsed_time(end))
                    host_launches_none(f"captured step {scene} {f}")
                outs.append((state, out))
            clocks.append(f"{name}:{smi_clocks()}")
            runs[name] = outs
            if name == "captured":
                scene_wall = wall[name][-n:]
        for f, ((state_c, out_c), (state_e, out_e)) in enumerate(zip(runs["captured"], runs["eager"])):
            df, dp = compare_step(out_c, golden, scene, f)
            worst["golden_fused_mm"] = max(worst["golden_fused_mm"], df * 1e3)
            worst["golden_pred_mm"] = max(worst["golden_pred_mm"], dp * 1e3)
            bad, diffs = tree_diff((state_c, out_c), (state_e, out_e))
            if bad:
                raise AssertionError(f"captured step {scene} {f}: {bad} differ from the eager step")
            for k, v in diffs.items():
                eager_worst[k] = max(eager_worst.get(k, 0.0), v)
        per_frame[scene] = (runs["captured"][-1][0], [out for _, out in runs["captured"]])
        states = [pipe.init_state()] + [st for st, _ in runs["captured"]]
        for f in range(0, n, BUSY_STRIDE):
            logged(states[f], frames[f])
            sampled.append((log_trips(trip_log), log_spans_ms(trip_log), scene_wall[f]))
    joints = max(v for k, v in eager_worst.items() if k.endswith("xyz"))
    if joints > JOINT_TOL_M:
        raise AssertionError(f"captured step: joints {joints} m from the eager step")

    frame = frame_at(inputs["benign"], 40, dev)
    state = pipe.init_state()
    replay_syncs = count_syncs(lambda: pipe.step(state, frame))
    eager_syncs = count_syncs(lambda: pipeline.step(state, frame, rig, cfg))
    if replay_syncs:
        raise AssertionError(f"captured step: {replay_syncs} host syncs per replay")
    _, _, on_device = profile_device(lambda: pipe.step(state, frame), PROFILED_REPLAYS)
    if on_device[:3] != (PROFILED_REPLAYS,) * 2 + (0,):
        raise AssertionError(f"captured step: {on_device} kernels on the device over "
                             f"{PROFILED_REPLAYS} replays")
    check_lm_device("captured step", on_device, PROFILED_REPLAYS)
    lm_trips = [trips[0] for trips, _, _ in sampled]
    lm_ms = [spans[0] for _, spans, _ in sampled]
    lm_share = sum(lm_ms) / sum(wall for _, _, wall in sampled)
    # The copies that keep the step functional (inputs into the static
    # buffers, outputs out to fresh tensors): a call against its replay.
    graph = next(iter(pipe._step.graphs.values()))
    waited_ms, call_ms = waited_and_back_to_back(lambda: pipe.step(state, frame), COPY_TIMED)
    replay_ms = sync_time(graph.graph.replay, COPY_TIMED)
    in_mib = sum(t.nbytes for t in graph.inputs) / 2**20
    out_mib = sum(t.nbytes for t in graph.outputs) / 2**20
    nodes = graph_nodes(lambda s, f: pipeline.step(s, f, rig, cfg), state, frame)
    wall_c, wall_e = quantiles(wall["captured"]), quantiles(wall["eager"])
    event_q = quantiles(event_ms)
    log("13.1 captured step", gpu=repr(smi), frames=len(event_ms), decisions="exact",
        vs_golden_worst_fused_mm=worst["golden_fused_mm"], vs_golden_worst_pred_mm=worst["golden_pred_mm"],
        vs_eager_decisions="exact", vs_eager_max_abs_err=max(eager_worst.values()),
        vs_eager_joints_max_abs_err_m=joints, host_launches_per_replay="0,0,0,0,0",
        device_kernels_over_replays=",".join(map(str, on_device)), replays_profiled=PROFILED_REPLAYS,
        host_syncs_per_replay=replay_syncs, host_syncs_eager_step=eager_syncs,
        eager_ms_p50=wall_e["p50"], eager_ms_p90=wall_e["p90"],
        captured_ms_p50=wall_c["p50"], captured_ms_p90=wall_c["p90"],
        captured_event_ms_p50=event_q["p50"], captured_event_ms_p90=event_q["p90"],
        frames_sampled=len(sampled), sampled_lm_trips_min=min(lm_trips),
        sampled_lm_trips_mean=statistics.mean(lm_trips), sampled_lm_trips_max=max(lm_trips),
        sampled_lm_device_clock_ms_mean=statistics.mean(lm_ms), sampled_lm_device_clock_ms_max=max(lm_ms),
        sampled_lm_share_of_wall=lm_share,
        sampled_merge_rounds_max=max(trips[1] for trips, _, _ in sampled), graph_nodes=nodes_str(nodes),
        waited_ms_p50=waited_ms, idle_share_at_least=1.0 - call_ms / waited_ms,
        call_ms=call_ms, replay_only_ms=replay_ms, copies_ms=call_ms - replay_ms,
        copied_in_mib=in_mib, copied_out_mib=out_mib,
        sm_clock_mhz_power_w_after_each_block="'" + " ".join(clocks) + "'")

    # 13.2 The chain: the step's graph once per frame, the state on the device.
    chain_ms = []
    for scene in SCENES:
        frames = stacked_frames(inputs[scene], dev)
        n = frames.kp2d.shape[0]
        torch.cuda.synchronize()
        reset_counts()
        end, chain = pipe.run_per_frame_chain(pipe.init_state(), frames)
        torch.cuda.synchronize()
        host_launches_none(f"chain {scene}")
        state_c, outs = per_frame[scene]
        bad, diffs = tree_diff((end, chain), (state_c, tracker.stack_frames(outs)))
        if bad or any(diffs.values()):
            raise AssertionError(f"chain {scene}: differs from the per-frame replays: {bad} {diffs}")
        syncs = count_syncs(lambda: pipe.run_per_frame_chain(pipe.init_state(), frames))
        if syncs:
            raise AssertionError(f"chain {scene}: {syncs} host syncs")
        for _ in range(CHAIN_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run_per_frame_chain(pipe.init_state(), frames)
            torch.cuda.synchronize()
            chain_ms.append((time.perf_counter() - t0) * 1e3 / n)
    head = Frame(*(x[:STEP_PROFILED] for x in frames))
    _, _, on_device = profile_device(lambda: pipe.run_per_frame_chain(pipe.init_state(), head), 1)
    if on_device[:3] != (STEP_PROFILED,) * 2 + (0,):
        raise AssertionError(f"chain of {STEP_PROFILED} frames: {on_device} kernels on the device")
    check_lm_device("chain", on_device, STEP_PROFILED)
    log("13.2 captured chain", gpu=repr(smi), scenes=len(SCENES), frames=n,
        stacked="StepOutput [F, ...]", vs_per_frame_replays="equal", host_syncs_per_call=0,
        host_launches_per_call="0,0,0,0,0", frames_profiled=STEP_PROFILED,
        device_kernels=",".join(map(str, on_device)),
        chain_ms_per_step_median=statistics.median(chain_ms),
        chain_ms_per_step_min=min(chain_ms), chain_ms_per_step_max=max(chain_ms))
    return {"chain_replays_on_device": on_device}


def check_graph_release(smi, rig, cfg, state0, frames):
    """13.3 (end): a CapturedFunction that keeps one graph, called on a
    64-frame then a RELEASE_FRAMES-frame sequence: the second capture drops
    the first graph, and its memory goes back to the allocator."""
    from smartedgesensor3dhumanpose_tpu_torch import graphs, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    offline = graphs.CapturedFunction(
        lambda s, f: pipeline.run_offline(s, f, rig, cfg, OFFLINE_FUSION_BATCH), "run_offline")
    offline.max_graphs = 1
    short = Frame(*(x[:RELEASE_FRAMES] for x in frames))
    reserved = []
    for seq in (None, frames, short):
        if seq is not None:
            offline(state0, seq)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    base, long_, after = reserved
    if len(offline.graphs) != 1 or not after < long_:
        raise AssertionError(f"graph release: {len(offline.graphs)} graphs kept, reserved "
                             f"{base} -> {long_} -> {after} bytes")
    log("13.3 graph release", gpu=repr(smi), max_graphs=1,
        frames=f"{frames.kp2d.shape[0]},{RELEASE_FRAMES}",
        reserved_over_base_mib=f"{(long_ - base) / 2**20:.2f},{(after - base) / 2**20:.2f}",
        released=True)


def phase_captured_offline(dev, smi, rig, cfg, inputs, off_pipe):
    """13.3: the captured run_offline against the eager one, its syncs and
    host launches per replay, eager and captured times, its LMs' trips on
    the device, and PR 8's fixed-trip graph timed beside it; the release
    of a dropped graph's memory."""
    from smartedgesensor3dhumanpose_tpu_torch import graphs, pipeline

    worst = 0.0
    wall = {"eager": [], "captured": []}
    for scene in SCENES:
        frames = stacked_frames(inputs[scene], dev)
        n = frames.kp2d.shape[0]
        state0 = off_pipe.init_state()
        torch.cuda.synchronize()
        reset_counts()
        got = off_pipe.run_offline(state0, frames)
        torch.cuda.synchronize()
        host_launches_none(f"captured run_offline {scene}")
        want = pipeline.run_offline(state0, frames, rig, cfg, OFFLINE_FUSION_BATCH)
        bad, _ = offline_diff(got[1], want[1])
        bad_all, diffs = tree_diff(got, want)
        if bad or bad_all:
            raise AssertionError(f"captured run_offline {scene}: {bad + bad_all} differ from eager")
        joints = max(v for k, v in diffs.items() if k.endswith("xyz"))
        if joints > CAPTURED_OFFLINE_TOL_M:
            raise AssertionError(f"captured run_offline {scene}: joints off by {joints} m")
        worst = max(worst, max(diffs.values()))
    syncs = count_syncs(lambda: off_pipe.run_offline(state0, frames))
    if syncs:
        raise AssertionError(f"captured run_offline: {syncs} host syncs per replay")
    # The adversarial scene (the last in SCENES): each fusion chunk's
    # cold-start LM as one launch of L1; the merge runs inside K3.
    offline_fn = lambda s, f: pipeline.run_offline(s, f, rig, cfg, OFFLINE_FUSION_BATCH)  # noqa: E731
    logged, trip_log = captured_with_log(offline_fn, state0, frames)
    trips, lm_ms = log_trips(trip_log), log_spans_ms(trip_log)
    traced_trips = trips_in_trace(lambda: logged(state0, frames))
    # PR 8's graph, whose LMs ran every trip, timed in turns with this one.
    fixed = graphs.CapturedFunction(offline_fn, "fixed-trip run_offline")
    with fixed_trips():
        fixed(state0, frames)
    bad, diffs = tree_diff(fixed(state0, frames), off_pipe.run_offline(state0, frames))
    if bad or any(diffs.values()):
        raise AssertionError(f"fixed-trip run_offline differs from the captured one: {bad} {diffs}")
    times = {"while": [], "fixed": []}
    for _ in range(2):
        for name, fn in (("while", off_pipe.run_offline), ("fixed", fixed)):
            times[name].append(waited_and_back_to_back(lambda fn=fn: fn(state0, frames),
                                                       CAPTURED_OFFLINE_TIMED))
    waited_ms, b2b_ms = (statistics.median(x[i] for x in times["while"]) for i in (0, 1))
    fixed_waited_ms, fixed_b2b_ms = (statistics.median(x[i] for x in times["fixed"]) for i in (0, 1))
    del fixed
    want = eager_trips(lambda: offline_fn(state0, frames))
    if trips != want:
        raise AssertionError(f"captured run_offline: loops ran {trips} trips on the device, eager {want}")
    nodes = graph_nodes(offline_fn, state0, frames)
    eager_syncs = count_syncs(lambda: pipeline.run_offline(state0, frames, rig, cfg, OFFLINE_FUSION_BATCH))
    runs = {"eager": lambda: pipeline.run_offline(state0, frames, rig, cfg, OFFLINE_FUSION_BATCH),
            "captured": lambda: off_pipe.run_offline(state0, frames)}
    for i in range(CAPTURED_OFFLINE_TIMED):
        for name in (("eager", "captured") if i % 2 == 0 else ("captured", "eager")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            wall[name].append((time.perf_counter() - t0) * 1e3)
    e_ms, c_ms = statistics.median(wall["eager"]), statistics.median(wall["captured"])
    log("13.3 captured run_offline", gpu=repr(smi), frames=n, fusion_batch=OFFLINE_FUSION_BATCH,
        vs_eager_decisions="exact", vs_eager_max_abs_err=worst, host_launches_per_replay="0,0,0,0,0",
        host_syncs_per_replay=syncs, host_syncs_eager=eager_syncs,
        eager_ms_median=e_ms, captured_ms_median=c_ms,
        eager_fused_fps=n / e_ms * 1e3, captured_fused_fps=n / c_ms * 1e3,
        lm_trips_on_device=",".join(map(str, trips)), lm_trips_eager=",".join(map(str, want)),
        lm_trips_in_profiler_trace=",".join(map(str, traced_trips)),
        lm_device_clock_ms=",".join(f"{t:.4f}" for t in lm_ms),
        waited_ms=waited_ms, back_to_back_ms=b2b_ms, idle_share_at_least=1.0 - b2b_ms / waited_ms,
        fixed_trips_waited_ms=fixed_waited_ms, fixed_trips_back_to_back_ms=fixed_b2b_ms,
        graph_nodes=nodes_str(nodes))
    check_graph_release(smi, rig, cfg, state0, frames)


def phase_captured_end_to_end(dev, smi, trained):
    """13.4: the captured end-to-end step against the eager
    end_to_end_step: at full width (random weights), times, syncs, host
    launches per replay and kernels on the device; on the trained detector
    of phase 11, outputs. Returns the kernel counts on the device."""
    from smartedgesensor3dhumanpose_tpu_torch import demo
    from smartedgesensor3dhumanpose_tpu_torch.models import end_to_end, keypoint_cnn

    det_cfg = keypoint_cnn.DetectorConfig()
    _, cfg, frames, pipe = demo.build_demo(DEMO_CAMS, DEMO_PEOPLE, CAPTURED_E2E_STEPS, DEMO_SEED,
                                           device=dev)
    step, model, state0 = end_to_end.make_end_to_end(
        pipe.rig, cfg, det_cfg, torch.Generator().manual_seed(E2E_SEED), device=dev)
    inputs = [(rendered(frames, t, det_cfg.image_size), frames.cam_stamp[t])
              for t in range(CAPTURED_E2E_STEPS)]
    _, capture_s, graph_mib = first_call(lambda: step(state0, *inputs[0]))

    def eager(state, images, stamp):
        return end_to_end.end_to_end_step(state, images, stamp, model, det_cfg, pipe.rig, cfg)

    wall = {"eager": [], "captured": []}
    state_c = state_e = state0
    for t, args in enumerate(inputs):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state_c, out_c = step(state_c, *args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host_launches_none(f"captured end to end {t}")
        state_e, out_e = eager(state_e, *args)
        torch.cuda.synchronize()
        wall["captured"].append((t1 - t0) * 1e3)
        wall["eager"].append((time.perf_counter() - t1) * 1e3)
        bad, _ = tree_diff((state_c, out_c), (state_e, out_e))
        if bad:
            raise AssertionError(f"captured end to end {t}: {bad} differ from eager")
    syncs = count_syncs(lambda: step(state0, *inputs[0]))
    if syncs:
        raise AssertionError(f"captured end to end: {syncs} host syncs per replay")
    _, _, on_device = profile_device(lambda: step(state0, *inputs[0]), PROFILED_REPLAYS)
    if on_device[:3] != (PROFILED_REPLAYS,) * 2 + (0,):
        raise AssertionError(f"captured end to end: {on_device} kernels on the device over "
                             f"{PROFILED_REPLAYS} replays")
    # The LM and the merge of a replay late in the sequence, against eager.
    late = inputs[-1]
    logged, trip_log = captured_with_log(eager, state_c, *late)
    trips = log_trips(trip_log)
    waited_ms, b2b_ms = waited_and_back_to_back(lambda: step(state0, *inputs[0]), CAPTURED_E2E_STEPS)
    want = eager_trips(lambda: eager(state_c, *late))
    if trips != want:
        raise AssertionError(f"captured end to end: loops ran {trips} trips on the device, eager {want}")
    nodes = graph_nodes(eager, state0, *inputs[0])

    # The trained detector of phase 11 (it finds every person).
    model2, t_cfg, t_pipe_cfg, t_rig, t_inputs = trained
    step2, model3, s_c = end_to_end.make_end_to_end(t_rig, t_pipe_cfg, t_cfg, device=dev)
    model3.load_state_dict(model2.state_dict())
    s_e = s_c
    worst, persons = {}, 0
    for t, args in enumerate(t_inputs):
        s_c, o_c = step2(s_c, *args)
        s_e, o_e = end_to_end.end_to_end_step(s_e, *args, model3, t_cfg, t_rig, t_pipe_cfg)
        bad, diffs = tree_diff((s_c, o_c), (s_e, o_e))
        if bad:
            raise AssertionError(f"trained captured end to end {t}: {bad} differ from eager")
        for k, v in diffs.items():
            worst[k] = max(worst.get(k, 0.0), v)
        persons += int(o_c.persons_raw.valid.sum())
    joints = max(v for k, v in worst.items() if k.endswith("xyz"))
    if not persons or joints > JOINT_TOL_M:
        raise AssertionError(f"trained captured end to end: {persons} persons, joints off by {joints} m")
    q_e, q_c = quantiles(wall["eager"][1:]), quantiles(wall["captured"][1:])

    log("13.4 captured end to end", gpu=repr(smi), image="x".join(map(str, det_cfg.image_size)),
        width=det_cfg.width, steps=CAPTURED_E2E_STEPS, vs_eager_decisions="exact",
        host_launches_per_replay="0,0,0,0,0", replays_profiled=PROFILED_REPLAYS,
        device_kernels_over_replays=",".join(map(str, on_device)), host_syncs_per_replay=syncs,
        waited_ms=waited_ms, back_to_back_ms=b2b_ms, idle_share_at_least=1.0 - b2b_ms / waited_ms,
        graph_nodes=nodes_str(nodes), loop_trips_on_device=",".join(map(str, trips)),
        loop_trips_eager=",".join(map(str, want)),
        eager_ms_p50=q_e["p50"], eager_ms_p90=q_e["p90"],
        captured_ms_p50=q_c["p50"], captured_ms_p90=q_c["p90"],
        first_call_s=capture_s, first_call_reserved_mib=graph_mib,
        trained_frames=len(t_inputs), trained_persons=persons, trained_vs_eager_decisions="exact",
        trained_vs_eager_joints_max_abs_err_m=joints)
    return {"end_to_end_replays_on_device": on_device}


def per_trip_optimize(g_in, warm_start, cfg):
    """`prior.optimize` by the per-trip route on CUDA, for comparison: L1 capped
    at one trip as the body of `loops.while_loop` (a WHILE node of two
    nodes when captured: L1 and the trip's test), then L2."""
    from smartedgesensor3dhumanpose_tpu_torch import prior
    from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior, loops

    carry, bones = prior._lm_start(g_in, warm_start, cfg)
    ins = prior._fused_inputs(g_in, bones)
    x, _, _, _, iters, _, _ = loops.while_loop(
        lambda c: c[5], lambda c: lm_prior.lm_trip(c, *ins, cfg), prior._fused_carry(carry),
        cfg.lm_max_iterations)
    x, marg, marg_ok = lm_prior.lm_marginals(x, *ins)
    return prior.PriorResult(x=x, marg_cov=marg, marg_ok=marg_ok, iters=iters)


def phase_lm_trips(dev, smi, rig, cfg, inputs, pipe):
    """13.5: the captured loops against the eager ones. The LM alone at the
    online step's shape (one golden frame's hypotheses): its graph holds no
    WHILE node (L1 and L2 only) and equals the eager LM (0 host syncs) bit
    for bit, the trips it ran on the device (its trip-log record) against
    the eager `iters` and against lm_max_iterations, its device clock, its
    ms per trip run and per trip skipped; beside it the per-trip route (L1 one
    trip a launch in a WHILE node: its body's nodes, ms per trip run) and
    the LM with the plain trip (`prior._lm_trip`, `_fused=False`): its
    body's nodes, device ms per trip and ms per trip run. Then the step's
    replays on golden frames: the trips of its LM and its merge on the
    device against the eager loops' on the same state and frame, the nodes
    of the merge's body, and the step's graph beside one whose merge runs
    every round (nodes, busy ms, wall p50)."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion, graphs, pipeline, prior
    from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior

    frame, _ = pipeline.mask_stale_cameras(frame_at(inputs["adversarial"], 40, dev),
                                           cfg.fusion.max_sync_diff)
    persons = fusion.fuse_frame(frame, rig, cfg.fusion)
    p_cfg = cfg.prior
    g_in = prior.build_graph_inputs(persons, p_cfg)
    carry0, bones = prior._lm_start(g_in, g_in.meas, p_cfg)
    ins = prior._fused_inputs(g_in, bones)
    eye3 = torch.eye(3, dtype=g_in.meas.dtype, device=dev)
    x = carry0[0]

    def plain_trips():
        carry = carry0
        for _ in range(LM_TRIPS):
            carry = prior._lm_trip(carry, g_in, bones, eye3, p_cfg)
        return carry

    def trips():
        carry = tuple(t.clone() for t in prior._fused_carry(carry0))
        for _ in range(LM_TRIPS):
            lm_prior.lm_trip(carry, *ins, p_cfg)
        return carry

    # Device ms per trip from a trace of LM_TRIPS eager single trips (L1
    # capped at one trip: the carry's copies and first test included).
    busy_ms, events, _ = profile_device(trips, 1)
    trip_device_ms = busy_ms / LM_TRIPS
    eager_trip_ms = sync_time(trips, 3) / LM_TRIPS
    plain_busy_ms, plain_events, _ = profile_device(plain_trips, 1)

    def lm_fn(max_iterations, fused=None):
        c = dataclasses.replace(p_cfg, lm_max_iterations=max_iterations)
        return lambda gi, w: prior.optimize(gi, w, c, _fused=fused)

    per_trip_fn = lambda gi, w: per_trip_optimize(gi, w, p_cfg)  # noqa: E731
    early = prior.optimize(g_in, g_in.meas, p_cfg)
    iters = int(early.iters)
    eager_syncs = count_syncs(lambda: prior.optimize(g_in, g_in.meas, p_cfg))
    if eager_syncs:
        raise AssertionError(f"eager LM: {eager_syncs} host syncs")
    plain_iters = int(prior.optimize(g_in, g_in.meas, p_cfg, _fused=False).iters)
    while_bodies = loop_body_nodes(lm_fn(p_cfg.lm_max_iterations), g_in, g_in.meas)
    lm_nodes = graph_nodes(lm_fn(p_cfg.lm_max_iterations), g_in, g_in.meas)
    if while_bodies or lm_nodes["conditional"]:
        raise AssertionError(f"LM graph: WHILE bodies {while_bodies}, nodes {lm_nodes}")
    per_trip_body_nodes = loop_body_nodes(per_trip_fn, g_in, g_in.meas)
    plain_body_nodes = loop_body_nodes(lm_fn(p_cfg.lm_max_iterations, False), g_in, g_in.meas)
    logged, trip_log = captured_with_log(lm_fn(p_cfg.lm_max_iterations), g_in, g_in.meas)
    # The same graph without the trip log, the LM capped at the trips it
    # runs, the per-trip route and the plain trip's.
    lm = graphs.CapturedFunction(lm_fn(p_cfg.lm_max_iterations), "prior.optimize")
    bounded = graphs.CapturedFunction(lm_fn(iters), "prior.optimize")
    per_trip = graphs.CapturedFunction(per_trip_fn, "per-trip LM")
    plain = graphs.CapturedFunction(lm_fn(p_cfg.lm_max_iterations, False), "prior.optimize")
    done = g_in._replace(num_meas=torch.zeros_like(g_in.num_meas))   # every person done
    for name, graph in (("one launch", lm), ("logged", logged), ("bounded", bounded),
                        ("per trip", per_trip)):
        bad, diffs = tree_diff(graph(g_in, g_in.meas), early)
        if bad or any(diffs.values()):
            raise AssertionError(f"LM graph ({name}) differs from the eager LM: {bad} {diffs}")
    logged(g_in, g_in.meas)
    on_device, span_ms = log_trips(trip_log), log_spans_ms(trip_log)[0]
    if on_device != [iters] or iters >= p_cfg.lm_max_iterations:
        raise AssertionError(f"LM graph: {on_device} trips on the device, the eager LM {iters}")
    logged(done, done.meas)
    if log_trips(trip_log) != [0]:
        raise AssertionError("LM graph: trips ran with every person done")
    # The graphs timed in turns, LM_TIMED_ROUNDS rounds; medians.
    runs = {"one_launch": lambda: lm(g_in, g_in.meas), "logged": lambda: logged(g_in, g_in.meas),
            "bounded": lambda: bounded(g_in, g_in.meas), "done": lambda: lm(done, done.meas),
            "per_trip": lambda: per_trip(g_in, g_in.meas),
            "per_trip_done": lambda: per_trip(done, done.meas),
            "plain": lambda: plain(g_in, g_in.meas), "plain_done": lambda: plain(done, done.meas)}
    timed = {name: [] for name in runs}
    for _ in range(LM_TIMED_ROUNDS):
        for name, run in runs.items():
            timed[name].append(sync_time(run, 10))
    ms = {name: statistics.median(v) for name, v in timed.items()}
    done_ms = ms["done"]
    log("13.5 LM trips", gpu=repr(smi), persons=x.shape[0], lm_graph_nodes=nodes_str(lm_nodes),
        lm_while_nodes=0, eager_lm_host_syncs=eager_syncs,
        single_trip_device_ms=trip_device_ms, single_trip_device_events=events / LM_TRIPS,
        single_trip_eager_wall_ms=eager_trip_ms,
        per_trip_route_body_nodes=",".join(map(str, per_trip_body_nodes)),
        plain_trip_body_nodes_per_trip=",".join(map(str, plain_body_nodes)),
        plain_trip_device_ms=plain_busy_ms / LM_TRIPS,
        plain_trip_device_events=plain_events / LM_TRIPS, plain_trip_iters=plain_iters,
        captured_plain_trip_lm_ms=ms["plain"], captured_plain_trip_lm_all_done_ms=ms["plain_done"],
        plain_trip_ms_per_trip_run=(ms["plain"] - ms["plain_done"]) / plain_iters,
        lm_max_iterations=p_cfg.lm_max_iterations, eager_iters=iters,
        trips_on_device=on_device[0], trips_on_device_all_done=0,
        device_clock_ms=span_ms, device_clock_ms_per_trip=span_ms / iters,
        captured_lm_ms=ms["one_launch"], captured_lm_logged_ms=ms["logged"],
        captured_lm_all_done_ms=done_ms, ms_per_trip_run=(ms["one_launch"] - done_ms) / iters,
        bounded_at_iters_ms=ms["bounded"],
        ms_per_trip_skipped=(ms["one_launch"] - ms["bounded"]) / (p_cfg.lm_max_iterations - iters),
        per_trip_route_lm_ms=ms["per_trip"], per_trip_route_all_done_ms=ms["per_trip_done"],
        per_trip_route_ms_per_trip_run=(ms["per_trip"] - ms["per_trip_done"]) / iters,
        captured_vs_eager="equal bit for bit")

    # The step's loops on golden frames, each from the state the captured
    # chain reaches there, against the eager step's loops.
    per_frame = []
    step_fn = lambda s, f: pipeline.step(s, f, rig, cfg)  # noqa: E731
    step_body_nodes = loop_body_nodes(step_fn, pipe.init_state(), frame_at(inputs["benign"], 0, dev))
    logged, trip_log = captured_with_log(step_fn, pipe.init_state(), frame_at(inputs["benign"], 0, dev))
    for scene in SCENES:
        frames = stacked_frames(inputs[scene], dev)
        for f in TRIP_FRAMES:
            state, _ = pipe.run_per_frame_chain(pipe.init_state(), type(frames)(*(x[:f] for x in frames)))
            frame = type(frames)(*(x[f] for x in frames))
            logged(state, frame)
            got = log_trips(trip_log)
            want = eager_trips(lambda: step_fn(state, frame))
            if got != want or len(got) != 2:
                raise AssertionError(f"step {scene} {f}: loops ran {got} trips on the device, eager {want}")
            per_frame.append(f"{scene[0]}{f}:{got[0]}/{got[1]}")

    # The step's graph against one whose merge runs every round (the
    # fixed-trip loops; the LM is one launch in both).
    state = pipe.init_state()
    frame = frame_at(inputs["benign"], 40, dev)
    fixed_step = graphs.CapturedFunction(step_fn, "fixed-trip step")
    with fixed_trips():
        fixed_step(state, frame)
        fixed_nodes = graph_nodes(step_fn, state, frame)
    bad, diffs = tree_diff(fixed_step(state, frame), pipe.step(state, frame))
    if bad or any(diffs.values()):
        raise AssertionError(f"fixed-trip step differs from the captured step: {bad} {diffs}")
    # In turns, FIXED_STEP_TIMED calls each per round; PR 8's idle share
    # (profiler busy over the waited p50) only for the fixed-trip graph,
    # whose trace shows all of its kernels.
    times = {"while": [], "fixed": []}
    for _ in range(2):
        for name, fn in (("while", pipe.step), ("fixed", fixed_step)):
            times[name].append(waited_and_back_to_back(lambda fn=fn: fn(state, frame), FIXED_STEP_TIMED))
    waited = {k: statistics.median(w for w, _ in v) for k, v in times.items()}
    b2b = {k: statistics.median(b for _, b in v) for k, v in times.items()}
    fixed_busy, fixed_events, _ = profile_device(lambda: fixed_step(state, frame), PROFILED_REPLAYS)
    logged(state, frame)
    log("13.5 step loops", gpu=repr(smi), frames_checked=len(per_frame),
        lm_merge_trips_on_device_equal_eager="'" + " ".join(per_frame) + "'",
        merge_body_nodes_per_trip=",".join(map(str, step_body_nodes)),
        timed_frame="benign:40", lm_merge_trips_timed_frame=",".join(map(str, log_trips(trip_log))),
        lm_device_clock_ms_timed_frame=log_spans_ms(trip_log)[0],
        while_waited_p50_ms=waited["while"], while_back_to_back_ms=b2b["while"],
        while_idle_share_at_least=1.0 - b2b["while"] / waited["while"],
        fixed_trips_waited_p50_ms=waited["fixed"], fixed_trips_back_to_back_ms=b2b["fixed"],
        fixed_trips_idle_share_at_least=1.0 - b2b["fixed"] / waited["fixed"],
        fixed_trips_profiler_busy_ms=fixed_busy, fixed_trips_device_events=fixed_events,
        fixed_trips_idle_share_pr8=1.0 - fixed_busy / waited["fixed"],
        fixed_trips_graph_nodes=nodes_str(fixed_nodes))


# --------------------------------------------------------------- phase 14 --
# Every value of FusionConfig.assignment_impl and PriorConfig.solver that the
# JAX package accepts, and the widths past the kernels' own, as routed by
# pipeline.routes.
# K1 past 120 columns: square widths at each routine's boundaries (register
# slots 4 | 5 at 128, 5 | 6 at 160, 7 | 8 at 224, the tile staged up to 240,
# the block routine from 256).
WIDE_K1_SIZES = (121, 127, 128, 159, 160, 223, 224, 255, 256, 257, 1024)
# Batched launches: (B, R, C, share of rows active or None).
WIDE_K1_BATCHED = ((5, 130, 140, None), (3, 128, 128, None), (6, 300, 290, None), (8, 16, 600, 0.5))
# The camera scan's batched solve at max_hypotheses=128: B frames x H
# hypotheses x D detections, a share of the frames needing the solve.
SCAN_SHAPE = (16, 128, 8)
SCAN_NEED = 0.5
# Phase 14.1's cases timed on the card (device ms beside the bound).
WIDE_K1_TIMED = ("rand128", "rand256", "rand1024", "tall128x8", "trivial128x8",
                 "discarded128x8", "scan16x128x8")
# Frames of the adversarial scene the beyond-domain configs run, each held to
# the port's own CPU float32 run of the same frames.
CONFIG_FRAMES = 16
CONFIG_OFFLINE_BATCH = 8
# Captured steps per p50 of a config, timed in turns with the default step.
CONFIG_TIMED = 30


def scan_costs(rng, b: int, h: int, d: int) -> np.ndarray:
    """[B, H, D] float32 costs shaped as the camera scan solves them
    (ops/association.py::_scan_camera): feasible pairs below the gate,
    the rest on the clip tier plus eps (h+1)(d+1)."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import association

    cost = (0.1 * rng.uniform(size=(b, h, d))).astype(np.float32)
    tie = (np.float32(association.SOLVER_TIE_EPS) * (np.arange(h, dtype=np.float32) + 1)[:, None]
           * (np.arange(d, dtype=np.float32) + 1)[None, :])
    tier = np.float32(association.ASSIGN_COST_CLIP) + tie
    return np.where(rng.uniform(size=(b, h, d)) < 0.7, tier[None], cost).astype(np.float32)


def wide_k1_cases() -> list:
    """Phase 14.1's K1 problems past 120 columns, from a seed of their own:
    (name, cost [B, R, C] float32, row_active [B, R] bool or None)."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import association

    rng = np.random.default_rng(14)
    cases = []
    for n in WIDE_K1_SIZES:
        cases.append((f"rand{n}", rng.uniform(size=(1, n, n)), None))
        if n == 1024:
            continue
        half = n // 2
        track = rng.uniform(0.0, 8.0, size=(1, 16, n))
        act = rng.uniform(size=(1, 16)) < 0.5
        track[~act] = 1.0e3
        clipped = rng.uniform(size=(1, half, n))
        clipped[rng.uniform(size=clipped.shape) < 0.4] = association.ASSIGN_COST_CLIP
        cases += [(f"ties{n}", rng.integers(0, 3, size=(1, n, n)).astype(np.float64), None),
                  (f"clip{half}x{n}", clipped, None),
                  (f"tall{n}x{half}", rng.uniform(size=(1, n, half)), None),
                  (f"track16x{n}", track, act),
                  (f"act{n}", rng.uniform(size=(1, n, n)), rng.uniform(size=(1, n)) < 0.7)]
    for b, r, c, share in WIDE_K1_BATCHED:
        act = None if share is None else rng.uniform(size=(b, r)) < share
        cases.append((f"batched{b}x{r}x{c}", rng.uniform(size=(b, r, c)), act))
    # The camera scan's shapes: a needed 128 x 8 solve, the trivial matrix of
    # a discarded one with no mask (every row but the first 9 searches) and
    # with its rows off, and the batched launch with need per frame.
    b, h, d = SCAN_SHAPE
    trivial = (np.arange(h)[:, None] != np.arange(d)[None, :]).astype(np.float32)[None]
    cases += [(f"tall{h}x{d}", scan_costs(rng, 1, h, d), None),
              (f"trivial{h}x{d}", trivial, None),
              (f"discarded{h}x{d}", trivial, np.zeros((1, h), bool))]
    need = rng.uniform(size=b) < SCAN_NEED
    scan = np.where(need[:, None, None], scan_costs(rng, b, h, d), trivial)
    cases.append((f"scan{b}x{h}x{d}", scan, np.repeat(need[:, None], h, axis=1)))
    return [(name, cost.astype(np.float32), act) for name, cost, act in cases]


def wide_k1_reference() -> list:
    """The plain JV's answer to each of wide_k1_cases() on the CPU, and the
    search steps it took: [(col_of_row [B, R] int32, steps)], in a worker
    process."""
    sys.path.insert(0, _ROOT)
    torch.set_num_threads(1)
    from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian

    out = []
    for _, cost, act in wide_k1_cases():
        before = hungarian.PLAIN_SEARCH_STEPS
        want = hungarian.linear_sum_assignment_batched_reference(
            torch.from_numpy(cost), None if act is None else torch.from_numpy(act))
        out.append((want.numpy(), hungarian.PLAIN_SEARCH_STEPS - before))
    return out


def config_variants() -> dict:
    """name -> the PipelineConfig phase 14 runs: demo_16cam with one knob
    changed."""
    from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig, PriorConfig, TrackerConfig

    base = PipelineConfig.demo_16cam()
    f = base.fusion
    return {
        "cond_while": dataclasses.replace(base, fusion=dataclasses.replace(f, assignment_impl="cond_while")),
        "dense": dataclasses.replace(base, prior=PriorConfig(solver="dense")),
        "pallas": dataclasses.replace(base, fusion=dataclasses.replace(f, assignment_impl="pallas")),
        "max_tracks128": dataclasses.replace(base, tracker=TrackerConfig(max_tracks=128)),
        "max_hypotheses128": dataclasses.replace(base, fusion=dataclasses.replace(f, max_hypotheses=128)),
        "max_tracks12": dataclasses.replace(base, tracker=TrackerConfig(max_tracks=12)),
    }


def output_record(out) -> dict:
    """The decisions and joints of a StepOutput (one frame, or stacked) as
    numpy arrays."""
    def np_(x):
        return x.detach().cpu().numpy()

    return {
        "raw_valid": np_(out.persons_raw.valid), "fused_valid": np_(out.fused.valid),
        "fused_id": np_(out.fused.person_id), "pred_valid": np_(out.fused_pred.valid),
        "fb_kp_valid": np_(out.feedback.kp_valid),
        "n_dropped_hyp": np_(out.n_dropped_hypotheses),
        "n_dropped_spawns": np_(out.n_dropped_track_spawns),
        "raw_xyz": np_(out.persons_raw.xyz), "fused_xyz": np_(out.fused.xyz),
        "pred_xyz": np_(out.fused_pred.xyz),
    }


def record_diff(got: dict, want: dict) -> tuple:
    """(decision fields that differ, worst joint difference in m over the
    persons both sides publish)."""
    bad = [k for k, v in got.items() if not k.endswith("xyz") and not np.array_equal(v, want[k])]
    worst = 0.0
    for key, valid in (("raw_xyz", "raw_valid"), ("fused_xyz", "fused_valid"), ("pred_xyz", "pred_valid")):
        on = got[valid] & want[valid]
        worst = max(worst, float(np.abs(got[key] - want[key])[on].max(initial=0.0)))
    return bad, worst


def config_run(name: str, device: str) -> list:
    """One phase-14 config over the adversarial scene on `device`: the
    online steps (one record per frame), or for max_tracks12 one offline
    replay of CONFIG_FRAMES frames, and for dense every frame of the scene."""
    from smartedgesensor3dhumanpose_tpu_torch import cameras, pipeline

    cfg = config_variants()[name]
    golden = np.load(GOLDEN)
    data = scene_data(json.loads(str(golden["adversarial/scene"])), cfg.fusion.max_dets_per_cam)
    frames = data["kp2d"].shape[0] if name == "dense" else CONFIG_FRAMES
    dev = torch.device(device)
    pipe = pipeline.Pipeline(cameras.hall_rig(16, device=dev), cfg, device=dev,
                             fusion_batch=CONFIG_OFFLINE_BATCH)
    if name == "max_tracks12":
        stacked = stacked_frames({k: v[:frames] for k, v in data.items()}, dev)
        return [output_record(pipe.run_offline(pipe.init_state(), stacked)[1])]
    state, records = pipe.init_state(), []
    for f in range(frames):
        state, out = pipe.step(state, frame_at(data, f, dev))
        records.append(output_record(out))
    return records


def cpu_reference(name: str) -> list:
    """config_run on the CPU (the plain versions), in a worker process."""
    sys.path.insert(0, _ROOT)
    torch.set_num_threads(1)
    return config_run(name, "cpu")


CPU_REFERENCES = ("max_hypotheses128", "max_tracks128", "max_tracks12", "dense")


def start_cpu_references():
    """A pool of worker processes computing the CPU references of phase 14
    while the earlier phases run on the card: each config's run and
    ("wide_k1") the plain JV on phase 14.1's problems; (pool, {name:
    AsyncResult})."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(len(CPU_REFERENCES) + 1)
    refs = {name: pool.apply_async(cpu_reference, (name,)) for name in CPU_REFERENCES}
    refs["wide_k1"] = pool.apply_async(wide_k1_reference)
    return pool, refs


def phase_wide_k1(dev, smi, references):
    """K1 past 120 columns (register slots up to 255, the block routine past
    it) against its plain version on wide_k1_cases(), bit for bit, and its
    totals against scipy; its device time against its bound on the
    WIDE_K1_TIMED cases. Returns {case: (device ms, bound ms, bound by)}."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian

    cases = wide_k1_cases()
    wants = references["wide_k1"].get()
    checked = 0
    times, traced_ms = {}, {}
    for (name, cost, act), (want, steps) in zip(cases, wants):
        c_dev = torch.from_numpy(cost).to(dev)
        a_dev = None if act is None else torch.from_numpy(act).to(dev)
        got = hungarian.linear_sum_assignment_batched(c_dev, a_dev).cpu().numpy()
        if not np.array_equal(got, want):
            bad = [i for i in range(len(got)) if not np.array_equal(got[i], want[i])]
            raise AssertionError(f"K1 wide {name} {hungarian.jv_plan(*cost.shape)}: kernel != plain "
                                 f"on problems {bad}")
        for i in range(cost.shape[0]):
            check_k1_total(f"wide {name}[{i}]", cost[i], None if act is None else act[i], got[i])
        checked += cost.shape[0]
        if name not in WIDE_K1_TIMED:
            continue
        # Device ms by CUDA events around back-to-back launches (the host
        # overhead is µs); the profiler's per-launch time beside it where its
        # trace holds the launches; the bound as k1_bound counts it, from the
        # steps these inputs took the plain version.
        b, r, c = cost.shape
        n = max(r, c)
        fn = lambda c_dev=c_dev, a_dev=a_dev: hungarian.linear_sum_assignment_batched(c_dev, a_dev)
        nbytes = cost.nbytes + (0 if act is None else act.nbytes) + b * r * 4
        times[name] = (sync_time(fn, 5),) + bound_of(nbytes, b * r * n + steps * n * 4)
        durs = kernel_durations(fn, "jv_assign", 5)
        traced_ms[name] = statistics.median(durs) / 1e3 if durs else "not_in_trace"
    plain_128 = sync_time(lambda: hungarian.linear_sum_assignment_reference(
        torch.from_numpy(next(c for nm, c, _ in cases if nm == "rand128")[0]).to(dev)), 1)
    log("14.1 K1 wide", gpu=repr(smi), problems=checked, vs_plain="equal bit for bit",
        scipy_totals="equal", plans="'" + " ".join(
            f"{nm}:{tuple(hungarian.jv_plan(*cs.shape))}" for nm, cs, _ in cases
            if nm in WIDE_K1_TIMED) + "'",
        **{f"device_ms_{k}": t[0] for k, t in times.items()},
        **{f"profiler_ms_{k}": v for k, v in traced_ms.items()},
        **{f"bound_ms_{k}": t[1] for k, t in times.items()},
        bound_by="'" + " ".join(f"{k}:{t[2]}" for k, t in times.items()) + "'",
        timed_by="cuda_events", plain_ms_n128_on_card=plain_128)
    return times


def replay_counts(fn):
    """(fn(), (K1, K2, K3, L1, L2) kernels on the device during fn(), or None when
    the profiler's trace of it holds no device event at all; then the
    first call's host counts, which record the captured kernels, are the
    evidence)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not names:
        return result, None
    return result, tuple(sum(kernel_index(n) == i for n in names) for i in range(N_KERNELS))


# A replay's kernels where the profiler's trace held no device event:
# null in the kernels line.
NOT_IN_TRACE = (None,) * N_KERNELS


def check_replay_counts(what: str, counts, want) -> None:
    """`want`: the first len(want) entries of a replay's device counts."""
    if counts is not None and tuple(counts[:len(want)]) != tuple(want):
        raise AssertionError(f"{what}: {counts} kernels per replay on the device, expected {want}")


def captured_config_steps(dev, pipe, golden, inputs, gate_scenes):
    """A Pipeline's captured step over both golden scenes: every frame
    against the golden (gated on `gate_scenes`, reported on the others),
    captured against the eager step bit for bit on two frames per scene,
    and one replay's kernels on the device. Returns (worst m on gated
    scenes, {scene: departing frames}, (K1, K2, K3, L1, L2) of one replay)."""
    from smartedgesensor3dhumanpose_tpu_torch import pipeline

    worst, departs, on_device = 0.0, {}, None
    for scene in SCENES:
        data = inputs[scene]
        state = pipe.init_state()
        departs[scene] = []
        for f in range(data["kp2d"].shape[0]):
            frame = frame_at(data, f, dev)
            if f in (5, 40):
                eager = pipeline.step(state, frame, pipe.rig, pipe.config)
                reset_counts()
                (new_state, out), counts = replay_counts(lambda: pipe.step(state, frame))
                host_launches_none(f"{scene} {f}")
                bad, diffs = tree_diff((new_state, out), eager)
                if bad or any(diffs.values()):
                    raise AssertionError(f"{scene} {f}: captured != eager: {bad} {diffs}")
                on_device = counts
            else:
                new_state, out = pipe.step(state, frame)
            state = new_state
            if scene in gate_scenes:
                worst = max(worst, *compare_step(out, golden, scene, f))
            elif step_mismatch(out, golden, scene, f)[0]:
                departs[scene].append(f)
    return worst, departs, on_device


def phase_configs(dev, smi, golden, rig, inputs, pipe, off_pipe, references):
    """Phase 14. Returns the kernels' launches by path and K1 wide's times."""
    from smartedgesensor3dhumanpose_tpu_torch import pipeline

    variants = config_variants()
    paths = {}

    # 14.2 the camera scan online ("cond_while"): every golden decision.
    scan = pipeline.Pipeline(rig, variants["cond_while"], device=dev)
    if scan.routes != ("scan", "kernel"):
        raise AssertionError(f"cond_while routes {scan.routes}")
    reset_counts()
    (_, _), first_s, first_mib = first_call(lambda: scan.step(scan.init_state(), frame_at(inputs["benign"], 0, dev)))
    first_host = read_counts()
    worst, _, on_device = captured_config_steps(dev, scan, golden, inputs, SCENES)
    c = variants["cond_while"].fusion.num_cameras
    check_replay_counts("cond_while step", on_device, (c + 1, 0, 0))
    if first_host[:3] != (FIRST_CALL_HOST_LAUNCHES * (c + 1), 0, 0):
        raise AssertionError(f"cond_while: first call's host launches {first_host}")
    paths["step_cond_while"] = first_host
    paths["step_cond_while_replay_on_device"] = on_device or NOT_IN_TRACE

    # 14.3 the dense LM solver online: captured equals eager; the benign
    # scene exact against the golden; the adversarial scene's departures
    # reported and held to the port's CPU dense run (ROADMAP C2: its float32
    # LM does not converge on the ghosts, and the golden is the tree's).
    dense = pipeline.Pipeline(rig, variants["dense"], device=dev)
    reset_counts()
    first_call(lambda: dense.step(dense.init_state(), frame_at(inputs["benign"], 0, dev)))
    paths["step_dense"] = read_counts()
    if paths["step_dense"] != (FIRST_CALL_HOST_LAUNCHES,) * 2 + (0, 0, 0, FIRST_CALL_HOST_LAUNCHES):
        raise AssertionError(f"dense: first call's host launches {paths['step_dense']}")
    dense_worst, departs, dense_dev = captured_config_steps(dev, dense, golden, inputs, ("benign",))
    check_replay_counts("dense step", dense_dev, (1, 1, 0, 0, 0))
    paths["step_dense_replay_on_device"] = dense_dev or NOT_IN_TRACE
    cpu_dense = references["dense"].get()
    card_dense = config_run("dense", str(dev))
    dense_vs_cpu = [f for f, (g, w) in enumerate(zip(card_dense, cpu_dense)) if record_diff(g, w)[0]]
    dense_vs_cpu_m = max(record_diff(g, w)[1] for g, w in zip(card_dense, cpu_dense))

    # Step p50s in turns: the default (K2, tree), the scan, the dense solver.
    state = pipe.init_state()
    frames = [frame_at(inputs["benign"], f, dev) for f in range(CONFIG_TIMED)]
    ms = {"default": [], "cond_while": [], "dense": []}
    for _ in range(2):
        for name, p in (("default", pipe), ("cond_while", scan), ("dense", dense)):
            st = p.init_state()
            for frame in frames:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = p.step(st, frame)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    p50 = {k: statistics.median(v) for k, v in ms.items()}
    log("14.2 camera scan step", gpu=repr(smi), routes=repr(scan.routes), frames=128,
        decisions="exact", worst_mm=worst * 1e3, captured_vs_eager="equal bit for bit",
        first_call_s=first_s, first_call_reserved_mib=first_mib, host_launches_first_call=list(first_host),
        device_launches_per_replay=on_device or "not_in_trace", step_p50_ms=p50["cond_while"],
        default_step_p50_ms=p50["default"])
    log("14.3 dense step", gpu=repr(smi), benign="exact", benign_worst_mm=dense_worst * 1e3,
        captured_vs_eager="equal bit for bit", device_launches_per_replay=dense_dev or "not_in_trace",
        adversarial_frames_departing_golden=",".join(map(str, departs["adversarial"])) or "none",
        adversarial_frames_departing_cpu_dense=",".join(map(str, dense_vs_cpu)) or "none",
        adversarial_worst_mm_vs_cpu_dense=dense_vs_cpu_m * 1e3,
        step_p50_ms=p50["dense"], tree_step_p50_ms=p50["default"])
    if dense_vs_cpu:
        raise AssertionError(f"dense: the card departs from the CPU's dense run on frames {dense_vs_cpu}")

    # 14.4 run_offline with "pallas": one batched K1 per camera of each chunk
    # on the device, the association equal to K2's.
    pallas = pipeline.Pipeline(rig, variants["pallas"], device=dev, fusion_batch=OFFLINE_FUSION_BATCH)
    reset_counts()
    first_call(lambda: pallas.run_offline(pallas.init_state(), stacked_frames(inputs["benign"], dev)))
    paths["run_offline_pallas"] = read_counts()
    for scene in SCENES:
        frames = stacked_frames(inputs[scene], dev)
        chunks = -(-frames.kp2d.shape[0] // OFFLINE_FUSION_BATCH)
        if scene == SCENES[0] and paths["run_offline_pallas"][:3] != tuple(
                FIRST_CALL_HOST_LAUNCHES * k for k in (c * chunks, 0, 1)):
            raise AssertionError(f"pallas run_offline: first call's host launches {paths['run_offline_pallas']}")
        reset_counts()
        (_, got), counts = replay_counts(lambda: pallas.run_offline(pallas.init_state(), frames))
        host_launches_none(f"pallas run_offline {scene}")
        check_replay_counts(f"pallas run_offline {scene}", counts, (c * chunks, 0, 1))
        _, want = off_pipe.run_offline(off_pipe.init_state(), frames)
        bad, diffs = tree_diff(got, want)
        if bad or any(diffs.values()):
            raise AssertionError(f"pallas run_offline {scene} != K2's run: {bad} {diffs}")
        paths["run_offline_pallas_replay_on_device"] = counts or NOT_IN_TRACE
    log("14.4 pallas run_offline", scenes=len(SCENES), device_launches_per_replay=counts or "not_in_trace",
        vs_k2_run="equal bit for bit")

    # 14.5 the beyond-domain configs against the port's CPU run.
    # Kernels per replay: the step of max_tracks128 and max_hypotheses128,
    # run_offline over CONFIG_FRAMES frames for max_tracks12.
    expect = {"max_tracks128": (1, 1, 0), "max_hypotheses128": (c + 1, 0, 0),
              "max_tracks12": (CONFIG_FRAMES, -(-CONFIG_FRAMES // CONFIG_OFFLINE_BATCH), 0)}
    summary, pipes = {}, {}
    for name, want_dev in expect.items():
        cfg = variants[name]
        p = pipes[name] = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=CONFIG_OFFLINE_BATCH)
        reset_counts()
        card = config_run(name, str(dev))
        paths[name] = read_counts()
        data = {k: v[:CONFIG_FRAMES] for k, v in inputs["adversarial"].items()}
        # The card's run captured one graph: its first call's host counts
        # are twice the kernels of a replay.
        if paths[name][:3] != tuple(FIRST_CALL_HOST_LAUNCHES * k for k in want_dev):
            raise AssertionError(f"{name}: first call's host launches {paths[name]}, per replay {want_dev}")
        if name == "max_tracks12":
            stacked = stacked_frames(data, dev)
            p.run_offline(p.init_state(), stacked)
            reset_counts()
            _, counts = replay_counts(lambda: p.run_offline(p.init_state(), stacked))
        else:
            state = p.init_state()
            p.step(state, frame_at(data, 0, dev))
            reset_counts()
            _, counts = replay_counts(lambda: p.step(state, frame_at(data, 0, dev)))
        host_launches_none(name)
        check_replay_counts(name, counts, want_dev)
        paths[f"{name}_replay_on_device"] = counts or NOT_IN_TRACE
        cpu = references[name].get()
        worst = 0.0
        for f, (g, w) in enumerate(zip(card, cpu)):
            bad, d = record_diff(g, w)
            if bad or d > JOINT_TOL_M:
                raise AssertionError(f"{name} record {f}: card vs CPU: {bad}, {d * 1e3:.4f} mm")
            worst = max(worst, d)
        summary[name] = f"{p.routes.association}/{p.routes.tracker}:{worst * 1e3:.4f}mm"
    # Step p50s in turns: the default step and the two 128-slot configs
    # (K1 past 120 columns: once per step with max_tracks=128, once per
    # camera and once for the tracker with max_hypotheses=128).
    timed = {"default": pipe, "max_tracks128": pipes["max_tracks128"],
             "max_hypotheses128": pipes["max_hypotheses128"]}
    frames = [frame_at(inputs["benign"], f, dev) for f in range(CONFIG_TIMED)]
    ms = {k: [] for k in timed}
    for _ in range(2):
        for name, p in timed.items():
            st = p.init_state()
            for frame in frames:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = p.step(st, frame)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    log("14.5 beyond the kernels' domains", gpu=repr(smi), frames=CONFIG_FRAMES,
        vs_cpu_float32="decisions exact",
        routes_and_worst="'" + " ".join(f"{k}={v}" for k, v in summary.items()) + "'",
        device_launches_per_replay="'" + " ".join(
            f"{k}={list(paths[k + '_replay_on_device'])}" for k in expect) + "'",
        **{f"step_p50_ms_{k}": statistics.median(v) for k, v in ms.items()},
        **{f"step_p90_ms_{k}": quantiles(v)["p90"] for k, v in ms.items()})
    return paths


# --------------------------------------------------------------- phase 15 --
# Kernels L1 (the LM in one launch) and L2 (the tree marginals), csrc/lm_prior.cu,
# against their twins (ops/lm_prior.py) bit for bit, on the person batches
# the main paths hand the LM: the online step's (P = H = 16) on TRIP_FRAMES
# of both scenes, each offline chunk of both scenes (P = 32 x 16 = 512) and
# the scaled layout's first chunks (P = 4 x 40 = 160).
LM_SCALED_CHUNKS = 2
# Launches per timed kernel (each L1 launch from the batch's cold start),
# and LMs of one trip a launch whose launches are summed.
LM_TIMED = 50
LM_LOOPS_TIMED = 5


def lm_batches(dev, rig, cfg, inputs, scaled) -> dict:
    """{case: GraphInputs} of the batches phase 15 checks."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion, pipeline, prior
    from smartedgesensor3dhumanpose_tpu_torch.types import Persons3D

    def chunks(frames, c_rig, c_cfg, batch, n):
        persons, _, _ = pipeline.fuse_offline(frames, c_rig, c_cfg, batch)
        for lo in range(0, min(n * batch, persons.xyz.shape[0]), batch):
            flat = Persons3D(*(x[lo:lo + batch].flatten(0, 1) for x in persons))
            yield lo, prior.build_graph_inputs(flat, c_cfg.prior)

    out = {}
    for scene in SCENES:
        for f in TRIP_FRAMES:
            frame, _ = pipeline.mask_stale_cameras(frame_at(inputs[scene], f, dev),
                                                   cfg.fusion.max_sync_diff)
            out[f"{scene}{f}"] = prior.build_graph_inputs(
                fusion.fuse_frame(frame, rig, cfg.fusion), cfg.prior)
        frames = stacked_frames(inputs[scene], dev)
        for lo, g_in in chunks(frames, rig, cfg, OFFLINE_FUSION_BATCH, 64):
            out[f"{scene}_chunk{lo}"] = g_in
    s_cfg, s_rig, s_frames = scaled
    for lo, g_in in chunks(s_frames, s_rig, s_cfg, SCALED_FUSION_BATCH, LM_SCALED_CHUNKS):
        out[f"scaled_chunk{lo}"] = g_in
    return out


def check_lm_batch(name: str, g_in, p_cfg) -> dict:
    """The LM of one batch from its cold start: the one-launch LM against
    its twin (`lm_solve_plain`) and against L1 capped at one trip a launch
    (the per-trip loop, with the host's test), that loop against `lm_trip_plain`
    after every trip (the whole carry: x, err, lam, done, iters and the
    loop's test equal, L1's scratch zero again), then L2 against its twin
    at the final x; and the LM with the plain trip (`_fused=False`) beside
    it."""
    from smartedgesensor3dhumanpose_tpu_torch import prior
    from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior

    def same(what, got, want):
        bad, diffs = tree_diff(got[:6], want[:6])
        if bad or any(diffs.values()) or got[6].tolist() != [0, 0]:
            raise AssertionError(f"L1 {name} {what}: {bad} {diffs}, scratch {got[6].tolist()}")

    carry, bones = prior._lm_start(g_in, g_in.meas, p_cfg)
    ins = prior._fused_inputs(g_in, bones)
    start = prior._fused_carry(carry)
    one = lm_prior.lm_solve(tuple(t.clone() for t in start), *ins, p_cfg)
    same("one launch vs lm_solve_plain", one, lm_prior.lm_solve_plain(start, *ins, p_cfg))
    want = start
    got = tuple(t.clone() for t in want)
    trips = warp_trips = 0
    while bool(want[5]) and trips < p_cfg.lm_max_iterations:
        warp_trips += int((~want[3]).sum())
        got = lm_prior.lm_trip(got, *ins, p_cfg)
        want = lm_prior.lm_trip_plain(want, *ins, p_cfg)
        trips += 1
        same(f"trip {trips}", got, want)
    same("one launch vs one trip a launch", one, got)
    marg = lm_prior.lm_marginals(got[0], *ins)
    bad, diffs = tree_diff(marg, lm_prior.lm_marginals_plain(got[0], *ins))
    if bad or any(diffs.values()):
        raise AssertionError(f"L2 {name}: {bad} {diffs}")
    plain = prior.optimize(g_in, g_in.meas, p_cfg, _fused=False)
    fused = prior.optimize(g_in, g_in.meas, p_cfg)
    bad, diffs = tree_diff(fused, (marg[0], marg[1], marg[2], got[4]))
    if bad or any(diffs.values()):
        raise AssertionError(f"optimize {name} differs from L1 and L2 run by hand: {bad} {diffs}")
    return {"persons": g_in.meas.shape[0], "trips": trips, "warp_trips": warp_trips,
            "iters": int(got[4]), "done": int(got[3].sum()),
            "plain_trip_iters": int(plain.iters),
            "vs_plain_trip_max_abs_m": float((fused.x - plain.x).abs().max())}


def phase_lm_kernels(dev, smi, rig, cfg, inputs, scaled) -> tuple:
    """15: L1 and L2 against their twins on every batch of lm_batches, bit
    for bit; their device ms (torch.profiler) at the step's shape and the
    offline chunk's: the one-launch LM, one trip, the LM one trip a launch
    (the per-trip loop, its launches summed) and L2; the twins' ms, the bounds.
    Returns (times for the kernels line, largest difference)."""
    from smartedgesensor3dhumanpose_tpu_torch import prior
    from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior

    p_cfg = cfg.prior
    batches = lm_batches(dev, rig, cfg, inputs, scaled)
    report = {name: check_lm_batch(name, g_in, scaled[0].prior if name.startswith("scaled")
                                   else p_cfg)
              for name, g_in in batches.items()}
    times = {}
    for shape, name in (("step", "adversarial40"), ("chunk", "adversarial_chunk0")):
        g_in = batches[name]
        carry, bones = prior._lm_start(g_in, g_in.meas, p_cfg)
        start = prior._fused_carry(carry)
        ins = prior._fused_inputs(g_in, bones)
        work = tuple(t.clone() for t in start)

        def reset(work=work, start=start):
            for w, t in zip(work, start):
                w.copy_(t)

        def solve(work=work, ins=ins):
            reset()
            lm_prior.lm_solve(work, *ins, p_cfg)

        def trip(work=work, ins=ins):
            reset()
            lm_prior.lm_trip(work, *ins, p_cfg)

        def per_trip(work=work, ins=ins):
            reset()
            launches = 0
            while bool(work[5]) and launches < p_cfg.lm_max_iterations:
                lm_prior.lm_trip(work, *ins, p_cfg)
                launches += 1

        p = g_in.meas.shape[0]
        running = int((~start[3]).sum())
        iters, warp_trips = report[name]["iters"], report[name]["warp_trips"]
        l1 = kernel_durations(solve, "lm_trip_kernel", LM_TIMED)
        l1_trip = kernel_durations(trip, "lm_trip_kernel", LM_TIMED)
        l1_loop = kernel_durations(per_trip, "lm_trip_kernel", LM_LOOPS_TIMED)
        l2 = kernel_durations(lambda: lm_prior.lm_marginals(start[0], *ins), "lm_marginals_kernel",
                              LM_TIMED)
        lm_ms = statistics.median(l1) / 1e3 if l1 else None
        times[shape] = {
            "persons": p, "running": running, "iters": iters, "warp_trips": warp_trips,
            "l1_lm_device_ms": lm_ms, "l1_lm_launches_traced": len(l1),
            "l1_lm_device_ms_per_trip": lm_ms / iters if lm_ms else None,
            "l1_lm_wrapper_ms_with_copies": sync_time(solve, LM_TIMED),
            "l1_lm_twin_ms": sync_time(lambda: lm_prior.lm_solve_plain(start, *ins, p_cfg), 3),
            "l1_lm_bound": bound_of(lm_prior.trip_bytes(running, p),
                                    lm_prior.TRIP_OPS_PER_PERSON * warp_trips),
            "l1_trip_device_ms": statistics.median(l1_trip) / 1e3 if l1_trip else None,
            "l1_trip_twin_ms": sync_time(lambda: lm_prior.lm_trip_plain(start, *ins, p_cfg), 3),
            "l1_trip_bound": bound_of(lm_prior.trip_bytes(running, p),
                                      lm_prior.TRIP_OPS_PER_PERSON * running),
            "l1_one_trip_a_launch_lm_device_ms": (sum(l1_loop) / 1e3 / LM_LOOPS_TIMED
                                                  if len(l1_loop) == iters * LM_LOOPS_TIMED
                                                  else None),
            "l1_one_trip_a_launch_launches_traced": len(l1_loop),
            "l2_device_ms": statistics.median(l2) / 1e3 if l2 else None,
            "l2_wrapper_ms": sync_time(lambda: lm_prior.lm_marginals(start[0], *ins), LM_TIMED),
            "l2_twin_ms": sync_time(lambda: lm_prior.lm_marginals_plain(start[0], *ins), 3),
            "l2_bound": bound_of(lm_prior.marginals_bytes(p), lm_prior.MARG_OPS_PER_PERSON * p),
        }
    log("15 lm kernels", gpu=repr(smi), batches=len(report), vs_twins="equal bit for bit",
        one_launch_vs_one_trip_a_launch="equal bit for bit", iters_and_done="equal",
        cases="'" + json.dumps(report) + "'", times="'" + json.dumps(times) + "'")
    step = times["step"]
    return {
        "lm_trip": (step["l1_lm_device_ms"], step["l1_lm_twin_ms"]) + step["l1_lm_bound"],
        "lm_marginals": (step["l2_device_ms"], step["l2_twin_ms"]) + step["l2_bound"],
    }, 0.0


# ---------------------------------------------------------------- phase 16 --

# Float operations of F1's pieces (a multiply-add counts two): a 4x4
# solve; a view's weighted and unweighted coefficients, contributions and
# sums; a sigma-point slot's six weighted products; the base point's
# covariance term; one reprojection; the three-view scores; one present
# view's four sigma points (Cholesky, offsets, coefficients, the change of
# the contribution, solve, offset from the mean); a fusion joint's gates.
# The work every view runs is portbench/counts/F1.py's.
F1_SOLVE_OPS = 352
F1_VIEW_OPS = 257
F1_COV_TERM_OPS = 18
F1_COV_OPS = 32
F1_REPROJ_OPS = 29
F1_THREE_VIEW_OPS = 3 * 51
F1_SIGMA_VIEW_OPS = 5 + 6 + 23 + 4 * (2 + 23 + 5 + 90 + 10 + F1_SOLVE_OPS + 3)
F1_GATE_OPS = 40
F1_TIMED = 50


def f1_bound(kp, cam_mask, drops, f_cfg) -> tuple:
    """(bound ms, what bounds it) of one F1 launch on these hypotheses: its
    inputs read and its persons written once; per joint the work of every
    view (contributions, sums, the base and UT solves, the covariance's
    sums) and of the k views present (kf after the drop): k reprojections,
    k leave-one-out solves of k - 1 reprojections each, the three-view
    scores where k = 3, kf views' sigma points; per fusion joint the
    gates."""
    n, c = cam_mask.shape
    conf = kp.transpose(1, 2)[..., 2]
    k = (cam_mask[:, None, :] & (conf >= f_cfg.min_kp_score)).sum(-1).double()
    kf = k - (drops >= 0).double()
    every = c * F1_VIEW_OPS + 2 * F1_SOLVE_OPS + c + 4 * c * F1_COV_TERM_OPS + F1_COV_OPS
    present = (k * F1_REPROJ_OPS + k * (10 + F1_SOLVE_OPS + (k - 1).clamp(min=0) * F1_REPROJ_OPS)
               + (k == 3).double() * F1_THREE_VIEW_OPS + kf * F1_SIGMA_VIEW_OPS)
    ops = float((every + present).sum()) + n * 21 * F1_GATE_OPS
    nbytes = n * c * (2 * 17 * 3 * 4 + 1) + c * 12 * 4 + c * c * 9 * 4 + n * (21 * 13 * 4 + 5)
    return bound_of(nbytes, ops)


def f1_hypotheses(data: dict, frames, rig, cfg, dev):
    """The flattened hypotheses of `frames` of a scene, as the fusion hands
    them to the triangulation (one chunk through K2 on the card)."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion, pipeline

    f_cfg = cfg.fusion
    sub = stacked_frames({k: v[frames] for k, v in data.items()}, dev)
    sub, _ = pipeline.mask_stale_cameras(sub, f_cfg.max_sync_diff)
    kp_n, cov_n, det_ok = fusion.normalize_frame(sub, rig, f_cfg)
    hyps = fusion.associate(kp_n, cov_n, sub.det_score, det_ok, rig, f_cfg)
    return hyps._replace(**{k: getattr(hyps, k).flatten(0, 1)
                            for k in ("kp", "cov", "cam_mask", "obs_score")})


def check_f1_call(what: str, hyps, rig, rig64, f_cfg) -> tuple:
    """F1 on `hyps` against its host build (bit for bit) and the plain
    body on the card (decisions equal). Returns (drops, largest |F1 -
    plain float32|, {field: (F1 - plain float64, plain float32 - plain
    float64)}, whether the host build equals the plain body on this
    machine's CPU bit for bit)."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion
    from smartedgesensor3dhumanpose_tpu_torch.ops import triangulation_kernel as tk

    n = hyps.kp.shape[0]
    drops = torch.full((n, 17), -2, dtype=torch.int32, device=hyps.kp.device)
    got = tk.triangulate(hyps.kp, hyps.cov, hyps.cam_mask, rig.P, rig.F, f_cfg, drops=drops)
    cpu = [t.cpu() for t in (hyps.kp, hyps.cov, hyps.cam_mask, rig.P, rig.F)]
    host_drops = torch.empty((n, 17), dtype=torch.int32)
    host = tk.triangulate(*cpu, f_cfg, drops=host_drops, host=True)
    for name, a, b in zip(got._fields + ("drops",), tuple(got) + (drops,),
                          tuple(host) + (host_drops,)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"F1 {what} {name}: the card differs from the host build")
    cpu_hyps = hyps._replace(kp=cpu[0], cov=cpu[1], cam_mask=cpu[2])
    cpu_rig = rig._replace(**{k: getattr(rig, k).cpu() for k in rig._fields})
    cpu_plain = fusion._triangulate_plain(cpu_hyps, cpu_rig, f_cfg)
    cpu_equal = all(torch.equal(a, b) for a, b in zip(host, cpu_plain))
    plain, plain_drops = fusion._triangulate_plain(hyps, rig, f_cfg, with_drops=True)
    h64 = hyps._replace(kp=hyps.kp.double(), cov=hyps.cov.double())
    plain64 = fusion._triangulate_plain(h64, rig64, f_cfg)
    for name, a, b in (("valid", got.valid, plain.valid),
                       ("joint score > 0", got.score > 0, plain.score > 0),
                       ("dropped view", drops, plain_drops.to(torch.int32))):
        if not torch.equal(a, b):
            raise AssertionError(f"F1 {what}: {name} differs from the plain body on the card")
    err = 0.0
    diffs = {}
    for name in ("xyz", "score", "cov"):
        a, b, w = getattr(got, name), getattr(plain, name), getattr(plain64, name)
        diffs[name] = ((a.double() - w).flatten().cpu(), (b.double() - w).flatten().cpu())
        err = max(err, float((a - b).abs().max()))
    return drops, err, diffs, cpu_equal


def check_f1_accuracy(what: str, diffs: list) -> tuple:
    """F1 no further from the plain body in float64 than the float32 plain
    body on the card, over a scene's calls of one shape: twice over in the
    root mean square, four times at the worst entry (a covariance entry is
    a sum of sigma-point scatters that cancel, whose rounding the order of
    the sum decides). Returns (F1's worst, the plain body's worst)."""
    mine = ref = 0.0
    for name in ("xyz", "score", "cov"):
        d_mine = torch.cat([d[name][0] for d in diffs])
        d_ref = torch.cat([d[name][1] for d in diffs])
        rms_mine, rms_ref = float(d_mine.square().mean().sqrt()), float(d_ref.square().mean().sqrt())
        worst_mine, worst_ref = float(d_mine.abs().max()), float(d_ref.abs().max())
        if rms_mine > 2 * rms_ref or worst_mine > 4 * worst_ref:
            raise AssertionError(f"F1 {what} {name}: {rms_mine:.3e} rms, {worst_mine:.3e} worst "
                                 f"from float64; the plain body {rms_ref:.3e}, {worst_ref:.3e}")
        mine, ref = max(mine, worst_mine), max(ref, worst_ref)
    return mine, ref


def phase_f1(dev, smi, rig, cfg, inputs) -> tuple:
    """16: F1 against its host build and the plain body on the card, at
    the step's shape and the offline chunk's, and their times. Returns
    (the kernels line's times, largest |F1 - plain float32|)."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion
    from smartedgesensor3dhumanpose_tpu_torch.ops import triangulation_kernel as tk

    f_cfg = cfg.fusion
    rig64 = rig._replace(**{k: getattr(rig, k).double() for k in rig._fields})
    err = mine = ref = 0.0
    calls = {"step": 0, "chunk": 0}
    cpu_equal = {"step": 0, "chunk": 0}
    dropped = 0
    timed = {}
    for scene in SCENES:
        data = inputs[scene]
        frames = data["kp2d"].shape[0]
        for shape, size in (("step", 1), ("chunk", 32)):
            diffs = []
            for f0 in range(0, frames - size + 1, size):
                hyps = f1_hypotheses(data, slice(f0, f0 + size), rig, cfg, dev)
                drops, e, d, equal = check_f1_call(f"{shape} {scene}:{f0}", hyps, rig, rig64,
                                                   f_cfg)
                err = max(err, e)
                diffs.append(d)
                calls[shape] += 1
                cpu_equal[shape] += equal
                dropped += int((drops >= 0).sum()) if shape == "step" else 0
                if scene == "adversarial" and f0 == (8 if shape == "step" else 0):
                    timed[shape] = (hyps, drops)
            m, r = check_f1_accuracy(f"{shape} {scene}", diffs)
            mine, ref = max(mine, m), max(ref, r)
    if dropped == 0:
        raise AssertionError("F1: the golden steps dropped no view")
    times = {}
    for shape, (hyps, drops) in timed.items():
        args = (hyps.kp, hyps.cov, hyps.cam_mask, rig.P, rig.F, f_cfg)
        durations = kernel_durations(lambda args=args: tk.triangulate(*args), "triangulation_kernel",
                                     F1_TIMED)
        ms = statistics.median(durations) / 1e3 if durations else None
        plain_ms = sync_time(lambda hyps=hyps: fusion._triangulate_plain(hyps, rig, f_cfg), 5)
        bound_ms, bound_by = f1_bound(hyps.kp, hyps.cam_mask, drops, f_cfg)
        times[shape] = {"hypotheses": hyps.kp.shape[0], "device_ms": ms,
                        "launches_traced": len(durations),
                        "wrapper_ms": sync_time(lambda args=args: tk.triangulate(*args), F1_TIMED),
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "roofline_pct": 100 * bound_ms / ms if ms else None}
    log("16 F1", gpu=repr(smi), calls=json.dumps(calls, separators=(",", ":")),
        vs_host_build="equal bit for bit", decisions_vs_plain="equal", dropped_views=dropped,
        host_build_equals_cpu_plain=json.dumps(cpu_equal, separators=(",", ":")),
        max_abs_err=err, worst_to_float64=mine, plain_worst_to_float64=ref,
        times="'" + json.dumps(times) + "'")
    step = times["step"]
    return {"triangulation": (step["device_ms"], step["plain_ms"], step["bound_ms"],
                              step["bound_by"])}, err


# ---------------------------------------------------------------- phase 17 --

NEW_KERNELS = ("pair_costs_kernel", "scan_costs_kernel", "scan_extend_kernel",
               "triangulation_wide_kernel")


def e1_matches_twin(kp_n, rig, f_cfg, what: str) -> None:
    """Kernel E1's table (fusion.fold_inputs on the card) against its plain
    twin (`fusion.pair_costs_plain`: the plain per-joint terms summed by
    torch.sum and scattered) on the same keypoints, bit for bit."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion

    score = torch.ones(kp_n.shape[:-2], device=kp_n.device)
    got = fusion.fold_inputs(kp_n, score, rig, f_cfg)[0]
    want = fusion.pair_costs_plain(kp_n, rig.F, f_cfg.min_kp_score)
    if not torch.equal(got, want):
        where = torch.nonzero(got != want)[:4].tolist()
        raise AssertionError(f"{what}: kernel E1's table differs from its plain twin in "
                             f"{int((got != want).sum())} entries, first {where}")


def new_kernel_launches(dev, pipe, off_pipe, inputs) -> dict:
    """E1, S1, S2 and F1's wide variant on the device in one replay of the
    demo's captured step and of one demo scene's run_offline: E1 once per
    step and per fusion chunk, the others not at all (the demo takes K2
    and F1); E1's table against its plain twin bit for bit on the step's
    frame and on the scene's first chunk."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion

    data = inputs[SCENES[0]]
    frames = stacked_frames(data, dev)
    step = device_kernel_counts(lambda: pipe.step(pipe.init_state(), frame_at(data, 0, dev)),
                                NEW_KERNELS)
    off = device_kernel_counts(lambda: off_pipe.run_offline(off_pipe.init_state(), frames),
                               NEW_KERNELS)
    chunks = -(-data["kp2d"].shape[0] // OFFLINE_FUSION_BATCH)
    want = ({"pair_costs_kernel": 1}, {"pair_costs_kernel": chunks})
    for what, got, w in (("step", step, want[0]), ("run_offline", off, want[1])):
        if got != dict(dict.fromkeys(NEW_KERNELS, 0), **w):
            raise AssertionError(f"demo {what}: E1, S1, S2, F1W on the device {got}")
    f_cfg = pipe.config.fusion
    kp_n = fusion.normalize_frame(frames, pipe.rig, f_cfg)[0]
    e1_matches_twin(kp_n[0], pipe.rig, f_cfg, "demo step")
    e1_matches_twin(kp_n[:OFFLINE_FUSION_BATCH], pipe.rig, f_cfg, "demo chunk")
    return {"step": step, "run_offline": off}


def e1_bound(frames: int, cams: int, dets: int, joints: int) -> tuple:
    """Kernel E1's bound (ms, by) on `frames` frames: its keypoints and F
    read and the table written once; 10 float32 operations a per-joint
    term (the two numerators' 2 products and 2 sums each, |num1| + |num2|,
    the sum over the joints), 19 a line (3 x 4, its norm's 3, rsqrt, 3
    products; 2 lines per pair, detection and joint) and a division a
    cost."""
    pairs = frames * cams * (cams - 1) // 2
    ops = (pairs * dets * dets * joints * 10 + 2 * pairs * dets * joints * 19
           + pairs * dets * dets)
    nbytes = 4 * (frames * cams * dets * joints * 3 + cams * cams * 9
                  + frames * cams * cams * dets * dets)
    return bound_of(nbytes, ops)


WIDE_CONFIG = os.path.join(_ROOT, "portbench", "configs", "panoptic480.json")
WIDE_MIX = os.path.join(_ROOT, "portbench", "mixes", "offline_25hz.json")
WIDE_SEED = 2_718_281_829
WIDE_PLAIN_FRAMES = 2
# Kernels one replay of one chunk runs on the device, by trace name.
WIDE_DEVICE_KERNELS = {"triangulation_wide_kernel": 1, "jv_assign_kernel": 480,
                       "scan_costs_kernel": 480, "scan_extend_kernel": 480,
                       "lm_trip_kernel": 1, "tracker_scan_kernel": 1}


def f1_ptxas(build_log) -> str:
    """F1's and its wide variant's registers, stack frame and spills from
    `nvcc -Xptxas -v` (reported)."""
    if build_log is None:
        return "'not read: the library was already built'"
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(triangulation_wide_kernel|"
                      r"triangulation_kernel)", line)
        if m:
            name = m.group(1)
        elif "Compiling entry function" in line:
            name = None
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            out[name] = f"stack {m.group(1)} spill {m.group(2)}/{m.group(3)}"
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name] = f"{out.get(name, '')} registers {m.group(1)}".strip()
    return "'" + "; ".join(f"{k}: {v}" for k, v in sorted(out.items())) + "'"


def device_kernel_counts(fn, names) -> dict:
    """Launches of each kernel of `names` on the device in a torch.profiler
    trace of one call of `fn` (a name matches the trace's names it is
    part of, as `kernel_durations` matches)."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                counts[n] += n in e.name and not (n == "triangulation_kernel"
                                                   and "wide" in e.name)
    return counts


def phase_wide(dev, smi) -> None:
    """17: the 480-camera dome on the card (module docstring)."""
    from portbench.lib import harness
    from portbench.lib import scene as scene_lib
    from smartedgesensor3dhumanpose_tpu_torch import _kernels, config, fusion, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.ops import epipolar
    from smartedgesensor3dhumanpose_tpu_torch.ops import triangulation_kernel as tk
    from smartedgesensor3dhumanpose_tpu_torch.types import CameraRig, Frame

    with open(WIDE_CONFIG) as f:
        cfg_file = json.load(f)
    with open(WIDE_MIX) as f:
        mix = json.load(f)
    cfg = scene_lib.make_config(config, cfg_file)
    f_cfg = cfg.fusion
    batch = int(cfg_file["fusion_batch"])
    cams = f_cfg.num_cameras
    rig = CameraRig(*(t.to(dev) for t in scene_lib.rig_arrays(cfg_file)))
    rig64 = rig._replace(**{k: getattr(rig, k).double() for k in rig._fields})
    data = scene_lib.scene(cfg_file, mix, batch, WIDE_SEED)
    data.pop("det_count")
    frames = Frame.from_arrays(data, dev)
    routes = (fusion.association_route(f_cfg, cams, f_cfg.max_dets_per_cam),
              fusion.triangulation_route(cams, dev, torch.float32))
    if routes != ("scan", "wide"):
        raise AssertionError(f"wide rig: routes {routes}, not the scan and F1's wide variant")

    # F1's wide variant on the chunk's hypotheses and on two frames'.
    hyps = f1_hypotheses(data, slice(0, batch), rig, cfg, dev)
    args = (hyps.kp, hyps.cov, hyps.cam_mask, rig.P, rig.F, f_cfg)
    drops = torch.full((hyps.kp.shape[0], 17), -2, dtype=torch.int32, device=dev)
    got = tk.triangulate(*args, drops=drops)
    cpu = [t.cpu() for t in (hyps.kp, hyps.cov, hyps.cam_mask, rig.P, rig.F)]
    host_drops = torch.empty_like(drops, device="cpu")
    host = tk.triangulate(*cpu, f_cfg, drops=host_drops, host=True)
    for name, a, b in zip(got._fields + ("drops",), tuple(got) + (drops,),
                          tuple(host) + (host_drops,)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"F1 wide, chunk of {batch}: {name} differs from the host build")
    few = f1_hypotheses(data, slice(0, WIDE_PLAIN_FRAMES), rig, cfg, dev)
    few_drops, err, diffs, cpu_equal = check_f1_call(f"wide {WIDE_PLAIN_FRAMES} frames", few,
                                                     rig, rig64, f_cfg)
    worst, plain_worst = check_f1_accuracy("wide", [diffs])
    durations = kernel_durations(lambda: tk.triangulate(*args), "triangulation_wide_kernel", 5)
    wide_ms = statistics.median(durations) / 1e3 if durations else None
    bound_ms, bound_by = f1_bound(hyps.kp, hyps.cam_mask, drops, f_cfg)
    # The kernels line's pair at the two frames' shape: the plain body on
    # the chunk's slots takes more than the card's memory.
    few_args = (few.kp, few.cov, few.cam_mask, rig.P, rig.F, f_cfg)
    few_ms = kernel_durations(lambda: tk.triangulate(*few_args), "triangulation_wide_kernel", 5)
    few_ms = statistics.median(few_ms) / 1e3 if few_ms else None
    few_plain_ms = sync_time(lambda: fusion._triangulate_plain(few, rig, f_cfg), 2)
    few_bound_ms, few_bound_by = f1_bound(few.kp, few.cam_mask, few_drops, f_cfg)
    del got, host
    torch.cuda.empty_cache()

    # S1 and S2 (with K1 between them) against the plain camera scan
    # (`_scan_camera`, its JV on K1) on the card, on the chunk's fold inputs.
    scan = wide_scan(frames, rig, f_cfg)
    torch.cuda.empty_cache()

    # Eager run_offline of the chunk: no host sync once its constant tables
    # are on the card (so it captures).
    state0 = wide_state0(cfg, dev)
    pipeline.run_offline(state0, frames, rig, cfg, batch)
    syncs = sync_sites(lambda: pipeline.run_offline(state0, frames, rig, cfg, batch))
    if syncs:
        raise AssertionError(f"wide rig: eager run_offline syncs the host at {syncs}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # The captured chunk: memory, syncs, kernels, counters.
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    pipe = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=batch, trace=True)
    pipe._offline.keep_graph = True
    t0 = time.perf_counter()
    pipe.run_offline(state0, frames)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    replay_ms = sync_time(lambda: pipe.run_offline(state0, frames), 3)
    replay_peak = torch.cuda.max_memory_allocated(dev)
    replay_syncs = count_syncs(lambda: pipe.run_offline(state0, frames))
    nodes = harness.graph_kernel_nodes(pipe._offline)
    on_device = device_kernel_counts(lambda: pipe.run_offline(state0, frames),
                                     tuple(WIDE_DEVICE_KERNELS) + ("triangulation_kernel",
                                                                   "pair_costs_kernel"))
    want = dict(WIDE_DEVICE_KERNELS, triangulation_kernel=0, pair_costs_kernel=1)
    if on_device != want:
        raise AssertionError(f"wide rig: kernels on the device per replay {on_device}, "
                             f"expected {want}")
    with pipe.tracer:
        pipe.run_offline(state0, frames)
        torch.cuda.synchronize()
    rec = pipe.tracer.drain()
    counters = {str(n): int(v) for n, v, sc in zip(rec.counters["name"], rec.counters["value"],
                                                   rec.counters["scope"])
                if sc == "Pipeline.run_offline"}
    spans = rec.spans
    stage_ms = {str(n): (int(e) - int(st)) * 1e-6 for n, st, e in
                zip(spans["name"], spans["start"], spans["end"])
                if str(n).startswith("fusion") or n in ("smoothing", "tracker", "feedback")}
    if (counters.get("fusion.association.scan_steps") != cams
            or counters.get("fusion.association.pair_costs_e1") != batch
            or counters.get("fusion.triangulation.f1w") != hyps.kp.shape[0]
            or counters.get("fusion.triangulation.f1") != 0
            or counters.get("fusion.triangulate.kernels", 10**9) > 64):
        raise AssertionError(f"wide rig: counters {counters}")
    # Kernel E1 (the whole chunk's table in one launch) against its plain
    # twin on the card, bit for bit; their times and E1's bound.
    kp_n = fusion.normalize_frame(frames, rig, f_cfg)[0]
    e1_matches_twin(kp_n, rig, f_cfg, "wide rig chunk")
    # E1's time by CUDA events around its launches (its wrapper runs nothing
    # else on the device): late in a full run the profiler's kernel records
    # of this phase have come back empty.
    e1_ms = sync_time(lambda: epipolar.pair_costs(kp_n, rig.F, f_cfg.min_kp_score), 5)
    e1_plain_ms = sync_time(lambda: fusion.pair_costs_plain(kp_n, rig.F, f_cfg.min_kp_score), 2)
    e1_bound_ms, e1_bound_by = e1_bound(batch, cams, f_cfg.max_dets_per_cam, kp_n.shape[-2])
    del kp_n
    torch.cuda.empty_cache()

    log("17 wide rig", gpu=repr(smi), cameras=cams, fusion_batch=batch,
        hypotheses=hyps.kp.shape[0], routes=",".join(routes),
        f1_wide_vs_host_build="equal bit for bit", decisions_vs_plain="equal",
        cpu_plain_equals_host_build=cpu_equal, dropped_views=int((few_drops >= 0).sum()),
        max_abs_err=err, worst_to_float64=worst, plain_worst_to_float64=plain_worst,
        f1_wide_device_ms=wide_ms, f1_wide_bound_ms=bound_ms, f1_wide_bound_by=bound_by,
        f1_wide_roofline_pct=100 * bound_ms / wide_ms if wide_ms else None,
        f1_wide_ptxas=f1_ptxas(_kernels.build_log), e1_vs_plain="equal bit for bit",
        e1_device_ms_chunk=e1_ms, e1_plain_ms=e1_plain_ms, e1_bound_ms=e1_bound_ms,
        e1_bound_by=e1_bound_by, e1_roofline_pct=100 * e1_bound_ms / e1_ms if e1_ms else None,
        f1_wide_two_frames="'" + json.dumps({"hypotheses": few.kp.shape[0], "device_ms": few_ms,
                                              "plain_ms": few_plain_ms,
                                              "bound_ms": few_bound_ms}) + "'",
        scan_vs_plain_scan="equal",
        scan="'" + json.dumps(scan["report"]) + "'", eager_host_syncs=0,
        capture_s=round(capture_s, 2), replay_ms=replay_ms, replay_host_syncs=replay_syncs,
        graph_kernel_nodes=nodes, kernels_per_replay="'" + json.dumps(on_device) + "'",
        peak_bytes_capture=capture_peak - base, peak_bytes_replay=replay_peak - base,
        counters="'" + json.dumps(counters) + "'",
        stage_ms="'" + json.dumps(stage_ms) + "'")
    if replay_syncs:
        raise AssertionError(f"wide rig: a replay syncs the host {replay_syncs} times")
    return {
        "pair_costs": {"ms": e1_ms, "plain_ms": e1_plain_ms, "bound_ms": e1_bound_ms,
                       "bound_by": e1_bound_by, "err": 0.0, "chunk": on_device["pair_costs_kernel"]},
        "scan_costs": dict(scan["s1"], chunk=on_device["scan_costs_kernel"]),
        "scan_extend": dict(scan["s2"], chunk=on_device["scan_extend_kernel"]),
        "triangulation_wide": {"ms": few_ms, "plain_ms": few_plain_ms, "bound_ms": few_bound_ms,
                               "bound_by": few_bound_by, "err": err,
                               "chunk": on_device["triangulation_wide_kernel"]},
    }


def wide_scan(frames, rig, f_cfg) -> dict:
    """S1 and S2 with K1 between them (association.associate_scan_kernels)
    against the plain camera scan on the card (`_scan_camera` per camera,
    its JV on K1), on a chunk's fold inputs as fusion.associate builds
    them: det_slot, n_hyp and n_dropped equal; their times, the plain
    scan's a step, and S1's and S2's bounds (S1: the table rows of each
    hypothesis' cameras observed before the step, its det_slot row and the
    cost it writes; S2: the step's det_slot column and counts)."""
    from smartedgesensor3dhumanpose_tpu_torch import fusion, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.ops import association

    chunk, _ = pipeline.mask_stale_cameras(frames, f_cfg.max_sync_diff)
    kp_n, _, det_ok = fusion.normalize_frame(chunk, rig, f_cfg)
    ctab, conf_obs = fusion.fold_inputs(kp_n, chunk.det_score, rig, f_cfg)
    args = (ctab, conf_obs, det_ok, f_cfg.max_hypotheses, f_cfg.max_epipolar_error,
            f_cfg.max_cost)
    got = association.associate_scan_kernels(*args)
    saved = association.scan_kernels_take
    association.scan_kernels_take = lambda h_cap, d: False
    try:
        want = association.associate_scan(*args)
        plain_ms = sync_time(lambda: association.associate_scan(*args), 2)
    finally:
        association.scan_kernels_take = saved
    for name, a, b in zip(("det_slot", "n_hyp", "n_dropped"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"wide rig: the scan kernels' {name} differs from the plain "
                                 f"scan's on the card")
    cams = ctab.shape[1]
    ms = sync_time(lambda: association.associate_scan_kernels(*args), 3)
    s1 = kernel_durations(lambda: association.associate_scan_kernels(*args),
                          "scan_costs_kernel", 1)
    s2 = kernel_durations(lambda: association.associate_scan_kernels(*args),
                          "scan_extend_kernel", 1)
    b, h_cap, d = got[0].shape[0], got[0].shape[1], ctab.shape[-1]
    seen = got[0] >= 0
    later = (cams - 1 - torch.arange(cams, device=ctab.device)).double()
    rows = float((seen.double() * later).sum()) / cams  # observed rows read a step
    s1_bytes = rows * d * 4 + b * h_cap * cams * 8 + b * cams * d * 5 + b * h_cap * d * 4
    s2_bytes = b * h_cap * (8 * 4 + d) + b * 8 * 2
    s1_bound, s1_by = bound_of(s1_bytes, 0)
    s2_bound, s2_by = bound_of(s2_bytes, 0)
    s1_ms = statistics.median(s1) / 1e3 if s1 else None
    s2_ms = statistics.median(s2) / 1e3 if s2 else None
    plain_step = plain_ms / cams
    report = {"frames": b, "hypotheses": int(got[1].sum()), "dropped": int(got[2].sum()),
              "scan_ms": ms, "plain_scan_ms": plain_ms, "s1_ms": s1_ms, "s2_ms": s2_ms,
              "s1_launches": len(s1), "s2_launches": len(s2), "s1_bound_ms": s1_bound,
              "s2_bound_ms": s2_bound, "plain_step_ms": plain_step}
    return {"report": report,
            "s1": {"ms": s1_ms, "plain_ms": plain_step, "bound_ms": s1_bound, "bound_by": s1_by,
                   "err": 0.0},
            "s2": {"ms": s2_ms, "plain_ms": plain_step, "bound_ms": s2_bound, "bound_by": s2_by,
                   "err": 0.0}}


def wide_state0(cfg, dev):
    """The tracker's initial state of `cfg` on `dev`, in float32."""
    from smartedgesensor3dhumanpose_tpu_torch.types import TrackerState

    t = cfg.tracker
    return TrackerState.initial(t.max_tracks, t.n_mov_avg, t.avg_delay, dtype=torch.float32,
                                device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, help="write a profiler table here")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    from smartedgesensor3dhumanpose_tpu_torch import _kernels
    from smartedgesensor3dhumanpose_tpu_torch.ops import linalg

    dev = torch.device("cuda", 0)
    smi = smi_line()
    linalg.require_ieee_fp32()
    # The build prints nvcc's -Xptxas -v report; phase 0's line follows it,
    # so that it stays within the end of the output that callers keep.
    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    _kernels.library()
    build_s = time.perf_counter() - t0
    log("0 env", gpu=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32,
        fp32_precision=torch.get_float32_matmul_precision(),
        captured_loops="'the merge one WHILE node (ops/loops.py, csrc/graph_loop.cu), the tree LM one launch of L1'",
        torch_if_nodes=hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node"),
        torch_stream_to_pool=hasattr(torch._C, "_cuda_beginAllocateCurrentStreamToPool"))

    log("1 build", seconds=round(build_s, 2),
        fresh_build_seconds=_kernels.build_seconds, flags=" ".join(_kernels.NVCC_FLAGS),
        plans_checked=check_plans(), k1_registers_no_local_memory=check_k1_ptxas(_kernels.build_log),
        lm_ptxas=lm_ptxas(_kernels.build_log))
    # Phase 14's CPU references run in worker processes meanwhile.
    pool, references = start_cpu_references()
    try:
        return run_phases(args, dev, smi, references)
    finally:
        pool.terminate()
        pool.join()


def run_phases(args, dev, smi, references) -> int:
    """Phases 2-16 and the result lines."""
    from smartedgesensor3dhumanpose_tpu_torch import cameras
    from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig

    rng = np.random.default_rng(0)
    golden = np.load(GOLDEN)
    golden_offline = np.load(GOLDEN_OFFLINE)
    cfg = PipelineConfig.demo_16cam()
    rig = cameras.hall_rig(16, device=dev)
    scaled = scaled_setup(dev)
    k1_err = phase_k1(dev, rng)
    k2_err = phase_k2(dev, golden, rig, cfg, scaled)
    pipe, inputs, launches = phase_slice(dev, golden, rig, cfg)
    times, step_on_device = phase_times(dev, pipe, golden, rig, cfg, rng, args.profile)
    off_pipe, off_launches = phase_offline(dev, golden_offline, rig, cfg, inputs)
    new_on_demo = new_kernel_launches(dev, pipe, off_pipe, inputs)
    k3_err = phase_k3(dev, off_pipe, inputs)
    k3_err = max(k3_err, phase_scaled(dev, scaled))
    times.update(phase_offline_times(dev, off_pipe, inputs, args.profile))
    demo_launches, demo_k3_err = phase_demo(dev)
    k3_err = max(k3_err, demo_k3_err)
    e2e_paths, trained = phase_end_to_end(dev, smi)
    sharded_launches = phase_sharded(dev, smi, golden_offline, rig, cfg, inputs, scaled)
    captured_launches = phase_captured_step(dev, smi, golden, rig, cfg, inputs, pipe)
    phase_captured_offline(dev, smi, rig, cfg, inputs, off_pipe)
    captured_launches.update(phase_captured_end_to_end(dev, smi, trained))
    phase_lm_trips(dev, smi, rig, cfg, inputs, pipe)
    wide = phase_wide_k1(dev, smi, references)
    config_launches = phase_configs(dev, smi, golden, rig, inputs, pipe, off_pipe, references)
    lm_times, lm_err = phase_lm_kernels(dev, smi, rig, cfg, inputs, scaled)
    times.update(lm_times)
    f1_times, f1_err = phase_f1(dev, smi, rig, cfg, inputs)
    times.update(f1_times)
    wide_kernels = phase_wide(dev, smi)

    pkg = "smartedgesensor3dhumanpose_tpu_torch/csrc"
    tpu = "smartedgesensor3dhumanpose_tpu/ops"
    # launches: the wrappers' counts over the main path's run, the online
    # step's (phase 4) for K1, K2, L1, L2 and F1 and the offline replay's
    # (phase 6) for K3. Both are CUDA graphs: the wrappers count their first
    # call's warm-up and capture (L1, the whole LM, once in each), and a
    # replay launches nothing on the host.
    # launches_by_path: the wrappers' counts per path, those of the online
    # step (phase 4), the offline path (6), the demo modes (10), the
    # end-to-end step (11, full width), training followed by the trained
    # end-to-end step (11.4: training launches none of K1-K3, the step's
    # first call K1 and K2) and the sharded paths (12: each
    # mesh's first call, which captures its graphs);
    # and under `*_replays_on_device` the kernels that graph replays ran on
    # the device, counted by name in torch.profiler traces: STEP_PROFILED
    # replays of phase 4's step (in phase 5), phase 6's replay of each scene, a chain of
    # STEP_PROFILED frames (13.2), PROFILED_REPLAYS end-to-end replays
    # (13.4) and phase 12's checked replays of the sharded paths (both
    # scenes on every mesh; one fusion per fusion mesh). No single PyTorch
    # call computes JV, the fold, the scan, an LM, the tree marginals or the
    # triangulation, so there is no library time. L1, L2 and F1 port no
    # pallas_call: they stand for XLA's fused while loop and marginals of
    # the JAX prior and its program of the triangulation (`replaces` names
    # those lines); their `ms` is the kernel's device time (phase 15: L1's
    # one launch of a whole LM from the step's cold start, with its twin
    # and its bound; phase 16: F1 on a step's 16 slots, its plain body and
    # its bound), the others' the wrapper's by CUDA events.
    paths = {**launches, **step_on_device, **off_launches, **demo_launches, **e2e_paths,
             **sharded_launches, **captured_launches, **config_launches}
    names = ("jv_assign", "association_fold", "tracker_scan", "lm_trip", "lm_marginals",
             "triangulation")
    by_path = {name: {path: counts[i] for path, counts in paths.items()}
               for i, name in enumerate(names)}
    main_path = {"jv_assign": "step", "association_fold": "step", "tracker_scan": "run_offline",
                 "lm_trip": "step", "lm_marginals": "step", "triangulation": "step"}
    # K1 replaces both JV sites: the single problem (:238) and the batched
    # launch (:516).
    also = {"jv_assign": [f"{tpu}/hungarian_pallas.py:516"]}
    specs = (
        ("jv_assign", "jv_assign.cu", f"{tpu}/hungarian_pallas.py:238", k1_err),
        ("association_fold", "association_fold.cu", f"{tpu}/association_pallas.py:419", k2_err),
        ("tracker_scan", "tracker_scan.cu", f"{tpu}/tracker_pallas.py:621", k3_err),
        ("lm_trip", "lm_prior.cu", f"{os.path.dirname(tpu)}/prior.py:438", lm_err),
        ("lm_marginals", "lm_prior.cu", f"{os.path.dirname(tpu)}/prior.py:478", lm_err),
        ("triangulation", "triangulation.cu", f"{os.path.dirname(tpu)}/fusion.py:527", f1_err),
    )
    kernels = []
    for name, src, replaces, err in specs:
        ms, plain_ms, bound_ms, bound_by = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{pkg}/{src}", "replaces": replaces,
            **({"also_replaces": also[name]} if name in also else {}),
            "launches": by_path[name][main_path[name]], "launches_by_path": by_path[name],
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    # K1 past 120 columns: device ms and bound per timed case.
    kernels[0]["wide"] = {name: {"ms": t[0], "bound_ms": t[1], "bound_by": t[2]}
                          for name, t in wide.items()}
    # E1, S1, S2 and F1's wide variant (PERF.md: they port no pallas_call,
    # as L1, L2 and F1): launches on the device per replay of the demo's
    # step (phase 4's pipeline), of a demo scene's run_offline (phase 6's)
    # and of one chunk of the dome's run_offline (phase 17); their times
    # from phase 17 at the dome's shapes: E1 on a chunk's table and its
    # plain twin (`fusion.pair_costs_plain`) on the same keypoints; S1 and S2
    # per camera step of the chunk's scan, their twin the plain scan's
    # whole step (`_scan_camera`, its JV included); F1's wide variant on
    # two frames' hypotheses and the plain body on them, on the card (its
    # time on the chunk's slots is in phase 17's line).
    replaces = {
        "pair_costs": f"{tpu}/epipolar.py:192",
        "scan_costs": f"{os.path.dirname(tpu)}/fusion.py:96",
        "scan_extend": f"{os.path.dirname(tpu)}/fusion.py:96",
        "triangulation_wide": f"{os.path.dirname(tpu)}/fusion.py:527",
    }
    sources = {"pair_costs": "pair_costs.cu", "scan_costs": "scan_step.cu",
               "scan_extend": "scan_step.cu", "triangulation_wide": "triangulation.cu"}
    for name, t in wide_kernels.items():
        by_path = {"step": new_on_demo["step"][name + "_kernel"],
                   "run_offline": new_on_demo["run_offline"][name + "_kernel"],
                   "run_offline_dome_chunk": t["chunk"]}
        kernels.append({
            "name": name, "route": "cuda", "source": f"{pkg}/{sources[name]}",
            "replaces": replaces[name], "launches": by_path[
                "step" if name == "pair_costs" else "run_offline_dome_chunk"],
            "launches_by_path": by_path, "max_abs_err": float(t["err"]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
