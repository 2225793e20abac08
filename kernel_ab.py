"""Time the port's kernels K1 (JV assignment), K2 (association fold) and K3
(tracker scan) on one NVIDIA GPU, optionally beside another checkout's kernels.

Each version runs in its own process (the packages share a name), in turns:
the others, this, this, the others in reverse. Every process builds its
checkout's kernels from source (`nvcc -Xptxas -v`, whose register, spill and
shared-memory lines it reports), makes the same inputs from the same seeds
and golden scene descriptions (chip_smoke.py's helpers), and times:

  k3_demo           K3 on the benign demo scene's tracker inputs (64 frames,
                    P 16, T 24); k3_demo_no_persons, the same frames with
                    every person invalid (no cost phase, no JV);
                    k3_demo_no_dets, with has_dets false on every frame (no
                    merge)
  k3_scaled         K3 on the scaled layout's inputs (32 frames, P 40, T 64)
  k3_edge           K3 at the domain's edge (P = T = 120)
  k2_frame_*        K2 on one demo frame (benign and adversarial frame 40)
  k2_chunk32_*      K2 on the offline chunk, B = 32 demo frames
  k2_scaled_chunk   K2 on the scaled chunk (B = 4, C 64, D 32, H 40)
  k2_per_frame      K2 on each frame of both demo scenes, with the camera
                    steps that needed a JV solve (counted on the plain fold)
  k1_online         K1 on the online step's tracker problem: 16 x 24, 6
                    active rows, row_active
  k1b               the batched K1 at B = 64 problems of 16 x 24, and its
                    plain version on the same card tensors (`plain_ms`)
  k1_64x40x40       the batched K1 at B = 64 problems of 40 x 40
  k1_8x120x120      the batched K1 at B = 8 problems of 120 x 120
  k1_120            K1 on one 120 x 120 problem
  k1w_N             K1 past 120 columns on one random N x N problem (N = 128,
                    256, 512, 1024; 2048 and 4096 without a bound, whose
                    plain search takes minutes on the CPU)
  k1w_128x8         K1 on the camera scan's needed 128 x 8 problem
                    (max_hypotheses=128, D 8; chip_smoke.py::scan_costs)
  k1w_16x128x8      the scan's batched launch, B = 16 frames with need per
                    frame as row_active (ops/association.py::_scan_camera);
                    k1w_16x128x8_nomask, the same launch without the mask,
                    as the scan launched it before it passed one;
                    k1w_16x512x8, the same launch at max_hypotheses=512
  lm_solve_demo     L1 (csrc/lm_prior.cu), the whole LM from the cold start of
                    the online step's persons on adversarial frame 40 (P 16):
                    one launch where the checkout has `lm_solve`, else L1
                    one trip a launch with the host's test between trips;
                    `device_ms` is the LM's (its launches summed), also per
                    trip; `ms` includes copying the start carry in
  lm_solve_chunk32  the same on the offline chunk, the adversarial scene's
                    first 32 frames (P 512)
  lm_trip_demo      L1 capped at one trip, from the same cold start; `ms`
                    includes copying the start carry in before each launch
  lm_trip_chunk32   L1 capped at one trip on the offline chunk
  lm_marg_chunk32   L2 (the tree marginals) on that chunk at its LM's result
  step_captured     the captured Pipeline.step (demo_16cam) through the public
                    API: every frame of both golden scenes in order, a sync
                    after each, twice; `ms` is the p50 (wall), also p90
  offline_adversarial_captured
                    the captured Pipeline.run_offline (fusion_batch 32) on the
                    adversarial scene: the median wall ms of 5 warm calls
  chain_captured    the captured run_per_frame_chain over the benign scene's 64
                    frames: wall ms per step, the median of 3 calls

Per kernel case: `ms`, CUDA events over back-to-back wrapper calls (the
wrapper's host work shows where it is longer than the device's), and
`device_ms`, the kernel's own mean duration in a torch.profiler trace;
`bound_ms` as chip_smoke.py computes it. The lm_* cases run only where the
checkout has L1 and L2; the entry-point cases (step_captured,
offline_adversarial_captured, chain_captured) call the public API only, so
they time any checkout.

Usage:  python3 kernel_ab.py [--other DIR ...] [--cases PREFIXES] [--out FILE]
  --other DIR  a checkout holding smartedgesensor3dhumanpose_tpu_torch/ to
               time beside this one (repeatable)
  --cases P    only the cases whose names start with one of these
               comma-separated prefixes (e.g. k3,k2_frame)
  --out FILE   also write every process's results there as JSON
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.abspath(__file__))
_TAG = "KERNEL_AB "


def _smoke():
    """chip_smoke.py of this checkout, as a module of its own name."""
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(cs, fn, kernel: str, reps: int, bound=None) -> dict:
    durs = cs.kernel_durations(fn, kernel, reps)
    out = {
        "ms": cs.sync_time(fn, reps),
        "device_ms": statistics.mean(durs) / 1e3 if durs else None,
        "device_ms_min": min(durs) / 1e3 if durs else None,
        "launches_traced": len(durs),
    }
    if bound is not None:
        out["bound_ms"], out["bound_by"] = bound
    return out


def need_solves(ctab, conf, dok, args) -> int:
    """Camera steps of the plain fold of one frame that ran a JV solve."""
    from smartedgesensor3dhumanpose_tpu_torch.ops import association, hungarian

    count = [0]
    plain = hungarian._jv_plain

    def counted(*a, **k):
        count[0] += 1
        return plain(*a, **k)

    hungarian._jv_plain = counted
    try:
        association.associate_fold_reference(ctab.cpu(), conf.cpu(), dok.cpu(), *args)
    finally:
        hungarian._jv_plain = plain
    return count[0]


def fold_bound(cs, ctab, conf, dok, h_cap):
    """chip_smoke.py's K2 bound, for one frame or a batch of frames."""
    c_cams, _, d = ctab.shape[-3:]
    b = ctab.numel() // (c_cams * c_cams * d * d)
    return cs.bound_of(
        ctab.numel() * 4 + conf.numel() * 4 + dok.numel() + b * (h_cap * c_cams * 4 + 8),
        b * (h_cap * d * c_cams * (c_cams - 1) // 2 + c_cams * d * (h_cap + 1) * h_cap * 4),
    )


def worker(pkg_root: str, label: str, only=None) -> dict:
    sys.path.insert(0, pkg_root)
    import smartedgesensor3dhumanpose_tpu_torch as pkg

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(pkg_root) + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {pkg_root}")
    from smartedgesensor3dhumanpose_tpu_torch import _kernels, cameras, fusion, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig, PriorConfig
    from smartedgesensor3dhumanpose_tpu_torch.ops import association, hungarian, tracker
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    def want(name: str) -> bool:
        return not only or any(name.startswith(c) for c in only)

    cs = _smoke()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _kernels.build(verbose=True)
    _kernels.library()
    ptxas = [ln.strip() for ln in log.getvalue().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    dev = torch.device("cuda", 0)
    res = {"label": label, "pkg_root": pkg_root, "ptxas": ptxas}

    golden = np.load(cs.GOLDEN)
    cfg = PipelineConfig.demo_16cam()
    rig = cameras.hall_rig(16, device=dev)
    pipe = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=cs.OFFLINE_FUSION_BATCH)
    scenes = {s: cs.scene_data(json.loads(str(golden[f"{s}/scene"])), cfg.fusion.max_dets_per_cam)
              for s in cs.SCENES}

    # K3 at the demo shape, then without persons and without detections.
    frames = cs.stacked_frames(scenes["benign"], dev)
    persons, pivots, fb, pre = cs.tracker_inputs(pipe, frames)
    state0 = pipe.init_state()

    def k3(p=persons):
        return tracker.tracker_scan(state0, p, pivots, fb, pre, cfg.prior, cfg.tracker)

    if want("k3_demo"):
        bound = cs.k3_bound(persons, state0, persons.valid.any(dim=1))
        res["k3_demo"] = measure(cs, k3, "tracker_scan_kernel", 20, bound)
        nobody = persons._replace(valid=torch.zeros_like(persons.valid))
        res["k3_demo_no_persons"] = measure(cs, lambda: k3(nobody), "tracker_scan_kernel", 20)
        pack = tracker._pack
        tracker._pack = lambda *a: pack(*a[:-1], torch.zeros_like(a[-1]))
        try:
            res["k3_demo_no_dets"] = measure(cs, k3, "tracker_scan_kernel", 20)
        finally:
            tracker._pack = pack

    # K2 on one demo frame and on the offline chunks.
    args = (cfg.fusion.max_hypotheses, cfg.fusion.max_epipolar_error, cfg.fusion.max_cost)
    per_frame = {}
    for s in cs.SCENES:
        cases = [cs.fold_case(cs.frame_at(scenes[s], f, dev), rig, cfg.fusion) for f in range(64)]
        ctab, conf, dok = cases[40]
        if want(f"k2_frame_{s}"):
            res[f"k2_frame_{s}"] = measure(
                cs, lambda: association.associate_fold(ctab, conf, dok, *args),
                "association_fold_kernel", 50, fold_bound(cs, ctab, conf, dok, args[0]))
            res[f"k2_frame_{s}"]["need_solves"] = need_solves(ctab, conf, dok, args)
        bt = [torch.stack([c[i] for c in cases[:32]]) for i in range(3)]
        if want(f"k2_chunk32_{s}"):
            res[f"k2_chunk32_{s}"] = measure(
                cs, lambda: association.associate_fold_batched(*bt, *args),
                "association_fold_kernel", 50, fold_bound(cs, *bt, args[0]))
        if not want("k2_per_frame"):
            continue
        reps = 10
        durs = cs.kernel_durations(
            lambda: [association.associate_fold(*c, *args) for c in cases for _ in range(reps)],
            "association_fold_kernel", 1)
        needs = [need_solves(*c, args) for c in cases]
        per_frame[s] = {
            "need_solves": needs,
            "device_us": ([statistics.mean(durs[i * reps:(i + 1) * reps]) for i in range(len(cases))]
                          if len(durs) == reps * len(cases) else None),
        }
    if per_frame:
        res["k2_per_frame"] = per_frame

    # The scaled layout: K3 on its tracker inputs, K2 on its first chunk.
    cfg_s = PipelineConfig.scaled_64cam()
    rig_s = cameras.hall_rig(cs.SCALED_SCENE["num_cameras"], device=dev)
    frames_s = cs.stacked_frames(cs.scene_data(cs.SCALED_SCENE, cfg_s.fusion.max_dets_per_cam), dev)
    pipe_s = pipeline.Pipeline(rig_s, cfg_s, device=dev, fusion_batch=cs.SCALED_FUSION_BATCH)
    persons_s, pivots_s, fb_s, pre_s = cs.tracker_inputs(pipe_s, frames_s)
    state_s = pipe_s.init_state()
    if want("k3_scaled"):
        res["k3_scaled"] = measure(
            cs, lambda: tracker.tracker_scan(state_s, persons_s, pivots_s, fb_s, pre_s,
                                             cfg_s.prior, cfg_s.tracker),
            "tracker_scan_kernel", 10, cs.k3_bound(persons_s, state_s, persons_s.valid.any(dim=1)))
    chunk, _ = pipeline.mask_stale_cameras(
        Frame(*(x[:cs.SCALED_FUSION_BATCH] for x in frames_s)), cfg_s.fusion.max_sync_diff)
    kp_n, _, det_ok = fusion.normalize_frame(chunk, rig_s, cfg_s.fusion)
    ctab_s, conf_s = fusion.fold_inputs(kp_n, chunk.det_score, rig_s, cfg_s.fusion)
    args_s = (cfg_s.fusion.max_hypotheses, cfg_s.fusion.max_epipolar_error, cfg_s.fusion.max_cost)
    if want("k2_scaled_chunk"):
        res["k2_scaled_chunk"] = measure(
            cs, lambda: association.associate_fold_batched(ctab_s, conf_s, det_ok, *args_s),
            "association_fold_kernel", 10, fold_bound(cs, ctab_s, conf_s, det_ok, args_s[0]))

    # K3 at the edge of its domain.
    if want("k3_edge"):
        e_state, e_persons, e_pivots, e_fb, e_pre, e_cfg = cs.edge_inputs(dev)
        res["k3_edge"] = measure(
            cs, lambda: tracker.tracker_scan(e_state, e_persons, e_pivots, e_fb, e_pre,
                                             PriorConfig(), e_cfg),
            "tracker_scan_kernel", 5, cs.k3_bound(e_persons, e_state, e_persons.valid.any(dim=1)))

    # K1: the tracker's problem of the online step (16 x 24, 6 active rows,
    # row_active), the batched launch at phase 2's shapes, and one problem
    # at the domain's edge. The bound counts the plain version's search
    # steps on these inputs where the package has that counter.
    cases = (("k1_online", 1, 16, 24, 1), ("k1b", 64, 16, 24, 0), ("k1_64x40x40", 64, 40, 40, 2),
             ("k1_8x120x120", 8, 120, 120, 3), ("k1_120", 1, 120, 120, 4))
    for name, b, r, c, seed in cases:
        if not want(name):
            continue
        rng = np.random.default_rng(seed)
        act = None
        if name == "k1_online":
            cost = rng.uniform(0.0, 8.0, size=(b, r, c)).astype(np.float32)
            act = np.zeros((b, r), bool)
            act[:, :6] = True
            cost[~act] = 1.0e3
        else:
            cost = rng.uniform(size=(b, r, c)).astype(np.float32)
        c_dev = torch.from_numpy(cost).to(dev)
        if b == 1:
            a_dev = None if act is None else torch.from_numpy(act[0]).to(dev)
            fn = lambda c_dev=c_dev, a_dev=a_dev: hungarian.linear_sum_assignment(c_dev[0], a_dev)
        else:
            fn = lambda c_dev=c_dev: hungarian.linear_sum_assignment_batched(c_dev)
        bound = cs.k1_bound(cost, act) if hasattr(hungarian, "PLAIN_SEARCH_STEPS") else None
        res[name] = measure(cs, fn, "jv_assign_kernel", 20 if max(r, c) > 64 else 50, bound)
        if name == "k1b":
            res[name]["plain_ms"] = cs.sync_time(
                lambda: hungarian.linear_sum_assignment_batched_reference(c_dev), 2)

    # K1 past 120 columns, each version's kernels by the name they share.
    b, h, d = cs.SCAN_SHAPE
    wide = (("k1w_128", 1, 128, 128, 5), ("k1w_256", 1, 256, 256, 6), ("k1w_1024", 1, 1024, 1024, 7),
            ("k1w_2048", 1, 2048, 2048, 8), ("k1w_4096", 1, 4096, 4096, 9),
            ("k1w_512", 1, 512, 512, 12), ("k1w_128x8", 1, h, d, 10), ("k1w_16x128x8", b, h, d, 11),
            ("k1w_16x128x8_nomask", b, h, d, 11), ("k1w_16x512x8", b, 512, d, 13))
    for name, b, r, c, seed in wide:
        if not want(name):
            continue
        rng = np.random.default_rng(seed)
        act = None
        if r == c:
            cost = rng.uniform(size=(b, r, c)).astype(np.float32)
        elif b == 1:
            cost = cs.scan_costs(rng, b, r, c)
        else:
            need = rng.uniform(size=b) < cs.SCAN_NEED
            triv = (np.arange(r)[:, None] != np.arange(c)[None, :]).astype(np.float32)
            cost = np.where(need[:, None, None], cs.scan_costs(rng, b, r, c), triv).astype(np.float32)
            act = None if name.endswith("nomask") else np.repeat(need[:, None], r, axis=1)
        c_dev = torch.from_numpy(cost).to(dev)
        a_dev = None if act is None else torch.from_numpy(act).to(dev)
        fn = lambda c_dev=c_dev, a_dev=a_dev: hungarian.linear_sum_assignment_batched(c_dev, a_dev)
        bound = cs.k1_bound(cost, act) if max(r, c) <= 1024 else None
        res[name] = measure(cs, fn, "jv_assign", 2 if max(r, c) > 1024 else 10, bound)

    lm_cases(cs, res, want, dev, rig, cfg, scenes)
    entry_point_cases(cs, res, want, dev, rig, cfg, scenes)
    return res


def lm_cases(cs, res, want, dev, rig, cfg, scenes) -> None:
    """L1 and L2 at the online step's and the offline chunk's batches."""
    try:
        from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior
    except ImportError:
        return
    from smartedgesensor3dhumanpose_tpu_torch import fusion, pipeline, prior
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame, Persons3D

    p_cfg = cfg.prior
    frame, _ = pipeline.mask_stale_cameras(cs.frame_at(scenes["adversarial"], 40, dev),
                                           cfg.fusion.max_sync_diff)
    batches = {"demo": prior.build_graph_inputs(fusion.fuse_frame(frame, rig, cfg.fusion), p_cfg)}
    frames = cs.stacked_frames(scenes["adversarial"], dev)
    chunk, _ = pipeline.mask_stale_cameras(Frame(*(x[:cs.OFFLINE_FUSION_BATCH] for x in frames)),
                                           cfg.fusion.max_sync_diff)
    persons, _ = fusion.fuse_frames(chunk, rig, cfg.fusion)
    batches["chunk32"] = prior.build_graph_inputs(Persons3D(*(x.flatten(0, 1) for x in persons)),
                                                  p_cfg)
    for shape, g_in in batches.items():
        carry, bones = prior._lm_start(g_in, g_in.meas, p_cfg)
        start = prior._fused_carry(carry)
        ins = prior._fused_inputs(g_in, bones)
        work = tuple(t.clone() for t in start)
        p, running = g_in.meas.shape[0], int((~start[3]).sum())

        def trip(work=work, start=start, ins=ins):
            for w, t in zip(work, start):
                w.copy_(t)
            lm_prior.lm_trip(work, *ins, p_cfg)

        if want(f"lm_solve_{shape}"):
            res[f"lm_solve_{shape}"] = lm_solve(cs, lm_prior, start, ins, p_cfg)
        if want(f"lm_trip_{shape}"):
            res[f"lm_trip_{shape}"] = measure(
                cs, trip, "lm_trip_kernel", 50,
                cs.bound_of(lm_prior.trip_bytes(running, p), lm_prior.TRIP_OPS_PER_PERSON * running))
            res[f"lm_trip_{shape}"]["persons"] = p
        if shape == "chunk32" and want("lm_marg_chunk32"):
            x = prior.optimize(g_in, g_in.meas, p_cfg).x
            res["lm_marg_chunk32"] = measure(
                cs, lambda x=x, ins=ins: lm_prior.lm_marginals(x, *ins), "lm_marginals_kernel", 50,
                cs.bound_of(lm_prior.marginals_bytes(p), lm_prior.MARG_OPS_PER_PERSON * p))


def run_lm(lm_prior, work, ins, p_cfg) -> int:
    """The whole LM on the carry `work`, in place: one launch of L1 where the
    checkout has `lm_solve`, else L1 one trip a launch with the host's test
    between trips. Returns the launches."""
    if hasattr(lm_prior, "lm_solve"):
        lm_prior.lm_solve(work, *ins, p_cfg)
        return 1
    launches = 0
    while bool(work[5]) and launches < p_cfg.lm_max_iterations:
        lm_prior.lm_trip(work, *ins, p_cfg)
        launches += 1
    return launches


def lm_solve(cs, lm_prior, start, ins, p_cfg, reps: int = 20) -> dict:
    """The whole LM from the cold start `start` (`run_lm`): device ms per LM
    (its launches summed) and per trip; the bound of the LM, the same for
    either route: `trip_bytes` (each input read and each output written
    once) and the operations of the trips each person ran."""
    work = tuple(t.clone() for t in start)

    def lm():
        for w, t in zip(work, start):
            w.copy_(t)
        run_lm(lm_prior, work, ins, p_cfg)

    durs = cs.kernel_durations(lm, "lm_trip_kernel", reps)
    iters = int(work[4])
    carry, warp_trips = tuple(t.clone() for t in start), 0
    while bool(carry[5]) and int(carry[4]) < p_cfg.lm_max_iterations:
        warp_trips += int((~carry[3]).sum())
        lm_prior.lm_trip(carry, *ins, p_cfg)
    p, running = start[0].shape[0], int((~start[3]).sum())
    device_ms = sum(durs) / 1e3 / reps if durs else None
    bound = cs.bound_of(lm_prior.trip_bytes(running, p), lm_prior.TRIP_OPS_PER_PERSON * warp_trips)
    return {
        "ms": cs.sync_time(lm, reps), "device_ms": device_ms,
        "one_launch": hasattr(lm_prior, "lm_solve"), "launches_per_lm": len(durs) / reps,
        "iters": iters, "warp_trips": warp_trips,
        "device_ms_per_trip": device_ms / iters if device_ms else None,
        "bound_ms": bound[0], "bound_by": bound[1], "persons": p, "running": running,
    }


def entry_point_cases(cs, res, want, dev, rig, cfg, scenes) -> None:
    """The captured entry points through the public API (wall ms)."""
    import time

    from smartedgesensor3dhumanpose_tpu_torch import pipeline

    def wall(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    if want("step_captured"):
        pipe = pipeline.Pipeline(rig, cfg, device=dev)
        ms = []
        for rnd in range(3):
            for s in cs.SCENES:
                state = pipe.init_state()
                for f in range(scenes[s]["kp2d"].shape[0]):
                    frame = cs.frame_at(scenes[s], f, dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, _ = pipe.step(state, frame)
                    torch.cuda.synchronize()
                    if rnd:  # the first round captures
                        ms.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(ms, n=10)
        res["step_captured"] = {"ms": statistics.median(ms), "device_ms": None, "p90_ms": q[-1],
                                "steps": len(ms)}
    if want("offline_adversarial_captured"):
        pipe = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=cs.OFFLINE_FUSION_BATCH)
        frames = cs.stacked_frames(scenes["adversarial"], dev)
        pipe.run_offline(pipe.init_state(), frames)
        ms = [wall(lambda: pipe.run_offline(pipe.init_state(), frames)) for _ in range(5)]
        res["offline_adversarial_captured"] = {"ms": statistics.median(ms), "device_ms": None,
                                               "all_ms": ms}
    if want("chain_captured"):
        pipe = pipeline.Pipeline(rig, cfg, device=dev)
        frames = cs.stacked_frames(scenes["benign"], dev)
        n = frames.kp2d.shape[0]
        pipe.run_per_frame_chain(pipe.init_state(), frames)
        ms = [wall(lambda: pipe.run_per_frame_chain(pipe.init_state(), frames)) / n
              for _ in range(3)]
        res["chain_captured"] = {"ms": statistics.median(ms), "device_ms": None, "all_ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout to time beside this one (repeatable)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated case-name prefixes to time (default: all)")
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = args.cases.split(",") if args.cases else None

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device visible; nothing was run", file=sys.stderr)
        return 2
    if args.worker:
        print(_TAG + json.dumps(worker(args.worker, args.label, only)), flush=True)
        return 0

    smi = _smoke().smi_line()
    others = [(f"other{i}" if len(args.other) > 1 else "other", os.path.abspath(o))
              for i, o in enumerate(args.other)]
    order = others + [("this", _ROOT), ("this", _ROOT)] + others[::-1]
    runs = []
    for label, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root, "--label", label]
        if args.cases:
            cmd += ["--cases", args.cases]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(_TAG)]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
            raise RuntimeError(f"kernel_ab worker {label} ({root}) failed: {proc.returncode}")
        runs.append(json.loads(lines[-1][len(_TAG):]))

    cases = list(dict.fromkeys(k for r in runs for k, v in r.items()
                               if isinstance(v, dict) and "ms" in v))
    print(f"card: {smi}")
    for label, root in others:
        print(f"{label}: {root}")
    print(f"{'case':24s} " + " ".join(f"{r['label'] + ' ms/dev':>22s}" for r in runs) + f" {'bound_ms':>10s}")
    for case in cases:
        cells = " ".join(f"{r[case]['ms']:10.4f}/{r[case]['device_ms'] or float('nan'):<10.4f}"
                         if case in r else f"{'-':>22s}" for r in runs)
        bound = next((r[case]["bound_ms"] for r in runs if "bound_ms" in r.get(case, {})),
                     float("nan"))
        print(f"{case:24s} {cells} {bound:10.3g}")
    for r in runs:
        for s, pf in r.get("k2_per_frame", {}).items():
            if pf["device_us"] is None:
                continue
            by_need = {}
            for n_solve, us in zip(pf["need_solves"], pf["device_us"]):
                by_need.setdefault(n_solve, []).append(us)
            print(f"k2 per frame {r['label']} {s}: mean {statistics.mean(pf['device_us']):.2f} us; "
                  + ", ".join(f"{k} solves: {statistics.mean(v):.2f} us x{len(v)}"
                              for k, v in sorted(by_need.items())))
    if "k1b" in runs[0]:
        print("k1b plain ms: " + " ".join(f"{r['label']} {r['k1b']['plain_ms']:.4f}" for r in runs))
    for r in runs[:len(others) + 1]:
        if r["ptxas"]:
            print(f"ptxas ({r['label']}):\n  " + "\n  ".join(r["ptxas"]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": smi, "others": dict(others), "runs": runs}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
