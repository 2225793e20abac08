"""The pipeline split over a (data, model) mesh of devices.

Port of the JAX package's parallel/sharding.py, the system's scale-out
path. There, one jitted GSPMD program spans a `jax.sharding.Mesh` and XLA
inserts the collectives. The port stays one process with explicit
placement:

* every split stage runs its shards in turn in the caller's thread, each
  under its device. On a card each shard is the replay of a CUDA graph
  (graphs.py) of its own (stage, device, entry), on a CUDA stream kept for
  that (device, entry), so the shards compute at once while the host
  dispatches, and the LM inside one stops on the device: with the tree
  solver it is one launch of L1, with the dense one a WHILE node that
  ends as `lax.while_loop` does (prior.py). Host threads made every stage
  slower (PERF.md);
* the collectives are device-to-device copies onto the mesh's home device
  (`Tensor.to(home, non_blocking=True)`), outside the graphs. Before a
  gather the home stream waits on an event recorded at the end of each
  shard's stream, and `record_stream` tells the caching allocator about
  every tensor that crosses streams. On the CPU the same code runs
  eagerly with no streams.

A mesh may name one device several times: `[torch.device("cpu")] * 8`
stands for the JAX tests' virtual 8-device CPU mesh, `[cuda:0] * 4` for a
4-entry mesh on one card. Each entry of a card has graphs of its own:
entries of one card replay at once, and a graph's static buffers and
memory pools serve one replay at a time.

`run_offline_sharded` is the offline replay (JAX :104-217):
  1. fusion over the time axis, one contiguous shard per data row, on the
     row's first device (`pipeline.fuse_offline`: one association-fold
     launch per `fusion_batch` chunk);
  2. the cold-start LM (`tracking.smooth_cold`) on each row's persons,
     frames x hypotheses flattened and split over the row's model devices.
     Every person stops on its own `done`, so no person's result depends on
     the split; only `PriorResult.iters` (the largest count) may differ;
  3. the tracker scan once, on the home device (one K3 launch on a card).
     JAX replicates it on every device, which all compute the same result;
  4. reprojection over the time axis again, split over the data rows.
`fuse_frame_sharded` is one frame's fusion for the 64-camera hall (JAX
:70-101, the stages that fusion.py's `sharding_hook` tags): normalisation
split over the cameras, association on the home device (K2),
triangulation split over the hypotheses, the gate and merge on home.
Each stage on home is a graph too. The rig goes into every graph as an
input (copied to each device on each call), so a graph reads no tensor
that a later call frees.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Optional, Sequence

import torch

from smartedgesensor3dhumanpose_tpu_torch import cameras, fusion, graphs, pipeline
from smartedgesensor3dhumanpose_tpu_torch.config import (
    FusionConfig,
    PipelineConfig,
    TrackerConfig,
)
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import linalg, tracker
from smartedgesensor3dhumanpose_tpu_torch.types import (
    CameraRig,
    Frame,
    Persons3D,
    TrackerState,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data x model grid of devices: `devices[r][j]` is entry (r, j)."""

    devices: tuple  # data rows, each a tuple of `model` torch.devices

    @property
    def shape(self) -> dict:
        """{"data": rows, "model": entries per row}, as JAX's `mesh.shape`."""
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        """Entry (0, 0): where gathers land and the outputs live."""
        return self.devices[0][0]

    def axis(self, name: str) -> list:
        """The devices along one axis, at the first entry of the other (a
        JAX array sharded over one axis is replicated over the other)."""
        if name == "data":
            return [row[0] for row in self.devices]
        if name == "model":
            return list(self.devices[0])
        raise ValueError(f"mesh axes are 'data' and 'model', got {name!r}")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over the first n_devices of `devices`: every
    visible card when `devices` is None (and no card raises). `devices`
    may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= for a mesh "
                "elsewhere, e.g. [torch.device('cpu')] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"n_devices ({n}) exceeds the {len(devices)} devices given")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"data*model ({data}*{model}) != n_devices ({n})")
    if len({d.type for d in devices[:n]}) != 1:
        raise ValueError(f"a mesh is all CUDA or all CPU, got {devices[:n]}")
    return Mesh(tuple(tuple(devices[r * model:(r + 1) * model]) for r in range(data)))


# ------------------------------------------------------------ execution --

def _split(n: int, parts: int) -> list:
    """The [lo, hi) bounds of `torch.tensor_split` of n items into `parts`
    (the first n % parts get one more); empty ones included."""
    q, r = divmod(n, parts)
    bounds, lo = [], 0
    for i in range(parts):
        hi = lo + q + (i < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _map(fn, tree):
    """`fn` over every tensor of a (named) tuple tree; other leaves pass
    through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        values = [_map(fn, x) for x in tree]
        return type(tree)(*values) if hasattr(tree, "_fields") else type(tree)(values)
    return tree


def _to(tree, device: torch.device):
    return _map(lambda t: t.to(device, non_blocking=True), tree)


def _rows(tree, lo: int, hi: int):
    return _map(lambda t: t[lo:hi], tree)


def _mark(tree, stream) -> None:
    """Tell the caching allocator that `stream` uses the tree's tensors on
    its device, so their memory is not reused before its work is done."""
    def one(t):
        if t.device == stream.device:
            t.record_stream(stream)
        return t

    _map(one, tree)


_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def _stream(device: torch.device, k: int):
    """The k-th stream of `device` for shard work. It is kept across calls:
    the caching allocator reuses a block only on the stream it was made
    for, so a fresh stream per call allocates anew."""
    with _STREAMS_LOCK:
        if (device, k) not in _STREAMS:
            _STREAMS[(device, k)] = torch.cuda.Stream(device)
        return _STREAMS[(device, k)]


@dataclasses.dataclass(frozen=True)
class _Stage:
    """One stage of a sharded path: `body`, a function of tensors only, and
    `key`, its name and every value `body` depends on besides its
    arguments (a config, a chunk size). `stage(device, *args)` runs it
    eagerly, as the CPU does."""

    key: tuple
    body: Callable

    def __call__(self, device, *args):
        return self.body(*args)


# (stage key..., device, entry) -> graphs.CapturedFunction, least recently
# used first.
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
# Captured functions kept; each keeps the graphs of its
# `CapturedFunction.max_graphs` most recent input signatures (shards of
# unequal length are several signatures of one function).
MAX_CAPTURED = 64


def _captured(stage: _Stage, device: torch.device, k: int) -> graphs.CapturedFunction:
    """The captured function of `stage` for entry k of `device` (the k-th
    job on that device), made on first use; the least recently used
    beyond MAX_CAPTURED is dropped with its graphs."""
    key = (*stage.key, device, k)
    captured = _GRAPHS.pop(key, None)
    if captured is None:
        captured = graphs.CapturedFunction(stage.body, f"sharded {stage.key[0]} on {device} "
                                                       f"entry {k}")
    _GRAPHS[key] = captured
    while len(_GRAPHS) > MAX_CAPTURED:
        _GRAPHS.popitem(last=False)
    return captured


def _on_home(stage: _Stage, home: torch.device, *args):
    """A stage that needs every shard's result, on `home`: eagerly on the
    CPU, else the replay of its graph on home's current stream."""
    if home.type != "cuda":
        return stage(home, *args)
    return _captured(stage, home, 0)(*args)


def _run(fn: _Stage, jobs: list, home: torch.device) -> list:
    """`fn` on each `(device, args)` of `jobs`; returns the results,
    gathered on `home`, in job order.

    The jobs run in turn in the caller's thread, each under its device. On
    a card job j is the replay of the graph of (fn, device, k), k counting
    the jobs on that device, on a stream of its own, so a job's kernels
    run on while the next job is dispatched, and every card at once. The
    stages are bound by host dispatch: host threads, one per card or one
    per job, made them several times slower (PERF.md). The args
    (tensors on `home`) are copied to their device on the caller's
    streams, and each job's stream first waits for those copies. Every
    gather waits on an event recorded at the end of the job's stream."""
    if home.type != "cuda":
        return [fn(dev, *args) for dev, args in jobs]
    per_device: dict = {}
    results = []
    for dev, args in jobs:
        args = _to(args, dev)
        ready = torch.cuda.current_stream(dev).record_event()
        k = per_device[dev] = per_device.get(dev, -1) + 1
        run = _captured(fn, dev, k)
        with torch.cuda.device(dev):
            stream = _stream(dev, k)
            stream.wait_event(ready)
            _mark(args, stream)
            with torch.cuda.stream(stream):
                out = run(*args)
            results.append((dev, out, stream.record_event()))
    gathered = []
    for dev, out, done in results:
        torch.cuda.current_stream(home).wait_event(done)
        local = torch.cuda.current_stream(dev)
        local.wait_event(done)
        _mark(out, local)
        gathered.append(_to(out, home))
    return gathered


def _check_inputs(home: torch.device, **tensors) -> None:
    """The inputs must live on the home device; on a card, matrix products
    are pinned to IEEE fp32 as `Pipeline` pins them."""
    for name, t in tensors.items():
        if t.device != home:
            raise ValueError(f"{name} is on {t.device}; the mesh's home device is {home}")
    if home.type == "cuda":
        linalg.require_ieee_fp32()


# --------------------------------------------------------- offline replay --

def run_offline_sharded(rig: CameraRig, config: PipelineConfig, mesh: Mesh,
                        frames: Frame, state: TrackerState, fusion_batch: int = 64):
    """The offline replay of a stacked sequence (leading time axis on every
    Frame field) split over the mesh: returns what `Pipeline.run_offline`
    returns, (final state, StepOutput with a leading time axis), on
    `mesh.home`, where `rig`, `frames` and `state` must live. `state` is
    left as it was."""
    home = mesh.home
    _check_inputs(home, rig=rig.P, frames=frames.kp2d, state=state.alive)
    if fusion_batch < 1:
        raise ValueError(f"fusion_batch must be >= 1, got {fusion_batch}")
    n = frames.kp2d.shape[0]
    rows = [(r, lo, hi) for r, (lo, hi) in enumerate(_split(n, mesh.shape["data"])) if hi > lo]

    # 1. Fusion: one contiguous time shard per data row.
    fuse = _Stage(("fuse", config, fusion_batch),
                  lambda shard, rig_: pipeline.fuse_offline(shard, rig_, config, fusion_batch))
    persons, pivots, n_drop = pipeline._cat(_run(
        fuse, [(mesh.devices[r][0], (_rows(frames, lo, hi), rig)) for r, lo, hi in rows], home
    ))

    # 2. Cold-start LM: each row's persons, frames x hypotheses flattened,
    # split over the row's model devices, `fusion_batch` frames' worth at a
    # time (as run_offline chunks it).
    h = persons.valid.shape[1]
    flat = Persons3D(*(x.flatten(0, 1) for x in persons))
    jobs = []
    for r, lo, hi in rows:
        for dev, (a, b) in zip(mesh.devices[r], _split((hi - lo) * h, mesh.shape["model"])):
            if b > a:
                jobs.append((dev, (_rows(flat, lo * h + a, lo * h + b),)))
    chunk = fusion_batch * h
    smooth = _Stage(("smooth", config, chunk),
                    lambda part: pipeline.smooth_offline(part, config, chunk))
    pre = _map(lambda x: x.reshape((n, h) + x.shape[1:]) if x.dim() else x,
               pipeline._cat(_run(smooth, jobs, home)))
    return track_sharded(rig, config, mesh, frames, state, persons, pivots, n_drop, pre)


def track_sharded(rig: CameraRig, config: PipelineConfig, mesh: Mesh, frames: Frame,
                  state: TrackerState, persons: Persons3D, pivots, n_dropped_hyp, pre):
    """Stages 3 and 4 of `run_offline_sharded` from the fusion's outputs
    (persons, pivots, n_dropped_hyp) and the stacked `smooth_cold` output
    `pre`, all on `mesh.home`: the tracker scan once on home, then the
    reprojection split over the data rows. Returns (final state,
    StepOutput)."""
    home = mesh.home
    _check_inputs(home, rig=rig.P, frames=frames.kp2d, state=state.alive,
                  persons=persons.xyz)
    scan = _Stage(("track", config), lambda st, ps, pv, fb, pr: tracker.tracker_scan(
        st, ps, pv.to(ps.xyz.dtype), fb, pr, config.prior, config.tracker))
    state_out, track = _on_home(scan, home, state, persons, pivots, frames.fb_delay, pre)
    n = frames.kp2d.shape[0]
    jobs = [
        (dev, (_rows(track.fused_pred, lo, hi), track.pred_delta_t[lo:hi],
               frames.cam_stamp[lo:hi], rig))
        for dev, (lo, hi) in zip(mesh.axis("data"), _split(n, mesh.shape["data"])) if hi > lo
    ]
    reproject = _Stage(("reproject", config), lambda fused_pred, pred_delta_t, cam_stamp, rig_:
                       pipeline.offline_feedback(fused_pred, pred_delta_t, cam_stamp, rig_, config))
    feedback = pipeline._cat(_run(reproject, jobs, home))
    return state_out, pipeline.offline_outputs(
        frames, persons, pivots, n_dropped_hyp, track, rig, config, feedback=feedback
    )


# ------------------------------------------------------ one frame's fusion --

def _camera_subset(rig: CameraRig, lo: int, hi: int) -> CameraRig:
    """The rig of cameras lo..hi-1."""
    return CameraRig(K=rig.K[lo:hi], P=rig.P[lo:hi], F=rig.F[lo:hi, lo:hi],
                     image_size=rig.image_size[lo:hi])


def fuse_frame_sharded(frame: Frame, rig: CameraRig, config: PipelineConfig, mesh: Mesh,
                       axis: str = "model", with_stats: bool = False):
    """One synchronized frame's fusion split over one mesh axis: returns
    what `fusion.fuse_frame(frame, rig, config.fusion, with_stats)` returns,
    on `mesh.home`, where `frame` and `rig` must live. Stale cameras are
    the caller's to mask, as for `fusion.fuse_frame`."""
    home = mesh.home
    _check_inputs(home, rig=rig.P, frame=frame.kp2d)
    cfg = config.fusion
    devices = mesh.axis(axis)

    # 1. Normalisation split over the camera axis, then gathered.
    c = frame.kp2d.shape[0]
    jobs = [
        (dev, (_rows(frame, lo, hi), _camera_subset(rig, lo, hi)))
        for dev, (lo, hi) in zip(devices, _split(c, len(devices))) if hi > lo
    ]
    normalize = _Stage(("normalize", cfg), lambda part, sub: fusion.normalize_frame(part, sub, cfg))
    kp_n, cov_n, det_ok = (torch.cat(x) for x in zip(*_run(normalize, jobs, home)))

    # 2. The greedy association over all cameras, on home.
    associate = _Stage(("associate", cfg), lambda kp, cov, score, ok, rig_:
                       fusion.associate(kp, cov, score, ok, rig_, cfg))
    hyps = _on_home(associate, home, kp_n, cov_n, frame.det_score, det_ok, rig)

    # 3. Triangulation split over the hypothesis axis, then gathered.
    h = hyps.cam_mask.shape[0]
    jobs = [
        (dev, (hyps._replace(kp=hyps.kp[lo:hi], cov=hyps.cov[lo:hi],
                             cam_mask=hyps.cam_mask[lo:hi],
                             obs_score=hyps.obs_score[lo:hi]), rig))
        for dev, (lo, hi) in zip(devices, _split(h, len(devices))) if hi > lo
    ]
    triangulate = _Stage(("triangulate", cfg), lambda part, rig_:
                         fusion.triangulate_hypotheses(part, rig_, cfg))
    persons = Persons3D(*(torch.cat(x) for x in zip(*_run(triangulate, jobs, home))))

    # 4. The gate and the merge, which need every hypothesis, on home.
    gate = _Stage(("gate_and_merge", cfg), lambda ps, hy: fusion.gate_and_merge(ps, hy, cfg))
    persons = _on_home(gate, home, persons, hyps)
    return (persons, hyps.n_dropped) if with_stats else persons


# ---------------------------------------------------------------- dry run --

def _demo_setup(num_cameras: int, num_people: int, num_frames: int, device):
    """(rig, config, frames, state) of the JAX package's multi-chip dry run
    (__graft_entry__._demo_setup): a seed-0 synthetic scene, float32."""
    rig = cameras.hall_rig(num_cameras, device=device)
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(num_cameras=num_cameras, num_people=num_people,
                              num_frames=num_frames, seed=0),
        rig=rig,
    )
    config = PipelineConfig(
        fusion=FusionConfig(num_cameras=num_cameras, max_dets_per_cam=num_people,
                            max_hypotheses=2 * num_people, max_epipolar_error=0.045),
        tracker=TrackerConfig(max_tracks=2 * num_people),
    )
    frames = Frame.from_arrays(synthetic.frames_from_scene(scene), device)
    t = config.tracker
    state = TrackerState.initial(t.max_tracks, t.n_mov_avg, t.avg_delay, device=device)
    return rig, config, frames, state


def dryrun(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> dict:
    """The multi-device self-check, at the JAX package's shapes
    (__graft_entry__._dryrun_multichip_impl):

    * a tiny `run_offline_sharded` (4 cameras x 2 people, one frame per
      data shard) on a (n/2, 2) mesh when n is even and >= 4, else (n, 1):
      its fused joints must be finite;
    * `fuse_frame_sharded` on a flat (1, n) mesh at the 64-camera x
      25-person hall with `PipelineConfig.scaled_64cam()` (detections
      padded to its 32 slots), held to the unsharded `fusion.fuse_frame`:
      `valid` equal, published joints within 1 mm, at least one compared.

    `devices` as for `make_mesh` (every visible card when None). Raises on
    a failure; returns what was compared."""
    n = make_mesh(n_devices, devices=devices).shape["data"]
    model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(n, model=model, devices=devices)
    home = mesh.home
    rig, config, frames, state = _demo_setup(4, 2, mesh.shape["data"], home)
    _, outs = run_offline_sharded(rig, config, mesh, frames, state)
    if not bool(torch.isfinite(outs.fused.xyz).all()):
        raise AssertionError("sharded replay gave non-finite fused joints")

    big_config = PipelineConfig.scaled_64cam()
    big_rig = cameras.hall_rig(64, device=home)
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(num_cameras=64, num_people=25, num_frames=1, seed=0), rig=big_rig
    )
    data = synthetic.pad_detections(synthetic.frames_from_scene(scene),
                                    big_config.fusion.max_dets_per_cam)
    frame = Frame(*(x[0] for x in Frame.from_arrays(data, home)))
    frame, _ = pipeline.mask_stale_cameras(frame, big_config.fusion.max_sync_diff)
    want = fusion.fuse_frame(frame, big_rig, big_config.fusion)
    flat = make_mesh(n, data=1, model=n, devices=devices)
    got = fuse_frame_sharded(frame, big_rig, big_config, flat)
    if not torch.equal(got.valid, want.valid):
        raise AssertionError("sharded 64x25 fusion: valid differs from the unsharded fusion")
    on = want.valid[:, None] & (want.score > 0)
    diff = (got.xyz - want.xyz).abs()[on]
    # Separate checks: no published joint is a coverage fault of the scene
    # or the gates, not a divergence of the split.
    if diff.numel() == 0:
        raise AssertionError("64x25 frame published no valid joints to compare")
    worst = float(diff.max())
    if not worst < 1e-3:
        raise AssertionError(
            f"sharded 64x25 fusion diverges from unsharded: worst {worst:.2e} m over "
            f"{diff.numel()} joints"
        )
    return {"mesh": mesh.shape, "replay_frames": int(frames.kp2d.shape[0]),
            "fusion_mesh": flat.shape, "joints_compared": diff.numel(),
            "persons": int(want.valid.sum()), "worst_m": worst}
