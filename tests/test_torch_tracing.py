"""The port's recorder (tracing.py): traced pipelines compute what untraced
ones do, bit for bit; stage spans nest and tile their call; the live loop's
set spans tile each stepped set once; the trip records of captured loops
keep the contract chip_smoke.py reads; and, on a card, the traced graphs'
kernel counts and the stage marks' clock against CUPTI's."""

import collections
import contextlib
import dataclasses
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu_torch import (
    cameras,
    config,
    online,
    pipeline,
    tracing,
)
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior, loops
from smartedgesensor3dhumanpose_tpu_torch.types import Frame

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_golden_demo16.npz")
SCENES = ("benign", "adversarial")
STEP_STAGES = ("fusion", "tracking", "feedback")
OFFLINE_STAGES = ("fusion", "smoothing", "tracker", "feedback")
# The untraced step graph's top-level kernel nodes at demo_16cam, as the
# benchmark reads them (live.step_graph_kernels): 3,636 before tracing
# existed, 1,634 since kernel F1 triangulates the hypotheses in one launch,
# 1,633 since kernel E1 computes the pair costs' terms.
UNTRACED_STEP_KERNELS = 1633


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def golden_data(scene: str) -> dict:
    g = np.load(GOLDEN)
    cfg = config.PipelineConfig.demo_16cam()
    kw = json.loads(str(g[f"{scene}/scene"]))
    data = synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw)),
                                       np.float32)
    return synthetic.pad_detections(data, cfg.fusion.max_dets_per_cam)


def small_setup(frames: int = 6):
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=4, num_people=2, num_frames=frames, seed=5))
    data = synthetic.frames_from_scene(scene)
    cfg = config.PipelineConfig(
        fusion=config.FusionConfig(num_cameras=4, max_dets_per_cam=2, max_hypotheses=6),
        tracker=config.TrackerConfig(max_tracks=6),
    )
    return data, cfg, cameras.hall_rig(4, device="cpu")


def children(spans, parent: int):
    return spans[spans["parent"] == parent]


def assert_tiles(spans, top: int, names):
    """The children of span `top` named `names`, in order, begin where it
    begins, end where it ends, and each begins where the last ended."""
    kids = children(spans, top)
    kids = kids[np.isin(kids["name"], names)]
    assert list(kids["name"]) == list(names)
    assert kids["start"][0] == spans["start"][top]
    assert kids["end"][-1] == spans["end"][top]
    np.testing.assert_array_equal(kids["start"][1:], kids["end"][:-1])
    assert np.all(kids["end"] >= kids["start"])
    assert np.all(kids["rid"] == spans["rid"][top])


# ------------------------------------------------------------- on the CPU --

@pytest.mark.parametrize("scene", SCENES)
def test_tracing_leaves_outputs_bit_identical(scene):
    """A traced pipeline's `step` and `run_offline` give the untraced
    pipeline's outputs and states bit for bit (golden scenes, float32)."""
    data = golden_data(scene)
    cfg = config.PipelineConfig.demo_16cam()
    rig = cameras.hall_rig(16, device="cpu")
    plain = pipeline.Pipeline(rig, cfg, device="cpu", fusion_batch=8)
    traced = pipeline.Pipeline(rig, cfg, device="cpu", fusion_batch=8, trace=True)
    assert plain.tracer is None and traced.tracer is not None
    a, b = plain.init_state(), traced.init_state()
    for f in range(12):
        frame = Frame.from_arrays({k: v[f] for k, v in data.items()}, "cpu")
        a, out_a = plain.step(a, frame)
        b, out_b = traced.step(b, frame)
        for x, y in zip(torch.utils._pytree.tree_leaves((a, out_a)),
                        torch.utils._pytree.tree_leaves((b, out_b))):
            assert torch.equal(x, y), f"step, frame {f}"
    frames = Frame.from_arrays({k: v[:24] for k, v in data.items()}, "cpu")
    got_a = plain.run_offline(plain.init_state(), frames)
    got_b = traced.run_offline(traced.init_state(), frames)
    for x, y in zip(torch.utils._pytree.tree_leaves(got_a), torch.utils._pytree.tree_leaves(got_b)):
        assert torch.equal(x, y), "run_offline"
    # A step: itself, fusion, tracking, prior, feedback; a run_offline call:
    # itself, its four stages and the fusion's two children.
    assert len(traced.tracer.drain().spans) == 12 * (1 + 4) + 1 + 4 + 2


def test_step_stage_spans_nest_and_tile():
    """Each traced step is a `Pipeline.step` span inside the caller's span,
    with the caller's request id; `fusion`, `tracking` and `feedback` tile
    it, and `prior` lies inside `tracking`."""
    data, cfg, rig = small_setup()
    pipe = pipeline.Pipeline(rig, cfg, device="cpu", trace=True)
    state = pipe.init_state()
    with pipe.tracer as tr:
        for i in range(5):
            k = tr.open("request", rid=100 + i)
            state, _ = pipe.step(state, Frame.from_arrays({k: v[i] for k, v in data.items()},
                                                          "cpu"))
            tr.close(k)
    rec = tr.drain()
    spans = rec.spans
    assert rec.dropped == 0 and rec.calibration["device"] == "cpu"
    calls = np.flatnonzero(spans["name"] == "Pipeline.step")
    assert len(calls) == 5
    for i, c in enumerate(calls):
        host = spans["parent"][c]
        assert spans["name"][host] == "request" and spans["rid"][c] == 100 + i
        assert spans["start"][host] <= spans["start"][c] <= spans["end"][c] <= spans["end"][host]
        assert spans["device"][c] and not spans["device"][host]
        assert_tiles(spans, c, STEP_STAGES)
        tracking = int(np.flatnonzero((spans["parent"] == c) & (spans["name"] == "tracking"))[0])
        prior = children(spans, tracking)
        assert list(prior["name"]) == ["prior"] and prior["rid"][0] == 100 + i
        assert spans["start"][tracking] <= prior["start"][0] <= prior["end"][0] \
            <= spans["end"][tracking]
    # Drained once: a second drain holds nothing new.
    assert len(tr.drain().spans) == 0


def test_offline_stage_spans_tile_each_call():
    """Each traced run_offline call is a `Pipeline.run_offline` span that
    `fusion`, `smoothing`, `tracker` and `feedback` tile, with the call's
    request id; calls made before the tracer was entered are not read."""
    data, cfg, rig = small_setup(8)
    pipe = pipeline.Pipeline(rig, cfg, device="cpu", fusion_batch=3, trace=True)
    frames = Frame.from_arrays(data, "cpu")
    pipe.run_offline(pipe.init_state(), frames)  # before the tracer: not read
    with pipe.tracer as tr:
        for i in range(3):
            k = tr.open("call", rid=i)
            pipe.run_offline(pipe.init_state(), frames)
            tr.close(k)
    spans = tr.drain().spans
    calls = np.flatnonzero(spans["name"] == "Pipeline.run_offline")
    assert [int(spans["rid"][c]) for c in calls] == [0, 1, 2]
    for c in calls:
        assert spans["name"][spans["parent"][c]] == "call"
        assert_tiles(spans, c, OFFLINE_STAGES)
    assert not np.isin(spans["name"], ["tracking", "prior"]).any()


@pytest.mark.parametrize("impl, steps", [("auto", 0), ("cond_while", 4)])
def test_offline_fusion_marks_association_then_triangulation(impl, steps):
    """Inside each traced run_offline call's `fusion` stage, the children
    `fusion.associate` (every chunk's association) and `fusion.triangulate`
    (every chunk's triangulation) follow each other in that order; the
    fusion counts the camera scan's steps a chunk runs
    (`fusion.association.scan_steps`: the 4 cameras on the scan, 0 on the
    fold) and the hypotheses F1 and its wide variant triangulate (0 each
    on the CPU's plain body), once per chunk, and their stages' kernels."""
    data, cfg, rig = small_setup(8)
    cfg = dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, assignment_impl=impl))
    pipe = pipeline.Pipeline(rig, cfg, device="cpu", fusion_batch=3, trace=True)
    frames = Frame.from_arrays(data, "cpu")
    with pipe.tracer as tr:
        for i in range(2):
            k = tr.open("call", rid=i)
            pipe.run_offline(pipe.init_state(), frames)
            tr.close(k)
    rec = tr.drain()
    spans = rec.spans
    calls = np.flatnonzero(spans["name"] == "Pipeline.run_offline")
    assert len(calls) == 2
    for c in calls:
        fusion_span = int(np.flatnonzero((spans["parent"] == c) & (spans["name"] == "fusion"))[0])
        kids = children(spans, fusion_span)
        assert list(kids["name"]) == ["fusion.associate", "fusion.triangulate"]
        assert spans["start"][fusion_span] <= kids["start"][0] <= kids["end"][0] \
            <= kids["start"][1] <= kids["end"][1] <= spans["end"][fusion_span]
        assert np.all(kids["rid"] == spans["rid"][c])
    counters = rec.counters[rec.counters["scope"] == "Pipeline.run_offline"]
    got = collections.defaultdict(list)
    for name, value in zip(counters["name"], counters["value"]):
        got[str(name)].append(int(value))
    # Three chunks of 3, 3 and 2 frames.
    assert got["fusion.association.scan_steps"] == [steps] * 3
    assert got["fusion.triangulation.f1"] == got["fusion.triangulation.f1w"] == [0] * 3


def test_marks_must_repeat_the_first_calls_layout():
    """A traced entry point takes the same marks every call: another order
    raises, and a stage left open is refused."""
    ring = tracing.StageMarks("probe", "cpu", tracing.Tracer())
    with ring.call():
        tracing.stage("a")
        tracing.stage("b")
    assert ring.layout == ("a", "b", tracing.END)
    with pytest.raises(RuntimeError, match="the calls before took"):
        with ring.call():
            tracing.stage("b")
    with pytest.raises(RuntimeError, match="left open|leave a stage open"):
        tracing._stages_of(("a", "+x", tracing.END))
    assert tracing._MARKS is None


def test_online_set_spans_tile_every_stepped_set(tmp_path):
    """The synchronized live loop: one row of stamps per stepped set, in
    order, and while a tracer records, each of `sync.hold`, `sync.pack`,
    `slot`, `frame.build` and `step` once per stepped set with its index,
    each beginning where the last ended; the report's latencies come from
    the same stamps; the step's graph spans nest in `step`."""
    from smartedgesensor3dhumanpose_tpu_torch.io import replay

    data, cfg, rig = small_setup(10)
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=4, num_people=2, num_frames=10, seed=5, stamp_jitter=0.003))
    path = str(tmp_path / "r.jsonl")
    replay.save_jsonl(path, scene)
    messages = list(replay.load_jsonl_messages(path))
    pipe = pipeline.Pipeline(rig, cfg, device="cpu", trace=True)

    def build(fd):
        return online.default_frame_builder(fd, "cpu")

    with pipe.tracer as tr:
        _, _, report = online.run_online_synced(pipe.step, pipe.init_state(), messages, 4, 2,
                                                message_interval_s=0.002, frame_builder=build)
    sets = report.sets
    assert sets.shape == (report.processed_frames, 2 + len(online.SET_SPANS))
    assert report.processed_frames > 0
    assert np.all(np.diff(sets[:, 0]) > 0)
    assert np.all(np.diff(sets[:, 1:], axis=1) >= 0)
    np.testing.assert_allclose(report.e2e_ms, (sets[:, 6] - sets[:, 1]) * 1e-6)
    np.testing.assert_allclose(report.step_ms, (sets[:, 6] - sets[:, 5]) * 1e-6)
    spans = tr.drain().spans
    for row in sets:
        mine = spans[(spans["rid"] == row[0]) & np.isin(spans["name"], online.SET_SPANS)]
        mine = mine[np.argsort(mine["start"], kind="stable")]
        assert list(mine["name"]) == list(online.SET_SPANS)
        np.testing.assert_array_equal(mine["start"][1:], mine["end"][:-1])
        assert (mine["end"][-1] - mine["start"][0]) == pytest.approx(
            float(row[6] - row[1]), abs=2e3)
    steps = np.flatnonzero(spans["name"] == "step")
    marks = np.flatnonzero(spans["name"] == "Pipeline.step")
    assert len(steps) == len(marks) == len(sets)
    assert set(spans["parent"][marks]) == set(steps)


def test_host_spans_off_without_a_tracer(monkeypatch):
    """With no tracer recording, a traced pipeline's call records no span,
    and its ring still counts the call."""
    recorded = []
    monkeypatch.setattr(tracing.Tracer, "span", lambda self, *a, **k: recorded.append(a))
    assert tracing.active() is None
    data, cfg, rig = small_setup(3)
    pipe = pipeline.Pipeline(rig, cfg, device="cpu", trace=True)
    pipe.step(pipe.init_state(), Frame.from_arrays({k: v[0] for k, v in data.items()}, "cpu"))
    assert recorded == [] and pipe._step_marks.calls == 1


class _StubLib:
    """The kernel library's loop and L1 entries, recording their calls."""

    def __init__(self):
        self.calls = []

    def ses3d_loop_begin(self, *args):
        self.calls.append("begin")
        return 0

    def ses3d_loop_next(self, *args):
        self.calls.append("next")
        return 0

    def ses3d_loop_end(self, stream, nodes):
        nodes._obj.value = 7
        self.calls.append("end")
        return 0

    def ses3d_lm_trip(self, *args):
        self.calls.append("lm")
        return 0


@contextlib.contextmanager
def _capturing_on_fake_cuda(monkeypatch):
    """A capture's loops on the CPU: CUDA tensors faked, torch.cuda's
    streams and pools stood in for, the kernel library stubbed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    stub = _StubLib()

    class Stream:
        def __init__(self, device=None, priority=0):
            self.cuda_stream = id(self)

    monkeypatch.setattr(loops._kernels, "library", lambda: stub)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "MemPool", lambda: types.SimpleNamespace(id=(0, 1)))
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(lm_prior.linalg, "capturing", lambda t: True)
    for name in ("_cuda_beginAllocateCurrentStreamToPool", "_cuda_endAllocateToPool",
                 "_cuda_releasePool"):
        monkeypatch.setattr(torch._C, name, lambda *a: None, raising=False)
    with FakeTensorMode():
        yield stub


def test_loop_records_keep_the_trip_log_contract(monkeypatch):
    """A WHILE node and the LM's one launch captured while a tracer records
    leave (trips int32 0-d, stamps int64 [max trips + 1]) in its trip log,
    in capture order (what chip_smoke.py's log_trips / log_spans_ms read),
    and the WHILE body's node count as `loop.body_nodes`; nothing is kept
    with no tracer recording."""
    cfg = config.PipelineConfig.demo_16cam().prior
    dev = torch.device("cuda", 0)
    with _capturing_on_fake_cuda(monkeypatch) as stub:
        bodies = loops.Bodies(dev, torch.cuda.Stream(dev))
        pred = torch.empty((), dtype=torch.bool, device=dev)
        carry = [torch.empty(s, dtype=d, device=dev) for s, d in (
            ((4, 21, 3), torch.float32), ((4,), torch.float32), ((4,), torch.float32),
            ((4,), torch.bool), ((), torch.int32), ((), torch.bool), ((2,), torch.int32))]
        ins = [torch.empty(s, dtype=d, device=dev) for s, d in (
            ((4, 21, 3), torch.float32), ((4, 21), torch.bool), ((4, 21, 3, 3), torch.float32),
            ((4, 21), torch.bool), ((21,), torch.float32), ((21,), torch.float32))]
        tracer = tracing.Tracer()
        with loops.capturing_into(bodies), tracing.recording(tracer):
            with loops._while_node(pred, 5) as trip:
                trip.repeat_while(pred)
            lm_prior.lm_solve(tuple(carry), *ins, cfg)
        with loops.capturing_into(bodies):   # no tracer: no record
            with loops._while_node(pred, 5) as trip:
                trip.repeat_while(pred)
        log = tracer.trip_log()
        assert [(t.dtype, tuple(t.shape), s.dtype, tuple(s.shape)) for t, s in log] == [
            (torch.int32, (), torch.int64, (6,)),
            (torch.int32, (), torch.int64, (cfg.lm_max_iterations + 1,))]
        assert [lp.kind for lp in tracer.loops] == ["while", "lm"]
        assert tracer.body_nodes() == [7]
    assert stub.calls == ["begin", "next", "end", "lm", "begin", "next", "end"]
    assert not hasattr(loops, "trip_log") and not hasattr(loops, "body_nodes")


def test_chip_smoke_reads_the_trip_log(monkeypatch):
    """chip_smoke.py's readers of the trip log: the trips of each loop and
    its span from stamps[0] to stamps[trips]; a drain turns the last call's
    loops into `loop` (and per-trip `loop.trip`) spans inside their stage."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    tracer = tracing.Tracer()
    ring = tracing.StageMarks("probe", "cpu", tracer)
    with ring.call():
        tracing.stage("work")
        t0 = ring.ring[0, 0]
        stamps = torch.tensor([t0 + 10, t0 + 20, t0 + 35, 0], dtype=torch.int64)
        with tracing.recording(tracer):
            tracer.loop(torch.tensor(2, dtype=torch.int32), stamps, "while")
    log = tracer.trip_log()
    assert chip_smoke.log_trips(log) == [2]
    assert chip_smoke.log_spans_ms(log) == [25e-6]
    spans = tracer.drain().spans
    work = int(np.flatnonzero(spans["name"] == "work")[0])
    loop = int(np.flatnonzero(spans["name"] == "loop")[0])
    assert spans["parent"][loop] == work
    assert spans["end"][loop] - spans["start"][loop] == 25
    trips = spans[spans["parent"] == loop]
    assert list(trips["name"]) == ["loop.trip"] * 2


def test_clock_maps_keep_integer_nanoseconds():
    """The host-to-unix map interpolates offset and drift and keeps ns
    exact at the magnitude of unix time."""
    points = [(1_000, 1_792_000_000_000_000_000, 0), (1_001_000, 1_792_000_000_001_000_100, 0)]
    to_unix = tracing._line(points, 0, 1)
    assert int(to_unix(np.int64(1_000))) == 1_792_000_000_000_000_000
    assert int(to_unix(np.int64(501_000))) == 1_792_000_000_000_500_050


def test_records_move_onto_a_profilers_clock():
    """While a profiler records, entering and draining a tracer leave
    ANCHOR ranges in its trace; `on_profiler_clock` maps the records
    through them, so a span taken around a profiler range lands around it
    on the trace's clock."""
    tracer = tracing.Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer:
            a = time.perf_counter_ns()
            with torch.profiler.record_function("probe"):
                time.sleep(0.002)
            tracer.span("around", a, time.perf_counter_ns())
            records = tracer.drain()
    events = prof.profiler.kineto_results.events()
    assert len(records.calibration["anchors"]) == 6
    moved = tracing.on_profiler_clock(records, events).spans
    probe = [e for e in events if e.name() == "probe"][0]
    assert moved["start"][0] <= probe.start_ns() + 200_000
    assert moved["end"][0] >= probe.start_ns() + probe.duration_ns() - 200_000
    with pytest.raises(ValueError, match="ranges"):
        tracing.on_profiler_clock(records, [])


# -------------------------------------------------------------- on a card --

def _kernel_nodes(captured) -> int:
    from portbench.lib import harness

    return harness.graph_kernel_nodes(captured)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the stage marks and graphs are CUDA")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_graph_kernel_counts_on_card():
    """The untraced step graph has the untraced port's kernel nodes; a
    traced graph's per-stage counters sum to its top-level kernels less its
    marks, for the step and for run_offline; the fusion counts the
    hypotheses kernel F1 triangulated per call."""
    dev = _card()
    data = golden_data("benign")
    cfg = config.PipelineConfig.demo_16cam()
    rig = cameras.hall_rig(16, device=dev)
    frame = Frame.from_arrays({k: v[0] for k, v in data.items()}, dev)
    frames = Frame.from_arrays({k: v[:32] for k, v in data.items()}, dev)
    plain = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=16)
    traced = pipeline.Pipeline(rig, cfg, device=dev, fusion_batch=16, trace=True)
    for p in (plain, traced):
        p._step.keep_graph = p._offline.keep_graph = True
        p.step(p.init_state(), frame)
        p.run_offline(p.init_state(), frames)
    assert _kernel_nodes(plain._step) == UNTRACED_STEP_KERNELS
    counters = traced.tracer.drain().counters
    for entry, stages, untraced in (("Pipeline.step", STEP_STAGES, plain._step),
                                    ("Pipeline.run_offline", OFFLINE_STAGES, plain._offline)):
        mine = counters[counters["scope"] == entry]
        got = {n: int(v) for n, v in zip(mine["name"], mine["value"])}
        marks = got["marks"]
        total = _kernel_nodes(traced._step if entry == "Pipeline.step" else traced._offline)
        assert sum(got[f"{s}.kernels"] for s in stages) == total - marks, (entry, got)
        assert total - marks == _kernel_nodes(untraced), entry
        # F1 triangulates a step's 16 hypothesis slots, and 16 frames' per
        # offline chunk, in one launch each.
        assert got["fusion.triangulation.f1"] == (16 if entry == "Pipeline.step" else 256), got


@pytest.mark.cuda
def test_marks_lie_in_their_cupti_launches_on_card():
    """Each stage mark's %globaltimer, mapped to the trace's clock (the
    tracer's calibration, then its anchors in the trace), lies inside its
    own kernel's CUPTI interval within 5 us."""
    dev = _card()
    data = golden_data("benign")
    cfg = config.PipelineConfig.demo_16cam()
    pipe = pipeline.Pipeline(cameras.hall_rig(16, device=dev), cfg, device=dev, trace=True)
    state = pipe.init_state()
    frames = [Frame.from_arrays({k: v[f] for k, v in data.items()}, dev) for f in range(12)]
    state, _ = pipe.step(state, frames[0])
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with pipe.tracer as tr:
            for f in frames[1:]:
                state, _ = pipe.step(state, f)
                torch.cuda.synchronize(dev)
            records = tr.drain()
    events = prof.profiler.kineto_results.events()
    spans = tracing.on_profiler_clock(records, events).spans
    launches = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                      if e.device_type() == torch.autograd.DeviceType.CUDA
                      and "stage_mark_kernel" in e.name())
    marks = []
    stages = np.isin(spans["name"], STEP_STAGES + ("prior",))
    for c in np.flatnonzero(spans["name"] == "Pipeline.step"):
        top = np.flatnonzero(spans["parent"] == c)
        inside = spans[stages & ((spans["parent"] == c) | np.isin(spans["parent"], top))]
        marks += sorted(set(inside["start"]) | set(inside["end"]))
    assert len(marks) == len(launches) == 11 * 6
    residual = [max(a - m, m - b, 0) for m, (a, b) in zip(marks, launches)]
    print("mark residuals (ns): max", max(residual), "p50", float(np.median(residual)),
          "by mark:", np.asarray(residual).reshape(-1, 6).max(axis=0).tolist(),
          "by step:", np.asarray(residual).reshape(-1, 6).max(axis=1).tolist(),
          "mark - launch end:", [int(m - b) for m, (a, b) in zip(marks, launches)][:18])
    assert max(residual) <= 5_000
