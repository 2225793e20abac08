"""The port's host runtime and live loops against the JAX package: the
native runtime's source, the approximate-time synchronizer and latest-wins
slot (native and Python), JSONL/NPZ replay, the latest-wins online loops,
the closed feedback loop through virtual sensors, and tracker checkpoints
that resume across the two packages.

Inputs are made once with numpy from a seed and fed to both sides; JAX runs
on the CPU with x64 as conftest sets it up (one compiled step for the
module), the port on CPU tensors (its kernels' plain versions). The native
runtime is built here with g++ from the port's own copy of the source.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import checkpoint as jax_checkpoint
from smartedgesensor3dhumanpose_tpu import config as jax_config
from smartedgesensor3dhumanpose_tpu import monitor as jax_monitor
from smartedgesensor3dhumanpose_tpu import online as jax_online
from smartedgesensor3dhumanpose_tpu import pipeline as jax_pipeline
from smartedgesensor3dhumanpose_tpu import sync as jax_sync
from smartedgesensor3dhumanpose_tpu.io import replay as jax_replay
from smartedgesensor3dhumanpose_tpu.io import sensors as jax_sensors
from smartedgesensor3dhumanpose_tpu.io import synthetic as jax_synthetic
from smartedgesensor3dhumanpose_tpu.types import Frame as JaxFrame
from smartedgesensor3dhumanpose_tpu_torch import (
    cameras,
    checkpoint,
    config,
    monitor,
    online,
    pipeline,
    sync,
)
from smartedgesensor3dhumanpose_tpu_torch.io import replay, sensors, synthetic
from smartedgesensor3dhumanpose_tpu_torch.types import Frame, TrackerState
from test_torch_pipeline import _assert_state_equal, _assert_step_equal

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMS, PEOPLE, FRAMES, SEED = 6, 2, 16, 7
HALF = FRAMES // 2
# The closed loop's injected latencies (s): processing and network.
PROC, NET = 0.05, 0.03
_INT_FIELDS = ("alive", "track_id", "num_obs", "next_id", "frame_nr", "est_exists")


def _scene(pkg_synthetic, **kw):
    return pkg_synthetic.generate_scene(pkg_synthetic.SceneConfig(
        num_cameras=CAMS, num_people=PEOPLE, num_frames=FRAMES, seed=SEED, **kw
    ))


def _data64():
    """The scene's frames in float64 with exact stamps (no jitter): the
    closed loop then measures exactly the injected latency."""
    return synthetic.frames_from_scene(_scene(synthetic, stamp_jitter=0.0), np.float64)


def _configs():
    kw_f = dict(num_cameras=CAMS, max_dets_per_cam=PEOPLE, max_hypotheses=2 * PEOPLE,
                max_epipolar_error=0.045)
    kw_t = dict(max_tracks=2 * PEOPLE)
    return (
        jax_config.PipelineConfig(fusion=jax_config.FusionConfig(**kw_f),
                                  tracker=jax_config.TrackerConfig(**kw_t)),
        config.PipelineConfig(fusion=config.FusionConfig(**kw_f),
                              tracker=config.TrackerConfig(**kw_t)),
    )


def _port_pipe(dtype=torch.float64):
    return pipeline.Pipeline(cameras.hall_rig(CAMS, dtype=dtype, device="cpu"), _configs()[1],
                             device="cpu")


def _at(data: dict, t: int) -> dict:
    return {k: v[t] for k, v in data.items()}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """One compiled JAX Pipeline.step (float64): the closed loop over the
    scene, then an open-loop chain over it with a checkpoint written before
    frame HALF."""
    d = tmp_path_factory.mktemp("jax_online")
    pipe = jax_pipeline.Pipeline(jax_cameras.hall_rig(CAMS, dtype=jnp.float64), _configs()[0])
    data = _data64()
    frames = JaxFrame.from_arrays(data)
    sens = jax_sensors.VirtualSensorArray(CAMS, network_latency=NET)
    loop_state, _, loop_report = jax_sensors.run_closed_loop(
        pipe.step, pipe.init_state(dtype=jnp.float64), frames, sens, processing_latency=PROC
    )
    ckpt = str(d / "jax_ckpt.npz")
    state = pipe.init_state(dtype=jnp.float64)
    outs = []
    for t in range(FRAMES):
        if t == HALF:
            jax_checkpoint.save_tracker_state(ckpt, state)
        state, out = pipe.step(state, JaxFrame.from_arrays(_at(data, t)))
        outs.append(jax.device_get(out))
    return dict(pipe=pipe, loop=(jax.device_get(loop_state), loop_report), ckpt=ckpt,
                outs=outs, final=jax.device_get(state), dir=d)


# ----------------------------------------------------------- native runtime --

def test_runtime_source_is_the_reference_copy():
    """The port builds its own copy of the native runtime, byte for byte the
    JAX package's."""
    with open(os.path.join(_REPO, "smartedgesensor3dhumanpose_tpu", "native", "runtime.cpp"),
              "rb") as fh:
        want = fh.read()
    assert sync.SOURCE.read_bytes() == want


def test_runtime_builds_into_the_port_build_dir():
    path = sync.build()
    assert path.parent == sync.BUILD_DIR and path.name.startswith("libses3d_runtime_")
    assert sync.build() == path  # the hash names a finished build: no rebuild


def test_failed_build_raises_without_fallback(monkeypatch):
    """With no working compiler the factories raise with the compiler's
    failure; they never hand back the Python mirror unasked."""
    monkeypatch.setenv("CXX", os.path.join(os.sep, "nonexistent", "g++"))
    monkeypatch.setattr(sync, "_NATIVE", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        sync.make_synchronizer(4)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        sync.make_latest_slot(1)
    assert isinstance(sync.make_synchronizer(4, prefer_native=False), sync.PyApproximateTimeSync)
    assert isinstance(sync.make_latest_slot(1, prefer_native=False), sync.PyLatestSlot)


def test_factories_default_to_native():
    s = sync.make_synchronizer(16)
    assert isinstance(s, sync.NativeApproximateTimeSync)
    assert isinstance(sync.make_latest_slot(1), sync.NativeLatestSlot)
    # queue_size = max(3, 1 + 16/4) = 5 (reference :1219), as in JAX.
    assert sync.make_synchronizer(16, prefer_native=False).queue_size == 5


# ------------------------------------------------------------- synchronizer --

def _drain(s):
    out = []
    while (got := s.pop()) is not None:
        out.append(got)
    return out


def _message_soup(rng, n, ticks, stall=None):
    """Jittered per-camera streams with dropped messages and bursts, in
    arrival order; `stall` = (camera, first tick, last tick) silences one
    camera so the others overflow their queues."""
    events = []
    t = 0
    for tick in range(ticks):
        t += int(rng.integers(25_000_000, 40_000_000))
        for c in range(n):
            if rng.uniform() < 0.05:
                continue
            if stall is not None and c == stall[0] and stall[1] <= tick <= stall[2]:
                continue
            events.append((c, t + int(rng.integers(0, 8_000_000)), tick * 100 + c))
    events.sort(key=lambda e: e[1])
    return events


@pytest.mark.parametrize("n,queue,penalty,lb,stall", [
    (5, 3, 2.0, 20_000_000, None),
    (6, 3, 2.0, 20_000_000, (0, 40, 70)),
    (16, 5, 2.0, 20_000_000, (3, 10, 30)),
    (4, 4, 0.1, 0, (2, 5, 25)),
])
def test_synchronizers_match_jax(n, queue, penalty, lb, stall):
    """The port's native and Python synchronizers emit exactly the sets of
    the JAX package's Python synchronizer (stamps and handles), with queue
    overflow and the inter-message lower bound in play."""
    events = _message_soup(np.random.default_rng(n), n, 150, stall)
    impls = [
        jax_sync.PyApproximateTimeSync(n, queue, penalty, 0, lb),
        sync.PyApproximateTimeSync(n, queue, penalty, 0, lb),
        sync.NativeApproximateTimeSync(n, queue, penalty, 0, lb),
    ]
    sets = [[] for _ in impls]
    for c, stamp, h in events:
        assert len({s.push(c, stamp, h) for s in impls}) == 1
        for out, s in zip(sets, impls):
            out.extend(_drain(s))
    assert len(sets[0]) > 50
    assert sets[1] == sets[0] and sets[2] == sets[0]
    if stall is not None:
        # The stall made the policy drop messages: fewer sets than ticks
        # that every camera reached.
        assert len(sets[0]) < 150 - (stall[2] - stall[1])


def test_latest_slots_match_jax():
    """Native and Python latest-wins slots behave alike under one put/take
    sequence: what take returns and the drop count after every call."""
    slots = [sync.NativeLatestSlot(3), sync.PyLatestSlot(3), jax_sync.PyLatestSlot(3)]
    rng = np.random.default_rng(0)
    for step in range(300):
        if rng.uniform() < 0.6:
            stamps = rng.integers(0, 1 << 40, size=3).tolist()
            handles = rng.integers(0, 1 << 30, size=3).tolist()
            for s in slots:
                s.put(stamps, handles)
        else:
            got = [s.take() for s in slots]
            assert got[0] == got[1] == got[2], step
        assert slots[0].dropped == slots[1].dropped == slots[2].dropped, step
    assert slots[0].dropped > 0


# ------------------------------------------------------------------ replay --

def test_jsonl_bytes_and_replay_match_jax(tmp_path):
    """The port's recording of its scene is byte for byte JAX's recording of
    JAX's scene, and replaying it gives JAX's frames exactly."""
    mine, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    replay.save_jsonl(mine, _scene(synthetic, stamp_jitter=0.003))
    jax_replay.save_jsonl(theirs, _scene(jax_synthetic, stamp_jitter=0.003))
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got = list(replay.replay_jsonl(mine, CAMS, PEOPLE))
    want = list(jax_replay.replay_jsonl(theirs, CAMS, PEOPLE, prefer_native=False))
    assert len(got) == len(want) >= FRAMES - 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def test_npz_round_trip(tmp_path):
    scene = _scene(synthetic)
    path = str(tmp_path / "scene.npz")
    replay.save_npz(path, scene)
    loaded = replay.load_npz(path)
    with np.load(path) as z:
        assert set(z.files) == {"kp2d", "cov2d", "det_valid", "det_score", "cam_stamp",
                                "fb_delay", "gt_xyz"}
    for k in ("kp2d", "cov2d", "det_valid", "det_score", "cam_stamp", "fb_delay", "gt_xyz"):
        np.testing.assert_array_equal(loaded[k], scene[k])


# ------------------------------------------------------------ online loops --

@pytest.mark.parametrize("prefer_native", [True, False])
def test_online_drops_backlog_under_load(prefer_native):
    """Under a slowed consumer the latest-wins loop drops backlog and stays
    fresh (the JAX test's invariants), and its final state is the one
    stepping the processed frames again gives."""
    pipe = _port_pipe(torch.float32)
    frames = Frame.from_arrays(synthetic.frames_from_scene(_scene(synthetic)), "cpu")
    n = frames.kp2d.shape[0]
    final, out, report = online.run_online(
        pipe.step, pipe.init_state(), frames, feed_interval_s=0.005,
        consumer_hook=lambda h: time.sleep(0.025), prefer_native_slot=prefer_native,
    )
    h = report.processed_handles
    assert report.dropped > 0, report
    assert report.dropped + len(h) == report.produced == n
    assert all(a < b for a, b in zip(h, h[1:])), h
    assert h[-1] == n - 1
    assert len(report.step_ms) == len(h) and report.step_ms_p50 > 0
    assert bool(torch.isfinite(out.fused.xyz).all())
    state = pipe.init_state()
    for i in h:
        state, _ = pipe.step(state, Frame(*(a[i] for a in frames)))
    for name in TrackerState._fields:
        assert torch.equal(getattr(state, name), getattr(final, name)), name


def test_online_keeps_every_frame_when_fast():
    """A consumer faster than the feed steps every frame, none dropped."""
    frames = Frame.from_arrays(synthetic.frames_from_scene(_scene(synthetic)), "cpu")
    seen = []

    def step(state, frame):
        seen.append(float(frame.cam_stamp.max()))
        return state + 1, frame

    final, _, report = online.run_online(step, 0, frames, feed_interval_s=0.02)
    assert report.dropped == 0 and report.processed_handles == list(range(FRAMES))
    assert final == FRAMES
    np.testing.assert_array_equal(seen, frames.cam_stamp.amax(-1).numpy())


def _jsonl_messages(tmp_path, **kw):
    path = str(tmp_path / "scene.jsonl")
    replay.save_jsonl(path, _scene(synthetic, **kw))
    return path, list(replay.load_jsonl_messages(path))


def _cpu_builder(fd):
    return online.default_frame_builder(fd, "cpu")


def test_online_synced_full_live_topology(tmp_path):
    """Per-camera messages -> native sync -> latest-wins slot -> step: the
    live sync emits what the offline replay of the same recording emits."""
    path, messages = _jsonl_messages(tmp_path)
    pipe = _port_pipe(torch.float32)
    _, out, report = online.run_online_synced(
        pipe.step, pipe.init_state(), messages, num_cameras=CAMS, max_dets=PEOPLE,
        message_interval_s=0.001, frame_builder=_cpu_builder,
    )
    assert report.produced_messages == len(messages)
    assert report.frames_synced == len(list(replay.replay_jsonl(path, CAMS, PEOPLE)))
    assert report.processed_frames + report.slot_dropped == report.frames_synced
    assert report.messages_unconsumed == report.produced_messages - report.frames_synced * CAMS
    assert 0 <= report.messages_unconsumed < 4 * CAMS
    assert report.e2e_ms_p50 >= report.step_ms_p50 > 0
    assert bool(torch.isfinite(out.fused.xyz).all())


def test_online_synced_drops_under_load_and_sync_overflow(tmp_path):
    """Slot drops under a slowed consumer and sync-policy drops when one
    camera stalls (queue overflow, approximate_time_vec.h:191-214)."""
    scene = _scene(synthetic)
    _, messages = _jsonl_messages(tmp_path)
    t0, t1 = scene["cam_stamp"][4].min(), scene["cam_stamp"][12].max()
    stalled = [m for m in messages if not (m[0] == 0 and t0 <= m[1] <= t1)]
    pipe = _port_pipe(torch.float32)
    _, _, report = online.run_online_synced(
        pipe.step, pipe.init_state(), stalled, num_cameras=CAMS, max_dets=PEOPLE,
        message_interval_s=0.002, frame_builder=_cpu_builder,
        consumer_hook=lambda h: time.sleep(0.05),
    )
    assert report.slot_dropped > 0, report
    assert report.messages_unconsumed > 3 * CAMS, report
    assert report.frames_synced < FRAMES
    assert report.processed_frames + report.slot_dropped == report.frames_synced


def test_default_frame_builder_matches_jax(tmp_path):
    path, _ = _jsonl_messages(tmp_path)
    fd = next(iter(replay.replay_jsonl(path, CAMS, PEOPLE)))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        got = online.default_frame_builder(fd, "cpu", dtype)
        want = jax.device_get(jax_online.default_frame_builder(fd, dtype=jdtype))
        for name in Frame._fields:
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


# ------------------------------------------------------------- closed loop --

def test_closed_loop_matches_jax(jax_runs):
    """The port's closed loop gives JAX's prediction horizons and measured
    delays (float64, 1e-9) and its integer state; the horizon converges to
    the injected latency within the moving window, as in the JAX test."""
    jax_state, want = jax_runs["loop"]
    pipe = _port_pipe()
    frames = Frame.from_arrays(_data64(), "cpu")
    sens = sensors.VirtualSensorArray(CAMS, network_latency=NET)
    state, _, got, outs = sensors.run_closed_loop(
        pipe.step, pipe.init_state(dtype=torch.float64), frames, sens,
        processing_latency=PROC, collect_outputs=True,
    )
    np.testing.assert_allclose(got.pred_delta_t, want.pred_delta_t, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.fb_delay_measured, want.fb_delay_measured, rtol=0, atol=1e-9)
    assert got.n_feedback_received == want.n_feedback_received == FRAMES
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jax_state, name)), err_msg=name)
    np.testing.assert_allclose(got.fb_delay_measured[-1], PROC + NET, atol=1e-9)
    first = int(np.argmax(got.fb_delay_measured[:, 0] > 0))
    np.testing.assert_allclose(got.pred_delta_t[first + 3:], PROC + NET, atol=1e-9)
    assert len(outs) == FRAMES and outs[-1].fused.xyz.device.type == "cpu"
    np.testing.assert_allclose(outs[-1].fb_delay_per_cam_raw.numpy(), PROC + NET, atol=1e-9)


def test_sensor_array_delivery_ordering():
    """Feedback is only visible after its arrival time; newest wins (the
    JAX test's sequence, on both packages)."""
    for arr in (sensors.VirtualSensorArray(2, 0.01), jax_sensors.VirtualSensorArray(2, 0.01)):
        assert np.all(arr.measured_fb_delay(np.array([0.0, 0.0])) == -1.0)
        arr.receive_feedback(np.array([1.0, 0.99]), emit_time=1.05)
        assert np.all(arr.measured_fb_delay(np.array([1.055, 1.055])) == -1.0)
        np.testing.assert_allclose(arr.measured_fb_delay(np.array([1.07, 1.07])),
                                   [0.06, 0.07], atol=1e-12)
        arr.receive_feedback(np.array([1.10, 1.10]), emit_time=1.12)
        np.testing.assert_allclose(arr.measured_fb_delay(np.array([1.14, 1.12])),
                                   [0.03, 0.07], atol=1e-12)


# -------------------------------------------------------------- checkpoint --

def test_jax_checkpoint_resumes_in_the_port(jax_runs):
    """A checkpoint JAX wrote before frame HALF, loaded by the port: the
    following steps equal JAX's (float64)."""
    state = checkpoint.load_tracker_state(jax_runs["ckpt"], torch.float64, device="cpu")
    assert state.track_id.dtype == torch.int32 and state.alive.dtype == torch.bool
    pipe = _port_pipe()
    data = _data64()
    for t in range(HALF, FRAMES):
        state, out = pipe.step(state, Frame.from_arrays(_at(data, t), "cpu"))
        _assert_step_equal(out, jax_runs["outs"][t], f"resumed t{t}")
    _assert_state_equal(state, jax_runs["final"], "final")
    assert jax_runs["outs"][-1].fused.valid.sum() == PEOPLE


def test_port_checkpoint_resumes_in_jax(jax_runs):
    """A checkpoint the port wrote before frame HALF, in JAX's format,
    loaded by JAX: its following steps equal its own uninterrupted run."""
    pipe = _port_pipe()
    data = _data64()
    state = pipe.init_state(dtype=torch.float64)
    for t in range(HALF):
        state, _ = pipe.step(state, Frame.from_arrays(_at(data, t), "cpu"))
    path = str(jax_runs["dir"] / "port_ckpt.npz")
    checkpoint.save_tracker_state(path, state)
    with np.load(path) as mine, np.load(jax_runs["ckpt"]) as theirs:
        assert set(mine.files) == set(theirs.files)
        for k in theirs.files:
            assert mine[k].dtype == theirs[k].dtype and mine[k].shape == theirs[k].shape, k
    jstate = jax_checkpoint.load_tracker_state(path, dtype=jnp.float64)
    jpipe = jax_runs["pipe"]
    for t in range(HALF, FRAMES):
        jstate, out = jpipe.step(jstate, JaxFrame.from_arrays(_at(data, t)))
        want = jax_runs["outs"][t]
        for part in ("fused", "fused_pred"):
            g, w = getattr(jax.device_get(out), part), getattr(want, part)
            np.testing.assert_array_equal(g.valid, w.valid)
            np.testing.assert_array_equal(g.person_id, w.person_id)
            np.testing.assert_allclose(g.xyz, w.xyz, rtol=0, atol=1e-6)
    for name in TrackerState._fields:
        g, w = np.asarray(getattr(jstate, name)), np.asarray(getattr(jax_runs["final"], name))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_checkpoint_round_trip_and_reset(tmp_path):
    state = TrackerState.initial(6, 3, 0.1, dtype=torch.float64, device="cpu")
    state = state._replace(
        next_id=torch.tensor(7, dtype=torch.int32),
        alive=state.alive.clone().index_fill_(0, torch.tensor([2]), True),
        estimate=state.estimate.clone().index_fill_(0, torch.tensor([2]), 1.5),
    )
    path = str(tmp_path / "tracker.npz")
    checkpoint.save_tracker_state(path, state)
    loaded = checkpoint.load_tracker_state(path, dtype=torch.float64, device="cpu")
    for f in TrackerState._fields:
        assert torch.equal(getattr(loaded, f), getattr(state, f)), f
        assert getattr(loaded, f).dtype == getattr(state, f).dtype, f
    as32 = checkpoint.load_tracker_state(path, device="cpu")
    assert as32.estimate.dtype == torch.float32 and as32.num_obs.dtype == torch.int32
    fresh = checkpoint.reset(loaded)
    assert not fresh.alive.any() and int(fresh.next_id) == 0
    assert fresh.estimate.dtype == torch.float64 and fresh.alive.device.type == "cpu"
    np.savez_compressed(path, __version__=2, **{f: np.zeros(1) for f in TrackerState._fields})
    with pytest.raises(ValueError, match="version"):
        checkpoint.load_tracker_state(path, device="cpu")


def test_monitor_on_step_outputs_matches_jax(jax_runs):
    """The health monitor on the port's StepOutputs raises the events the
    JAX monitor raises on JAX's, frame for frame (new tracks published,
    stale cameras, frame delays)."""
    pipe = _port_pipe()
    data = _data64()
    state = pipe.init_state(dtype=torch.float64)
    mine, theirs = monitor.PipelineMonitor(emit_log=False), jax_monitor.PipelineMonitor(emit_log=False)
    for t in range(FRAMES):
        frame = Frame.from_arrays(_at(data, t), "cpu")
        state, out = pipe.step(state, frame)
        assert mine.check_frame(frame.cam_stamp) == theirs.check_frame(
            np.asarray(data["cam_stamp"][t], np.float32))
        mine.check_output(out)
        theirs.check_output(jax_runs["outs"][t])
    assert [(e.kind, e.data) for e in mine.events] == [(e.kind, e.data) for e in theirs.events]
    assert mine.summary().get("track_published") == PEOPLE
