"""The port's sharded pipeline (parallel/sharding.py) on meshes of repeated
CPU devices, against the JAX package's single-device Pipeline.run_offline
and fusion.fuse_frame, and against the port's own unsharded paths.

The scenes are tests/test_sharding.py's, which pins the JAX sharded
programs to those same single-device functions. JAX's sharded programs are
not called here: they are slow to compile under load, and the single-device
functions are the reference either way.

On a card each shard's stages replay CUDA graphs (one per stage, device
and mesh entry). Here the sharded replay runs with the loops of a capture
(test_torch_graphs.device_loops) against the eager one, and the graphs'
cache is checked with the card's streams and captures stood in for.
"""

import collections
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import fusion as jax_fusion
from smartedgesensor3dhumanpose_tpu import pipeline as jax_pipeline
from smartedgesensor3dhumanpose_tpu.io import synthetic as jax_synthetic
from smartedgesensor3dhumanpose_tpu.types import Frame as JaxFrame
from smartedgesensor3dhumanpose_tpu_torch import cameras, config, fusion, graphs, pipeline
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding
from smartedgesensor3dhumanpose_tpu_torch.types import Frame, TrackerState
from test_pipeline import small_config
from test_torch_graphs import _equal_trees, device_loops, eager_trips

pytestmark = pytest.mark.torch_port

CPU = torch.device("cpu")
# test_sharding._setup's scene.
REPLAY_SCENE = dict(num_cameras=8, num_people=2, num_frames=8, pixel_noise=1.0, seed=17)
# test_sharding.test_fuse_frame_sharded_equivalence_and_collectives' frame.
FRAME_SCENE = dict(num_cameras=24, num_people=5, num_frames=1, pixel_noise=1.0, seed=3)
# (data, model) meshes; 3 x 1 splits the 8 frames unevenly (3, 3, 2).
MESHES = [(8, 1), (4, 2), (3, 1)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Each sharded stage runs one thread per mesh entry; with torch's
    default of one OpenMP thread per core under xdist that oversubscribes
    the machine (as in test_torch_models.py)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _port_config(cams, people):
    kw_f = dict(num_cameras=cams, max_dets_per_cam=people, max_hypotheses=2 * people)
    return config.PipelineConfig(fusion=config.FusionConfig(**kw_f),
                                 tracker=config.TrackerConfig(max_tracks=2 * people))


def _scene(kw, dtype=np.float64):
    """The port's float64 hall rig and the frame arrays of its scene;
    `tests/test_torch_pipeline.py` pins the generator and the rig equal to
    the JAX package's (`_jax_rig`)."""
    rig = cameras.hall_rig(kw["num_cameras"], dtype=torch.float64, device="cpu")
    scene = synthetic.generate_scene(synthetic.SceneConfig(**kw), rig=rig)
    return rig, synthetic.frames_from_scene(scene, dtype)


def _jax_rig(kw):
    return jax_cameras.hall_rig(kw["num_cameras"], dtype=jnp.float64)


def _mesh(data, model):
    return sharding.make_mesh(data * model, model=model, devices=[CPU] * (data * model))


def test_make_mesh_shapes():
    """test_sharding.test_mesh_construction's shapes on a repeated device."""
    mesh = sharding.make_mesh(8, model=2, devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.home == CPU and mesh.axis("model") == [CPU, CPU]
    assert sharding.make_mesh(devices=[CPU] * 8).shape == {"data": 8, "model": 1}
    assert sharding.make_mesh(3, devices=[CPU] * 8).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match=r"data\*model \(3\*2\) != n_devices \(8\)"):
        sharding.make_mesh(8, data=3, model=2, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="exceeds"):
        sharding.make_mesh(9, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="axes"):
        mesh.axis("time")


@pytest.fixture(scope="module")
def jax_replay():
    """JAX Pipeline.run_offline on one device over REPLAY_SCENE, float64
    frames, as numpy."""
    rig = _jax_rig(REPLAY_SCENE)
    scene = jax_synthetic.generate_scene(jax_synthetic.SceneConfig(**REPLAY_SCENE), rig=rig)
    data = jax_synthetic.frames_from_scene(scene, np.float64)
    pipe = jax_pipeline.Pipeline(rig, small_config(8, 2))
    return jax.device_get(pipe.run_offline(pipe.init_state(dtype=jnp.float64),
                                           JaxFrame.from_arrays(data)))


@pytest.mark.parametrize("data,model", MESHES)
def test_run_offline_sharded_matches_jax(jax_replay, data, model):
    """The sharded replay against JAX's single-device run_offline, with
    the tolerances of test_sharding.test_sharded_matches_single_device;
    ids, drop counters and the final state's integers exactly equal."""
    want_state, want = jax_replay
    rig, arrays = _scene(REPLAY_SCENE)
    cfg = _port_config(8, 2)
    state0 = pipeline.Pipeline(rig, cfg, device="cpu").init_state(dtype=torch.float64)
    state, got = sharding.run_offline_sharded(
        rig, cfg, _mesh(data, model), Frame.from_arrays(arrays, "cpu"), state0
    )
    np.testing.assert_allclose(got.persons_raw.xyz.numpy(), want.persons_raw.xyz, atol=1e-9)
    np.testing.assert_array_equal(got.persons_raw.valid.numpy(), want.persons_raw.valid)
    np.testing.assert_array_equal(got.fused.valid.numpy(), want.fused.valid)
    np.testing.assert_allclose(got.fused.xyz.numpy(), want.fused.xyz, atol=1e-8)
    np.testing.assert_allclose(got.feedback.kp2d.numpy(), want.feedback.kp2d, atol=1e-6)
    np.testing.assert_array_equal(got.feedback.kp_valid.numpy(), want.feedback.kp_valid)
    for name in ("fused", "fused_pred"):
        np.testing.assert_array_equal(getattr(got, name).person_id.numpy(),
                                      getattr(want, name).person_id, err_msg=name)
    for name in ("n_dropped_hypotheses", "n_dropped_track_spawns"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=name)
    for name, value in zip(TrackerState._fields, state):
        if not value.dtype.is_floating_point:
            np.testing.assert_array_equal(value.numpy(), getattr(want_state, name),
                                          err_msg=name)
    assert want.persons_raw.valid.sum() >= 2 * REPLAY_SCENE["num_frames"] - 2


# Float fields of the sharded replay against the unsharded one: equal bit
# for bit where the split changes no summation (seen so far everywhere on
# the CPU), else within this.
PORT_TOL = {torch.float64: 1e-9, torch.float32: 1e-5}


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    names = getattr(tree, "_fields", range(len(tree)))
    return [leaf for name, x in zip(names, tree) for leaf in _leaves(x, f"{prefix}.{name}")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_run_offline_sharded_matches_port(dtype):
    """The sharded replay against the port's own Pipeline.run_offline on
    the same CPU inputs, on the 4 x 2 and the uneven 3 x 1 mesh, with 3
    frames per fusion chunk (shards of 2 and 3 frames end mid-chunk):
    integers and masks exactly equal,
    floats equal within PORT_TOL; the input state is left as it was."""
    rig, arrays = _scene(REPLAY_SCENE, np.float64 if dtype == torch.float64 else np.float32)
    cfg = _port_config(8, 2)
    frames = Frame.from_arrays(arrays, "cpu")
    pipe = pipeline.Pipeline(rig, cfg, device="cpu", fusion_batch=3)
    state0 = pipe.init_state(dtype=dtype)
    before = [t.clone() for t in state0]
    want_state, want = pipe.run_offline(state0, frames)
    for data, model in MESHES[1:]:
        state, got = sharding.run_offline_sharded(rig, cfg, _mesh(data, model), frames,
                                                  state0, fusion_batch=3)
        for (name, g), (_, w) in zip(_leaves((state, got)), _leaves((want_state, want))):
            msg = f"mesh {data}x{model} {name}"
            assert g.dtype == w.dtype and g.shape == w.shape, msg
            if g.dtype.is_floating_point:
                torch.testing.assert_close(g, w, rtol=0, atol=PORT_TOL[dtype], msg=msg)
            else:
                assert torch.equal(g, w), msg
    for name, a, b in zip(TrackerState._fields, before, state0):
        assert torch.equal(a, b), f"run_offline_sharded wrote its input state: {name}"
    assert want.persons_raw.valid.any()


@pytest.fixture(scope="module")
def frame_case():
    """FRAME_SCENE's frame after the stale-camera mask, and JAX's
    single-device fuse_frame of it (float64)."""
    rig, arrays = _scene(FRAME_SCENE)
    first = {k: v[0] for k, v in arrays.items()}
    cfg = small_config(24, 5)
    jframe, _ = jax_pipeline.mask_stale_cameras(JaxFrame.from_arrays(first),
                                                cfg.fusion.max_sync_diff)
    # Jitted with the camera fold as a scan: it compiles in a fraction of
    # the unrolled program's time and gives the same result here.
    rig_j = _jax_rig(FRAME_SCENE)
    want = jax.device_get(jax.jit(
        lambda fr: jax_fusion.fuse_frame(fr, rig_j, cfg.fusion, with_stats=True)
    )(jframe))
    frame, _ = pipeline.mask_stale_cameras(Frame.from_arrays(first, "cpu"),
                                           cfg.fusion.max_sync_diff)
    return rig, frame, want


@pytest.mark.parametrize("entries", [8, 3, 7])
def test_fuse_frame_sharded_matches_jax(frame_case, entries):
    """One frame's fusion split over a model axis of 8 entries (hypotheses
    2, 2, 1, ...), 3 (hypotheses 4, 3, 3) and 7 (cameras 4, 4, 4, 3, 3, 3,
    3 and hypotheses 2, 2, 2, 1, 1, 1, 1) against JAX's fuse_frame, with
    test_sharding's tolerances; the drop count exactly equal."""
    rig, frame, (want, want_drop) = frame_case
    mesh = sharding.make_mesh(entries, data=1, model=entries, devices=[CPU] * entries)
    got, got_drop = sharding.fuse_frame_sharded(frame, rig, _port_config(24, 5), mesh,
                                                with_stats=True)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    assert want.valid.sum() == FRAME_SCENE["num_people"]
    np.testing.assert_allclose(got.xyz.numpy(), want.xyz, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.cov.numpy(), want.cov, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.score.numpy() > 0, want.score > 0)
    assert int(got_drop) == int(want_drop)
    # And the port's own unsharded fusion, which it composes.
    same = fusion.fuse_frame(frame, rig, _port_config(24, 5).fusion)
    assert torch.equal(got.valid, same.valid)
    torch.testing.assert_close(got.xyz, same.xyz, rtol=0, atol=1e-9)


def test_dryrun_on_eight_cpu_entries():
    """The port's dry run at the JAX package's shapes: a tiny sharded
    replay on a 4 x 2 mesh, then the 64-camera x 25-person frame's fusion
    on a flat 8-entry mesh against the unsharded fusion."""
    report = sharding.dryrun(8, devices=[CPU] * 8)
    assert report["mesh"] == {"data": 4, "model": 2}
    assert report["fusion_mesh"] == {"data": 1, "model": 8}
    assert report["joints_compared"] > 0 and report["worst_m"] < 1e-3


# ------------------------------------------------- the captured form, CPU --

@pytest.mark.parametrize("data,model", [(1, 1), (2, 2), (4, 1)])
def test_run_offline_sharded_inside_device_loops_equals_eager(data, model):
    """The sharded replay with the loops of a capture (`device_loops`, as
    the card captures each shard's stages) equals the eager sharded replay
    bit for bit on the 1 x 1, 2 x 2 and 4 x 1 meshes, 3 frames per fusion
    chunk, and each loop (every shard's LM per chunk, then the tracker's
    merges) runs the eager loop's trips."""
    rig, arrays = _scene(REPLAY_SCENE, np.float32)
    cfg = _port_config(8, 2)
    frames = Frame.from_arrays(arrays, "cpu")
    state0 = pipeline.Pipeline(rig, cfg, device="cpu").init_state()
    mesh = _mesh(data, model)
    with eager_trips() as trips:
        eager = sharding.run_offline_sharded(rig, cfg, mesh, frames, state0, fusion_batch=3)
    with device_loops() as nodes:
        fixed = sharding.run_offline_sharded(rig, cfg, mesh, frames, state0, fusion_batch=3)
    _equal_trees(fixed, eager, f"mesh {data}x{model}")
    assert nodes.trips == trips
    # One LM per fusion chunk of each entry's part; every LM runs a trip.
    lms = len(trips) - REPLAY_SCENE["num_frames"]
    assert lms >= data * model and all(t > 0 for t in trips[:lms])
    assert bool(eager[0].alive.any()) and int(eager[1].persons_raw.valid.sum()) > 0


class _NoStream:
    """A stand-in for a CUDA stream or event of `_run`'s card branch."""

    def record_event(self):
        return self

    def wait_event(self, event):
        pass


def test_one_captured_function_per_stage_device_and_entry(monkeypatch):
    """On a card `_run` replays one CapturedFunction per (stage, device,
    entry): entries that share a card get functions (and static buffers)
    of their own, a later call reuses them and their graphs, shards of
    another length add a graph to the same function, another stage key
    (name, config, chunk) gets functions of its own, and the least
    recently used function beyond MAX_CAPTURED is dropped. The card's
    streams and the captures are stand-ins here (`_capture` patched)."""
    captures = []

    def capture(self, leaves, spec):
        captures.append(self.name)
        return (self.name, tuple(leaves[0].shape))

    stream = _NoStream()
    monkeypatch.setattr(graphs.CapturedFunction, "_capture", capture)
    monkeypatch.setattr(graphs.CapturedFunction, "__call__",
                        lambda self, *args: (self, self._graph_for(*graphs.flatten(args))))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(sharding, "_stream", lambda device, k: stream)
    monkeypatch.setattr(sharding, "_to", lambda tree, device: tree)
    monkeypatch.setattr(sharding, "_mark", lambda tree, s: None)
    monkeypatch.setattr(sharding, "_GRAPHS", collections.OrderedDict())

    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    cfg = _port_config(8, 2)
    fuse = sharding._Stage(("fuse", cfg, 3), lambda x: (x,))

    def run(stage, devices, n=4):
        jobs = [(d, (torch.zeros(n),)) for d in devices]
        return sharding._run(stage, jobs, cuda0)

    first = run(fuse, [cuda0, cuda0, cuda1, cuda0])
    fns = [fn for fn, _ in first]
    assert len({id(f) for f in fns}) == 4
    assert [f.name for f in fns] == [f"sharded fuse on {d} entry {k}" for d, k in
                                     ((cuda0, 0), (cuda0, 1), (cuda1, 0), (cuda0, 2))]
    assert list(sharding._GRAPHS) == [("fuse", cfg, 3, d, k) for d, k in
                                      ((cuda0, 0), (cuda0, 1), (cuda1, 0), (cuda0, 2))]
    assert len(captures) == 4
    again = run(fuse, [cuda0, cuda0, cuda1, cuda0])
    assert [fn for fn, _ in again] == fns and [g for _, g in again] == [g for _, g in first]
    assert len(captures) == 4
    shorter = run(fuse, [cuda0, cuda0, cuda1, cuda0], n=3)
    assert [fn for fn, _ in shorter] == fns and len(captures) == 8
    assert all(len(f.graphs) == 2 for f in fns)
    # Another chunk size, and another stage on home.
    other = run(sharding._Stage(("fuse", cfg, 4), lambda x: (x,)), [cuda0])
    assert other[0][0] not in fns
    fn, _ = sharding._on_home(sharding._Stage(("track", cfg), lambda x: (x,)), cuda0,
                              torch.zeros(2))
    assert fn.name == f"sharded track on {cuda0} entry 0" and len(sharding._GRAPHS) == 6
    # The bound: the least recently used function goes first.
    monkeypatch.setattr(sharding, "MAX_CAPTURED", 5)
    run(fuse, [cuda1])
    assert ("fuse", cfg, 3, cuda0, 0) not in sharding._GRAPHS
    assert len(sharding._GRAPHS) == 5 and next(reversed(sharding._GRAPHS)) == ("fuse", cfg, 3,
                                                                                cuda1, 0)
