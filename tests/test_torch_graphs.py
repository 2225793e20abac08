"""The port's compiled execution (graphs.py) on the CPU: the loops a CUDA
graph holds against the early-exit loops, and the entry points with those
loops against the eager ones, bit for bit.

On the card `Pipeline.step`, `run_per_frame_chain`, `run_offline` and the
end-to-end step replay CUDA graphs, and while a graph is captured the LM
and the track merge run their fixed trip counts (`linalg.capturing`). The
CPU has no graphs, so these tests select those loops by patching
`linalg.capturing` (`fixed_trips`) and run the same bodies eagerly. The
capture and replay themselves are checked on the card by `chip_smoke.py`
(phase 13). The JAX package runs on the CPU in float64.
"""

from __future__ import annotations

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import config as jax_config
from smartedgesensor3dhumanpose_tpu import pipeline as jax_pipeline
from smartedgesensor3dhumanpose_tpu import prior as jax_prior
from smartedgesensor3dhumanpose_tpu.types import Frame as JaxFrame
from smartedgesensor3dhumanpose_tpu.types import Persons3D as JaxPersons3D
from smartedgesensor3dhumanpose_tpu_torch import (
    cameras,
    config,
    fusion,
    graphs,
    pipeline,
    prior,
    tracking,
)
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import linalg, tracker
from smartedgesensor3dhumanpose_tpu_torch.types import Frame, Persons3D, TrackerState

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_golden_demo16.npz")
# Frames of each golden scene whose fused persons the LM tests take: the
# benign scene's first 16 converge within a few iterations; among the
# adversarial scene's last 16 are ghost persons whose float32 cold-start LM
# never converges in 32 iterations (ROADMAP C2).
LM_FRAMES = {"benign": (0, 16), "adversarial": (48, 64)}
# float64 on both sides (tests/test_torch_pipeline.py's tolerance).
F64_TOL_M = 1e-6


@contextlib.contextmanager
def fixed_trips():
    """The loops of a capture on the CPU: `linalg.capturing` answers yes, so
    the LM runs its fixed trips and the merge its T rounds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linalg, "capturing", lambda t: True)
        yield


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs (as in
    test_torch_models.py): under pytest-xdist torch's default of a thread
    per core oversubscribes the machine, and these thousands of small ops
    then slowed tenfold and more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _equal_trees(got, want, what: str) -> None:
    """Every tensor of two trees equal, bit for bit (NaN where NaN)."""
    got_l, got_spec = graphs.flatten(got)
    want_l, want_spec = graphs.flatten(want)
    assert got_spec == want_spec, what
    for i, (a, b) in enumerate(zip(got_l, want_l)):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} leaf {i}"
        assert torch.equal(a, b) or (
            a.dtype.is_floating_point and torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
        ), f"{what} leaf {i}"


def _golden_data(scene: str):
    golden = np.load(GOLDEN)
    cfg = config.PipelineConfig.demo_16cam()
    kw = json.loads(str(golden[f"{scene}/scene"]))
    data = synthetic.pad_detections(
        synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw)),
                                    np.float32),
        cfg.fusion.max_dets_per_cam,
    )
    assert synthetic.frames_digest(data) == str(golden[f"{scene}/input_sha256"])
    return cfg, data


@pytest.fixture(scope="module")
def golden_persons():
    """Each golden scene's fused persons over LM_FRAMES (float32, plain
    fold), flattened to one person batch."""
    rig = cameras.hall_rig(16, device="cpu")
    out = {}
    for scene, (lo, hi) in LM_FRAMES.items():
        cfg, data = _golden_data(scene)
        frames, _ = pipeline.mask_stale_cameras(
            Frame.from_arrays({k: v[lo:hi] for k, v in data.items()}, "cpu"),
            cfg.fusion.max_sync_diff,
        )
        persons, _ = fusion.fuse_frames(frames, rig, cfg.fusion)
        out[scene] = Persons3D(*(x.flatten(0, 1) for x in persons))
    return out


# -------------------------------------------------------------- the loops --

@pytest.mark.parametrize("scene", sorted(LM_FRAMES))
def test_fixed_trip_lm_equals_early_exit(golden_persons, scene, monkeypatch):
    cfg = config.PipelineConfig.demo_16cam().prior
    trips = []
    lm_trip = prior._lm_trip
    monkeypatch.setattr(prior, "_lm_trip", lambda *a: trips.append(1) or lm_trip(*a))
    g_in = prior.build_graph_inputs(golden_persons[scene], cfg)
    # Cold start (the offline replay's) and a warm start off the
    # measurements (the online step's shape of input).
    warm = g_in.meas + 0.02 * torch.sin(torch.arange(g_in.meas.numel())).reshape(
        g_in.meas.shape) * g_in.active[..., None]
    for start in (g_in.meas, warm):
        eager = prior.optimize(g_in, start, cfg)
        trips.clear()
        with fixed_trips():
            fixed = prior.optimize(g_in, start, cfg)
        assert len(trips) == cfg.lm_max_iterations
        _equal_trees(fixed, eager, f"{scene} LM")
        assert fixed.iters.dtype == torch.int32 and fixed.iters.dim() == 0
    cold = prior.optimize(g_in, g_in.meas, cfg)
    if scene == "adversarial":
        # A person that never converges: the early exit runs every trip.
        assert int(cold.iters) == cfg.lm_max_iterations
    else:
        assert 0 < int(cold.iters) < cfg.lm_max_iterations


@pytest.mark.parametrize("scene", sorted(LM_FRAMES))
def test_lm_iters_match_jax(golden_persons, scene):
    """`iters` of both loops equals JAX's `int(result.iters)` (float64 on
    both sides), and so do the results."""
    tcfg = config.PipelineConfig.demo_16cam().prior
    jcfg = jax_config.PipelineConfig.demo_16cam().prior
    p64 = Persons3D(*(x.double() if x.is_floating_point() else x
                      for x in golden_persons[scene]))
    jp = JaxPersons3D(*(jnp.asarray(x.numpy()) for x in p64))
    jg = jax.jit(jax_prior.build_graph_inputs, static_argnums=1)(jp, jcfg)
    jr = jax.jit(jax_prior.optimize, static_argnums=2)(jg, jg.meas, jcfg)
    g_in = prior.build_graph_inputs(p64, tcfg)
    with fixed_trips():
        fixed = prior.optimize(g_in, g_in.meas, tcfg)
    eager = prior.optimize(g_in, g_in.meas, tcfg)
    assert int(fixed.iters) == int(eager.iters) == int(jr.iters)
    np.testing.assert_array_equal(fixed.marg_ok.numpy(), np.asarray(jr.marg_ok))
    if int(jr.iters) < tcfg.lm_max_iterations:
        # Converged persons only: a person still running after 32 trips is
        # ill-posed and order-sensitive (ROADMAP C2).
        np.testing.assert_allclose(fixed.x.numpy(), np.asarray(jr.x), rtol=0, atol=F64_TOL_M)


def _merge_case(positions, alive, has_dets=True):
    """_merge_tracks' arguments for tracks at `positions` [T] along x (every
    joint of a track at the same point) with one published person per
    track carrying its id."""
    t = len(positions)
    k = 21
    est = torch.zeros((t, k, 3), dtype=torch.float64)
    est[..., 0] = torch.as_tensor(positions, dtype=torch.float64)[:, None]
    track_id = torch.arange(10, 10 + t, dtype=torch.int32)
    person = Persons3D(
        xyz=torch.zeros((t, k, 3), dtype=torch.float64),
        score=torch.ones((t, k), dtype=torch.float64),
        cov=torch.zeros((t, k, 3, 3), dtype=torch.float64),
        valid=torch.ones(t, dtype=torch.bool),
        person_id=track_id.clone(),
    )
    return (torch.as_tensor(alive), track_id, est, torch.ones((t, k), dtype=torch.bool),
            torch.ones(t, dtype=torch.float64), torch.zeros((t, 3), dtype=torch.float64),
            person, person, torch.tensor(has_dets))


def _merge_cases():
    """(name, positions, alive, survivors, published ids after the merge);
    track i has id 10 + i."""
    thr = config.TrackerConfig().merge_dist_thresh
    # A chain: each track is close to its neighbours only, so killing one
    # frees the next: 0 keeps, 1 dies, 2 keeps, ... (three rounds settle
    # six slots; the device loop runs all six).
    chain = [i * 0.7 * thr for i in range(6)]
    yield ("chain", chain, [True] * 6, [True, False, True, False, True, False],
           [10, 10, 12, 12, 14, 14])
    # The same chain with a gap in the living tracks: 2 is dead, so 3
    # survives beside it and kills 4.
    yield ("chain_gap", chain, [True, True, False, True, True, True],
           [True, False, False, True, False, True], [10, 10, 12, 13, 13, 15])
    # Everything within the threshold of track 0: only 0 survives.
    yield ("cluster", [0.0, 0.1 * thr, 0.2 * thr, 0.3 * thr], [True] * 4,
           [True, False, False, False], [10, 10, 10, 10])
    rng = np.random.default_rng(3)
    for i in range(4):
        t = 24
        yield (f"random{i}", list(rng.uniform(0.0, 8 * thr, t)),
               list(rng.uniform(size=t) < 0.8), None, None)


@pytest.mark.parametrize("name,positions,alive,survivors,ids",
                         list(_merge_cases()), ids=[c[0] for c in _merge_cases()])
def test_merge_rounds_equal_fixpoint(name, positions, alive, survivors, ids):
    cfg = config.TrackerConfig()
    args = _merge_case(positions, alive)
    eager = tracking._merge_tracks(*args, cfg)
    with fixed_trips():
        fixed = tracking._merge_tracks(*args, cfg)
    _equal_trees(fixed, eager, name)
    if survivors is not None:
        assert eager[0].tolist() == survivors
        # A merged-away track's person takes its keeper's id.
        assert eager[1].person_id.tolist() == ids
    # Frames without detections merge nothing.
    quiet = _merge_case(positions, alive, has_dets=False)
    with fixed_trips():
        assert torch.equal(tracking._merge_tracks(*quiet, cfg)[0], torch.as_tensor(alive))


def test_capturing_is_false_on_the_cpu():
    """A CPU tensor never selects the fixed trips (and asks CUDA nothing,
    which a CPU build of torch could not answer)."""
    assert linalg.capturing(torch.zeros(3)) is False


# ---------------------------------------------------- the entry points --

@pytest.mark.parametrize("scene", ["benign", "adversarial"])
def test_step_inside_device_loops_equals_eager(scene):
    """pipeline.step over the first 16 golden frames with the loops of a
    capture (`fixed_trips`): the body the card captures equals the eager
    step (held to JAX by test_torch_pipeline)."""
    cfg, data = _golden_data(scene)
    pipe = pipeline.Pipeline(cameras.hall_rig(16, device="cpu"), cfg, device="cpu")
    eager_state = fixed_state = pipe.init_state()
    for f in range(16):
        frame = Frame.from_arrays({k: v[f] for k, v in data.items()}, "cpu")
        eager_state, eager = pipe.step(eager_state, frame)
        with fixed_trips():
            fixed_state, fixed = pipeline.step(fixed_state, frame, pipe.rig, cfg)
        _equal_trees((fixed_state, fixed), (eager_state, eager), f"{scene} frame {f}")


def test_run_offline_inside_device_loops_equals_eager():
    """run_offline with the loops of a capture over the adversarial golden
    scene (64 frames, two fusion chunks, LM persons that never converge,
    track merges)."""
    cfg, data = _golden_data("adversarial")
    pipe = pipeline.Pipeline(cameras.hall_rig(16, device="cpu"), cfg, device="cpu",
                             fusion_batch=32)
    frames = Frame.from_arrays(data, "cpu")
    state0 = pipe.init_state()
    eager = pipe.run_offline(state0, frames)
    with fixed_trips():
        fixed = pipe.run_offline(state0, frames)
    _equal_trees(fixed, eager, "run_offline")
    assert int(eager[1].fused.valid.sum()) > 0


CHAIN_CAMS, CHAIN_PEOPLE, CHAIN_FRAMES = 8, 3, 4


def test_chain_stacks_like_jax():
    """run_per_frame_chain returns one StepOutput with a leading time axis,
    equal to per-frame steps, with the fields, shapes and decisions of the
    JAX package's chain (lax.scan of step) on the same frames."""
    kw_f = dict(num_cameras=CHAIN_CAMS, max_dets_per_cam=CHAIN_PEOPLE,
                max_hypotheses=2 * CHAIN_PEOPLE)
    kw_t = dict(max_tracks=2 * CHAIN_PEOPLE)
    jcfg = jax_config.PipelineConfig(fusion=jax_config.FusionConfig(**kw_f),
                                     tracker=jax_config.TrackerConfig(**kw_t))
    tcfg = config.PipelineConfig(fusion=config.FusionConfig(**kw_f),
                                 tracker=config.TrackerConfig(**kw_t))
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=CHAIN_CAMS, num_people=CHAIN_PEOPLE, num_frames=CHAIN_FRAMES, seed=5))
    data = synthetic.frames_from_scene(scene, np.float64)

    pipe = pipeline.Pipeline(cameras.hall_rig(CHAIN_CAMS, dtype=torch.float64, device="cpu"),
                             tcfg, device="cpu")
    end, chain = pipe.run_per_frame_chain(pipe.init_state(torch.float64),
                                          Frame.from_arrays(data, "cpu"))
    state, steps = pipe.init_state(torch.float64), []
    for f in range(CHAIN_FRAMES):
        state, out = pipe.step(state, Frame.from_arrays({k: v[f] for k, v in data.items()}, "cpu"))
        steps.append(out)
    _equal_trees((end, chain), (state, tracker.stack_frames(steps)), "chain")
    with pytest.raises(ValueError, match="at least one frame"):
        pipe.run_per_frame_chain(pipe.init_state(), Frame(*(x[:0] for x in Frame.from_arrays(data, "cpu"))))

    jpipe = jax_pipeline.Pipeline(jax_cameras.hall_rig(CHAIN_CAMS, dtype=jnp.float64), jcfg)
    jend, jchain = jax.device_get(jpipe.run_per_frame_chain(
        jpipe.init_state(dtype=jnp.float64), JaxFrame.from_arrays(data)))
    got_l, got_spec = graphs.flatten(chain)
    want_l = jax.tree_util.tree_leaves(jchain)
    assert [type(x).__name__ for x in (chain, chain.fused, chain.feedback)] == \
        [type(x).__name__ for x in (jchain, jchain.fused, jchain.feedback)]
    assert chain._fields == jchain._fields
    assert [tuple(t.shape) for t in got_l] == [np.shape(w) for w in want_l]
    for t, w in zip(got_l, want_l):
        w = np.asarray(w)
        if t.dtype.is_floating_point:
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=F64_TOL_M)
        else:
            np.testing.assert_array_equal(t.numpy(), w)
    for name, a in zip(TrackerState._fields, end):
        w = np.asarray(getattr(jend, name))
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=F64_TOL_M, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), w, err_msg=name)


# ----------------------------------------------------- graphs.py's pieces --

def test_flatten_round_trip_and_copy_all():
    state = TrackerState.initial(3, device="cpu")
    frame = Frame.from_arrays(synthetic.frames_from_scene(synthetic.generate_scene(
        synthetic.SceneConfig(num_cameras=4, num_people=2, num_frames=1, seed=1))), "cpu")
    tree = (state, Frame(*(x[0] for x in frame)))
    leaves, spec = graphs.flatten(tree)
    assert len(leaves) == len(TrackerState._fields) + len(Frame._fields)
    back = graphs.unflatten(spec, leaves)
    assert type(back[0]) is TrackerState and type(back[1]) is Frame
    _equal_trees(back, tree, "round trip")
    dsts = [torch.empty_like(t) for t in leaves]
    graphs.copy_all(dsts, leaves)
    _equal_trees(graphs.unflatten(spec, dsts), tree, "copy_all")
    with pytest.raises(TypeError, match="tensors"):
        graphs.flatten((state, 3))


def test_capture_takes_cuda_tensors_only():
    captured = graphs.CapturedFunction(lambda x: (x + 1,), "add_one")
    with pytest.raises(ValueError, match="one CUDA device"):
        captured(torch.zeros(3))
    assert captured.graphs == {}


def test_capture_failure_names_the_line():
    """A failed capture raises naming the innermost line of the port that
    broke it (here: a raise inside ops/linalg.py)."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError) as info:
            linalg.require_ieee_fp32()
    finally:
        torch.set_float32_matmul_precision(saved)
    where = graphs._where(info.value)
    assert where.startswith("ops/linalg.py:") and "(require_ieee_fp32)" in where


def test_graph_cache_keeps_the_most_recent(monkeypatch):
    """A CapturedFunction keeps the graphs of its `max_graphs` most recently
    used signatures and drops the least recently used beyond that."""
    captured = graphs.CapturedFunction(lambda x: (x,), "identity")
    captured.max_graphs = 2
    monkeypatch.setattr(captured, "_capture", lambda leaves, spec: tuple(leaves[0].shape))

    def use(n):
        leaves, spec = graphs.flatten((torch.zeros(n),))
        return captured._graph_for(leaves, spec)

    assert [use(n) for n in (1, 2, 1, 3)] == [(1,), (2,), (1,), (3,)]
    assert [g for g in captured.graphs.values()] == [(1,), (3,)]   # 2 was least recent
    use(1)
    assert [g for g in captured.graphs.values()] == [(3,), (1,)]
    assert graphs.CapturedFunction.max_graphs == 4
