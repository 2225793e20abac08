"""The port's compiled execution (graphs.py) on the CPU: the loops a CUDA
graph holds against the eager loops, and the entry points with those
loops against the eager ones, bit for bit.

On the card `Pipeline.step`, `run_per_frame_chain`, `run_offline` and the
end-to-end step replay CUDA graphs, and while a graph is captured the LM
and the track merge are each one CUDA-graph WHILE node whose body the
device runs while the loop's test holds (ops/loops.py). The CPU has no
graphs, so these tests emulate that form (`device_loops`): they patch
`linalg.capturing` and hand `loops.while_loop` a stand-in for the WHILE
node. As in a capture, the body runs once to be recorded; the stand-in
then undoes that run, as a capture runs nothing, and replays the recorded
operations while the test holds, as the device does. The capture and
replay themselves are checked on the card by `chip_smoke.py` (phase 13);
here, with torch.cuda's streams, pools and graphs stood in for and
tensors faked on CUDA devices, which stream a graph captures on and the
loop bodies each graph gets. The JAX package runs on the CPU in float64.
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
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

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
    profiling,
    tracking,
)
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import linalg, lm_prior, loops, tracker
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


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _RecordedBody(TorchDispatchMode):
    """Records the operations of a loop body while the capture runs it
    once, so that `replay` can run them again on the same tensors, as the
    device runs a graph's body. `undo` takes back what the recording run
    did, as a capture runs nothing: every tensor that existed before the
    body and that the body wrote gets its old value back, and every tensor
    the body allocated is poisoned (NaN, flipped bools, a sentinel
    integer), as memory that no kernel wrote yet holds anything."""

    def __init__(self):
        super().__init__()
        self.calls = []    # (op, args, kwargs, outputs)
        self.fresh = {}    # storage -> a tensor the body allocated on it
        self.saved = []    # (tensor, its value before the body wrote it)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in pytree.tree_leaves(value):
                if isinstance(t, torch.Tensor) and _storage(t) not in self.fresh:
                    self.saved.append((t, t.clone()))
        out = func(*args, **kwargs)
        seen = {_storage(t) for t in pytree.tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and _storage(t) not in seen:
                self.fresh.setdefault(_storage(t), t)
        self.calls.append((func, args, kwargs, out))
        return out

    def undo(self) -> None:
        for t, old in reversed(self.saved):
            t.copy_(old)
        for t in self.fresh.values():
            storage = t.untyped_storage()
            whole = t.new_empty(0).set_(storage, 0, (storage.nbytes() // t.element_size(),))
            if whole.dtype.is_floating_point:
                whole.fill_(float("nan"))
            elif whole.dtype == torch.bool:
                whole.logical_not_()
            else:
                whole.fill_(-7)

    def replay(self) -> None:
        for func, args, kwargs, out in self.calls:
            again = func(*args, **kwargs)
            for old, new in zip(pytree.tree_leaves(out), pytree.tree_leaves(again)):
                if isinstance(old, torch.Tensor) and new is not old:
                    old.copy_(new)


class _HostTrip:
    def __init__(self):
        self.pred = None

    def repeat_while(self, pred: torch.Tensor) -> None:
        assert pred.dtype == torch.bool and pred.dim() == 0
        self.pred = pred


class HostWhileNodes:
    """A stand-in on the CPU for the WHILE nodes a capture records
    (`loops._while_node`): the device's tests run on the host. `trips`
    lists, per node, the trips the device ran."""

    def __init__(self):
        self.trips = []

    @contextlib.contextmanager
    def while_node(self, pred: torch.Tensor, max_trips: int):
        assert pred.dtype == torch.bool and pred.dim() == 0
        go = bool(pred) and max_trips > 0
        trip, body = _HostTrip(), _RecordedBody()
        with body:
            yield trip
        body.undo()
        assert trip.pred is not None, "the body must end with repeat_while"
        ran = 0
        while go:
            body.replay()
            ran += 1
            go = bool(trip.pred) and ran < max_trips
        self.trips.append(ran)


@contextlib.contextmanager
def eager_trips():
    """Counts the trips of every eager `loops.while_loop` (a list with one
    entry per loop run, yielded)."""
    counts = []
    while_loop = loops.while_loop

    def counted(cond, body, carry, max_trips):
        counts.append(0)

        def trip(c):
            counts[-1] += 1
            return body(c)

        return while_loop(cond, trip, carry, max_trips)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loops, "while_loop", counted)
        yield counts


@contextlib.contextmanager
def device_loops():
    """The loops of a capture on the CPU: `linalg.capturing` answers yes and
    `loops.while_loop` records its WHILE nodes into a HostWhileNodes
    (yielded)."""
    nodes = HostWhileNodes()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linalg, "capturing", lambda t: True)
        mp.setattr(loops, "_while_node", nodes.while_node)
        yield nodes


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
    """The LM in a WHILE node equals the eager early exit bit for bit: the
    capture records one trip, and the device runs the trips that the eager
    loop runs."""
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
        with device_loops() as graph:
            fixed = prior.optimize(g_in, start, cfg)
        assert len(trips) == 1 and graph.trips == [int(eager.iters)]
        _equal_trees(fixed, eager, f"{scene} LM")
        assert fixed.iters.dtype == torch.int32 and fixed.iters.dim() == 0
    cold = prior.optimize(g_in, g_in.meas, cfg)
    if scene == "adversarial":
        # A person that never converges: the early exit runs every trip.
        assert int(cold.iters) == cfg.lm_max_iterations
    else:
        assert 0 < int(cold.iters) < cfg.lm_max_iterations


@pytest.mark.parametrize("scene", sorted(LM_FRAMES))
def test_l1_route_lm_in_a_while_node_equals_eager(golden_persons, scene):
    """The LM as the card's tree route runs it (`optimize(..., _fused=True)`:
    the whole loop one `lm_solve`, here its twin, then L2's) captures no
    WHILE node and equals its eager run bit for bit; L1 capped at one trip
    as the body of a WHILE node (the route before the loop became one
    launch) ends at the same carry, with the eager trips."""
    cfg = config.PipelineConfig.demo_16cam().prior
    g_in = prior.build_graph_inputs(golden_persons[scene], cfg)
    eager = prior.optimize(g_in, g_in.meas, cfg, _fused=True)
    with device_loops() as graph:
        node = prior.optimize(g_in, g_in.meas, cfg, _fused=True)
    assert graph.trips == []
    _equal_trees(node, eager, f"{scene} L1 route")
    carry, bones = prior._lm_start(g_in, g_in.meas, cfg)
    ins = prior._fused_inputs(g_in, bones)
    start = prior._fused_carry(carry)
    with device_loops() as graph:
        looped = loops.while_loop(lambda c: c[5], lambda c: lm_prior.lm_trip(c, *ins, cfg),
                                  start, cfg.lm_max_iterations)
    assert graph.trips == [int(eager.iters)]
    _equal_trees(looped, lm_prior.lm_solve(start, *ins, cfg), f"{scene} trips in a WHILE node")


def test_while_loop_body_that_updates_its_carry_in_place():
    """A body that writes its carry in place and returns it, as L1 does,
    runs in a WHILE node as it runs eagerly."""
    def body(c):
        c[0].mul_(2.0)
        c[1].add_(1)
        return c

    def start():
        return torch.ones(3), torch.zeros((), dtype=torch.int32)

    eager = loops.while_loop(lambda c: c[1] < 5, body, start(), 8)
    with device_loops() as graph:
        node = loops.while_loop(lambda c: c[1] < 5, body, start(), 8)
    assert graph.trips == [5]
    _equal_trees(node, eager, "in-place body")
    assert int(node[1]) == 5 and torch.equal(node[0], torch.full((3,), 32.0))


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
    with device_loops():
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
    # six slots; the device skips the other three).
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
    with eager_trips() as rounds:
        eager = tracking._merge_tracks(*args, cfg)
    with device_loops() as graph:
        fixed = tracking._merge_tracks(*args, cfg)
    _equal_trees(fixed, eager, name)
    # One WHILE node; the device runs the eager loop's rounds.
    assert graph.trips == rounds and rounds[0] <= len(positions)
    if survivors is not None:
        assert eager[0].tolist() == survivors
        # A merged-away track's person takes its keeper's id.
        assert eager[1].person_id.tolist() == ids
    if name == "chain":
        assert rounds == [3]
    # Frames without detections merge nothing, in one round.
    quiet = _merge_case(positions, alive, has_dets=False)
    with device_loops() as graph:
        assert torch.equal(tracking._merge_tracks(*quiet, cfg)[0], torch.as_tensor(alive))
    assert graph.trips == [1]


def test_capturing_is_false_on_the_cpu():
    """A CPU tensor never selects the WHILE nodes (and asks CUDA nothing,
    which a CPU build of torch could not answer)."""
    assert linalg.capturing(torch.zeros(3)) is False


def _count(c):
    return c[0] + 1, c[1] * 2.0


@pytest.mark.parametrize("start,max_trips,want", [
    (0, 8, (5, 32.0)),      # stops on its test
    (3, 1, (4, 2.0)),       # stops at max_trips
    (9, 8, (9, 1.0)),       # runs no trip
])
def test_while_loop_device_form_equals_eager(start, max_trips, want):
    """while_loop in a WHILE node equals the eager loop, and the device runs
    its trips; the caller's carry is never written."""
    carry = (torch.tensor(start), torch.tensor(1.0))
    eager = loops.while_loop(lambda c: c[0] < 5, _count, carry, max_trips)
    with device_loops() as graph:
        got = loops.while_loop(lambda c: c[0] < 5, _count, carry, max_trips)
    assert (int(eager[0]), float(eager[1])) == want
    _equal_trees(got, eager, "while_loop")
    assert graph.trips == [int(eager[0]) - start]
    assert (int(carry[0]), float(carry[1])) == (start, 1.0)


@pytest.mark.parametrize("start", [0, 9])
def test_a_body_that_rebinds_the_carry_is_caught(start):
    """A loop whose body rebinds the carry to the tensors it allocated,
    instead of writing the carry in place, is wrong on the device: every
    trip starts again from the first carry, and where no trip runs the
    result is memory that no kernel wrote. The emulation shows both, so
    the tests above would catch while_loop doing it."""
    carry = (torch.tensor(start), torch.tensor(1.0))
    eager = loops.while_loop(lambda c: c[0] < 5, _count, carry, 8)
    with device_loops() as graph:
        c = carry
        with loops._while_node(c[0] < 5, 8) as trip:
            c = _count(c)
            trip.repeat_while(c[0] < 5)
    if start == 0:
        assert graph.trips == [8] and (int(c[0]), float(c[1])) == (1, 2.0)
    else:
        assert graph.trips == [0] and int(c[0]) == -7 and c[1].isnan()
    assert not torch.equal(c[0], eager[0])


# ---------------------------------------------------- the entry points --

@pytest.mark.parametrize("scene", ["benign", "adversarial"])
def test_step_inside_device_loops_equals_eager(scene):
    """pipeline.step over the first 16 golden frames with the loops of a
    capture (`device_loops`): the body the card captures equals the eager
    step (held to JAX by test_torch_pipeline), and the device runs the
    eager loops' trips (LM and merge) of every frame."""
    cfg, data = _golden_data(scene)
    pipe = pipeline.Pipeline(cameras.hall_rig(16, device="cpu"), cfg, device="cpu")
    eager_state = fixed_state = pipe.init_state()
    for f in range(16):
        frame = Frame.from_arrays({k: v[f] for k, v in data.items()}, "cpu")
        with eager_trips() as trips:
            eager_state, eager = pipe.step(eager_state, frame)
        with device_loops() as graph:
            fixed_state, fixed = pipeline.step(fixed_state, frame, pipe.rig, cfg)
        assert graph.trips == trips and len(trips) == 2
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
    with eager_trips() as trips:
        eager = pipe.run_offline(state0, frames)
    with device_loops() as graph:
        fixed = pipe.run_offline(state0, frames)
    _equal_trees(fixed, eager, "run_offline")
    # Two cold-start LMs, one per fusion chunk, then the merge of every
    # frame: on the CPU the tracker scan is K3's plain version, a loop of
    # tracking.step.
    assert graph.trips == trips
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


def test_profile_stages_on_the_cpu_stays_eager(monkeypatch):
    """profile_stages on the CPU returns its five stages in ms per frame,
    each run eagerly: it builds no CapturedFunction there (on CUDA it
    captures one per stage)."""
    def refuse(*args):
        raise AssertionError("profile_stages built a CapturedFunction on the CPU")

    monkeypatch.setattr(graphs, "CapturedFunction", refuse)
    kw_f = dict(num_cameras=CHAIN_CAMS, max_dets_per_cam=CHAIN_PEOPLE,
                max_hypotheses=2 * CHAIN_PEOPLE)
    cfg = config.PipelineConfig(fusion=config.FusionConfig(**kw_f),
                                tracker=config.TrackerConfig(max_tracks=2 * CHAIN_PEOPLE))
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=CHAIN_CAMS, num_people=CHAIN_PEOPLE, num_frames=CHAIN_FRAMES, seed=5))
    frames = Frame.from_arrays(synthetic.frames_from_scene(scene), "cpu")
    pipe = pipeline.Pipeline(cameras.hall_rig(CHAIN_CAMS, device="cpu"), cfg, device="cpu",
                             fusion_batch=2)
    stages = profiling.profile_stages(pipe, frames, reps=1)
    assert set(stages) == {"fuse", "smooth_cold", "tracker", "reproj", "full"}
    assert all(v > 0.0 for v in stages.values())


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


class _FakeStream:
    """A stand-in for torch.cuda.Stream: torch hands its streams out round
    robin from a fixed set per device, here of `POOL` streams."""

    POOL = 3
    made: dict = {}

    def __init__(self, device=None, priority=0):
        self.device = torch.device(device)
        n = _FakeStream.made[self.device] = _FakeStream.made.get(self.device, -1) + 1
        self.cuda_stream = (self.device.index, n % self.POOL)

    def wait_stream(self, other):
        pass


class _FakePool:
    made = 0

    def __init__(self):
        _FakePool.made += 1
        self.id = (0, _FakePool.made)


@pytest.fixture
def fake_cuda(monkeypatch):
    """graphs.py's capture on the CPU, with torch.cuda's streams, pools and
    graphs replaced by stand-ins and tensors faked on CUDA devices
    (FakeTensorMode): yields the list of (graph, stream) each
    `torch.cuda.graph` was entered with."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    entered = []

    @contextlib.contextmanager
    def cuda_graph(graph, pool=None, stream=None):
        entered.append((graph, stream))
        yield

    _FakeStream.made = {}
    current = {}
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "MemPool", _FakePool)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda keep_graph=False: object())
    monkeypatch.setattr(torch.cuda, "graph", cuda_graph)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: current.setdefault(device, _FakeStream(device)))
    monkeypatch.setattr(graphs, "_CAPTURE_STREAMS", {})
    monkeypatch.setattr(loops._kernels, "library", lambda: None)
    with FakeTensorMode():
        yield entered


def _fake_inputs(device: str):
    leaves, spec = graphs.flatten((torch.empty(3, device=device),))
    return leaves, spec


def test_capture_runs_on_a_stream_of_the_inputs_device(fake_cuda):
    """A graph captures on a stream of its inputs' device, one kept per
    device, whichever device the process captured on first (torch's own
    default capture stream belongs to the first one)."""
    captured = graphs.CapturedFunction(lambda x: (x + 1,), "add_one")
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    g0 = captured._capture(*_fake_inputs("cuda:0"))
    g1 = captured._capture(*_fake_inputs("cuda:1"))
    g1b = captured._capture(*_fake_inputs("cuda:1"))
    (_, s0), (_, s1), (_, s1b) = fake_cuda
    assert s0.device == cuda0 and s1.device == cuda1
    assert s1b is s1 and s0 is not s1
    assert [g.graph for g in (g0, g1, g1b)] == [graph for graph, _ in fake_cuda]
    assert g1.outputs[0].device == cuda1


def test_each_graph_has_its_own_loop_bodies(fake_cuda, monkeypatch):
    """Two graphs of one device get two body streams and two memory pools
    (graphs whose replays overlap never share a loop body's memory); a
    body never captures on the graph's own capture stream, though torch's
    streams repeat; the loops captured inside a graph take its bodies, and
    the eager warm-up none."""
    seen = []

    def fn(x):
        seen.append(loops._current)
        return (x * 2,)

    captured = graphs.CapturedFunction(fn, "double")
    made = [captured._capture(*_fake_inputs("cuda:0")) for _ in range(4)]
    capture_stream = graphs._CAPTURE_STREAMS[0]
    bodies = [g.bodies for g in made]
    assert len({id(b.pool) for b in bodies}) == len({b.pool.id for b in bodies}) == 4
    assert len({id(b.stream) for b in bodies}) == 4
    assert all(b.stream.cuda_stream != capture_stream.cuda_stream for b in bodies)
    assert all(b.device == torch.device("cuda", 0) for b in bodies)
    # Warm-up, then capture, per graph.
    assert seen == [x for b in bodies for x in (None, b)]
    assert loops._current is None

    # A body's allocations go to its graph's pool, each routing balanced by
    # a release of the pool's reference, as torch.cuda.use_mem_pool does
    # (the card's torch has the stream's routing; this one need not).
    calls = []
    for name in ("_cuda_beginAllocateCurrentStreamToPool", "_cuda_endAllocateToPool",
                 "_cuda_releasePool"):
        monkeypatch.setattr(torch._C, name, lambda *a, name=name: calls.append((name, a)),
                            raising=False)
    with loops._allocating_to(bodies[1].pool, torch.device("cuda", 0)):
        calls.append("body")
    pool = bodies[1].pool.id
    assert calls == [("_cuda_beginAllocateCurrentStreamToPool", (0, pool)), "body",
                     ("_cuda_endAllocateToPool", (0, pool)), ("_cuda_releasePool", (0, pool))]


def test_a_loop_outside_a_captured_function_is_refused():
    """A WHILE node takes its body's stream and pool from the graph being
    captured (graphs.CapturedFunction); none outside one."""
    with pytest.raises(RuntimeError, match="outside graphs.CapturedFunction"):
        with loops._while_node(torch.tensor(True), 4):
            pass
