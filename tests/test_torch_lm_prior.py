"""Kernels L1 (the whole LM in one launch, or one trip) and L2 (the tree
marginals), ops/lm_prior.py: their plain twins against the port's plain LM
(`prior._lm_trip`, `tree_solve.tree_solve_levels`) and against the JAX
package, the LM's twin (`lm_solve_plain`) against the loop of single
trips, the routing, the tables csrc/lm_prior.cu holds, and on a card the
kernels against their twins bit for bit.

The twins sum in the kernels' fixed order, the plain path in einsum's and
index_add's. In float64 they agree to rounding for 6 trips: 1e-12 of the
batch's largest joint and error (measured up to 2.1e-16); from the 7th
trip on, the adversarial frames' ghost that never converges departs
(7e-11 after 8 trips; ROADMAP C2). In float32 every trip's done flags and
trip count agree on the golden frames, and the joints of the persons both
loops leave converged agree within 1e-5 of the normalized height
(measured 7.2e-7). L2's twin agrees with the plain marginals to 1e-12
of each block's largest entry in float64 (measured 1.2e-14). Against JAX
the full LM through the twins keeps the budgets of
tests/test_torch_ops.py's prior test.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import prior as jax_prior
from smartedgesensor3dhumanpose_tpu.config import PriorConfig as JaxPriorConfig
from smartedgesensor3dhumanpose_tpu.types import Persons3D as JaxPersons3D
from smartedgesensor3dhumanpose_tpu_torch import cameras, config, fusion, pipeline, prior, skeleton
from smartedgesensor3dhumanpose_tpu_torch.config import PriorConfig
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import lm_prior, loops, tree_solve
from smartedgesensor3dhumanpose_tpu_torch.types import Frame, Persons3D

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_golden_demo16.npz")
SOURCE = os.path.join(_REPO, "smartedgesensor3dhumanpose_tpu_torch", "csrc", "lm_prior.cu")
# Frames of each golden scene whose fused persons the tests take: the
# benign ones converge in a few trips, the adversarial ones hold a ghost
# that runs all 32.
FRAMES = {"benign": (8, 10), "adversarial": (40, 44)}
F64_TRIPS = 6
F64_RTOL = 1e-12
F32_X_TOL = 1e-5


@pytest.fixture(scope="module")
def golden_persons():
    """Each scene's fused persons over FRAMES (float32, plain fold),
    flattened to one batch."""
    golden = np.load(GOLDEN)
    cfg = config.PipelineConfig.demo_16cam()
    rig = cameras.hall_rig(16, device="cpu")
    out = {}
    for scene, (lo, hi) in FRAMES.items():
        kw = json.loads(str(golden[f"{scene}/scene"]))
        data = synthetic.pad_detections(
            synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw)),
                                        np.float32),
            cfg.fusion.max_dets_per_cam,
        )
        frames, _ = pipeline.mask_stale_cameras(
            Frame.from_arrays({k: v[lo:hi] for k, v in data.items()}, "cpu"),
            cfg.fusion.max_sync_diff,
        )
        persons, _ = fusion.fuse_frames(frames, rig, cfg.fusion)
        out[scene] = Persons3D(*(x.flatten(0, 1) for x in persons))
    return out


def _as(persons: Persons3D, dtype) -> Persons3D:
    return Persons3D(*(x.to(dtype) if x.is_floating_point() else x for x in persons))


def _start(persons: Persons3D, cfg: PriorConfig):
    """(GraphInputs, the plain LM's first carry, L1's, the kernels' inputs,
    the bone tables)."""
    g_in = prior.build_graph_inputs(persons, cfg)
    carry, bones = prior._lm_start(g_in, g_in.meas, cfg)
    return g_in, carry, prior._fused_carry(carry), prior._fused_inputs(g_in, bones), bones


# ------------------------------------------------------------- the trip --

@pytest.mark.parametrize("scene", sorted(FRAMES))
def test_trip_twin_matches_plain_trip_f64(golden_persons, scene):
    """L1's twin against `prior._lm_trip`, trip by trip, in float64."""
    cfg = config.PipelineConfig.demo_16cam().prior
    g_in, plain, fused, ins, bones = _start(_as(golden_persons[scene], torch.float64), cfg)
    eye3 = torch.eye(3, dtype=torch.float64)
    for trip in range(F64_TRIPS):
        plain = prior._lm_trip(plain, g_in, bones, eye3, cfg)
        fused = lm_prior.lm_trip_plain(fused, *ins, cfg)
        x_scale = float(plain[0].abs().max())
        err_scale = float(plain[1].abs().max())
        assert float((fused[0] - plain[0]).abs().max()) <= F64_RTOL * x_scale, trip
        assert float((fused[1] - plain[1]).abs().max()) <= F64_RTOL * err_scale, trip
        assert torch.equal(fused[2], plain[2]) and torch.equal(fused[3], plain[3]), trip
        assert int(fused[4]) == int(plain[4]) == trip + 1
        assert bool(fused[5]) == bool(~plain[3].all())
        assert fused[6].tolist() == [0, 0]


@pytest.mark.parametrize("scene", sorted(FRAMES))
def test_trip_twin_matches_plain_trip_f32(golden_persons, scene):
    """In float32, over the whole LM: every trip's done flags and trip
    count equal; the joints of persons both leave converged within
    F32_X_TOL."""
    cfg = config.PipelineConfig.demo_16cam().prior
    g_in, plain, fused, ins, bones = _start(golden_persons[scene], cfg)
    eye3 = torch.eye(3)
    trips = 0
    while bool(fused[5]) and trips < cfg.lm_max_iterations:
        assert bool(~plain[3].all())
        plain = prior._lm_trip(plain, g_in, bones, eye3, cfg)
        fused = lm_prior.lm_trip_plain(fused, *ins, cfg)
        trips += 1
        assert torch.equal(fused[3], plain[3]) and int(fused[4]) == int(plain[4]) == trips
    assert bool(fused[5]) == bool(~plain[3].all())
    conv = fused[3] & plain[3]
    assert int(conv.sum()) >= len(conv) - 1
    assert float((fused[0] - plain[0])[conv].abs().max()) <= F32_X_TOL


def test_trip_twin_leaves_a_finished_batch_as_it_is(golden_persons):
    """A trip after every person is done returns its carry: the test and
    the count see no person running."""
    cfg = config.PipelineConfig.demo_16cam().prior
    _, _, fused, ins, _ = _start(_as(golden_persons["benign"], torch.float64), cfg)
    for _ in range(cfg.lm_max_iterations):
        if not bool(fused[5]):
            break
        fused = lm_prior.lm_trip_plain(fused, *ins, cfg)
    assert bool(fused[3].all()) and not bool(fused[5])
    again = lm_prior.lm_trip_plain(fused, *ins, cfg)
    for a, b in zip(again, fused):
        assert torch.equal(a, b)


# ------------------------------------------------------ the whole LM --

def _loop(carry, ins, cfg, max_trips):
    """The per-trip LM: `loops.while_loop` over the single trip, at most
    max_trips trips."""
    return loops.while_loop(lambda c: c[5], lambda c: lm_prior.lm_trip_plain(c, *ins, cfg),
                            carry, max_trips)


def _assert_carries_equal(got, want):
    """x, err, lam, done, iters and the test equal bit for bit; scratch zero."""
    for a, b in zip(got[:6], want[:6]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[6].tolist() == [0, 0]


DTYPES = {"f32": torch.float32, "f64": torch.float64}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scene", sorted(FRAMES))
def test_solve_twin_equals_loop_of_trips(golden_persons, scene, dtype):
    """`lm_solve_plain` (L1's twin over a whole LM) ends where the loop of
    single trips ends, bit for bit, with JAX's count."""
    cfg = config.PipelineConfig.demo_16cam().prior
    _, _, start, ins, _ = _start(_as(golden_persons[scene], DTYPES[dtype]), cfg)
    got = lm_prior.lm_solve_plain(start, *ins, cfg)
    want = _loop(start, ins, cfg, cfg.lm_max_iterations)
    _assert_carries_equal(got, want)
    assert 0 < int(got[4]) <= cfg.lm_max_iterations
    assert bool(got[5]) == (not bool(got[3].all()))
    assert int(start[4]) == 0  # the twin returns new tensors


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scene", sorted(FRAMES))
def test_solve_twin_at_a_cap_that_leaves_persons_running(golden_persons, scene, dtype):
    """At lm_max_iterations = 3 some persons end not done: the twin stops at
    the cap, as the loop does, bit for bit, and the test stays set."""
    cfg = dataclasses.replace(config.PipelineConfig.demo_16cam().prior, lm_max_iterations=3)
    _, _, start, ins, _ = _start(_as(golden_persons[scene], DTYPES[dtype]), cfg)
    got = lm_prior.lm_solve_plain(start, *ins, cfg)
    _assert_carries_equal(got, _loop(start, ins, cfg, 3))
    assert int(got[4]) == 3 and bool(got[5]) and not bool(got[3].all())
    # A cap below cfg's, passed to the wrapper (the CPU takes the twin).
    two = lm_prior.lm_solve(start, *ins, cfg, 2)
    _assert_carries_equal(two, _loop(start, ins, cfg, 2))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_solve_twin_leaves_a_finished_batch_as_it_is(golden_persons, dtype):
    """Every person done at the start: no trip, `iters` 0, the carry as it
    was."""
    cfg = config.PipelineConfig.demo_16cam().prior
    g_in, carry, _, ins, _ = _start(_as(golden_persons["benign"], DTYPES[dtype]), cfg)
    start = prior._fused_carry(carry[:3] + (torch.ones_like(carry[3]),) + carry[4:])
    assert not bool(start[5])
    got = lm_prior.lm_solve_plain(start, *ins, cfg)
    _assert_carries_equal(got, start)
    assert int(got[4]) == 0


@pytest.mark.parametrize("scene", sorted(FRAMES))
def test_solve_twin_from_a_carry_with_trips_run(golden_persons, scene):
    """A carry that starts with iters_in = 2 > 0: the twin runs at most
    lm_max_iterations - 2 more trips and ends where the loop from that
    carry ends, and where the LM from the cold start ends."""
    cfg = config.PipelineConfig.demo_16cam().prior
    _, _, start, ins, _ = _start(_as(golden_persons[scene], torch.float64), cfg)
    mid = lm_prior.lm_trip_plain(lm_prior.lm_trip_plain(start, *ins, cfg), *ins, cfg)
    assert int(mid[4]) == 2 and bool(mid[5])
    got = lm_prior.lm_solve_plain(mid, *ins, cfg)
    _assert_carries_equal(got, _loop(mid, ins, cfg, cfg.lm_max_iterations - 2))
    _assert_carries_equal(got, lm_prior.lm_solve_plain(start, *ins, cfg))


@pytest.mark.parametrize("scene", sorted(FRAMES))
def test_fused_lm_at_a_cap_matches_jax(golden_persons, scene):
    """`optimize(_fused=True)` (the one-launch route, through its twins on
    the CPU) against JAX's `optimize` at lm_max_iterations = 3, float64:
    the same count, joints within 1e-8, the marginals within the budgets
    of test_torch_ops.py's prior test."""
    cfg = dataclasses.replace(config.PipelineConfig.demo_16cam().prior, lm_max_iterations=3)
    jcfg = JaxPriorConfig(lm_max_iterations=3)
    p64 = _as(golden_persons[scene], torch.float64)
    jp = JaxPersons3D(*(jnp.asarray(x.numpy()) for x in p64))
    jg = jax.jit(jax_prior.build_graph_inputs, static_argnums=1)(jp, jcfg)
    jr = jax.jit(jax_prior.optimize, static_argnums=2)(jg, jg.meas, jcfg)
    g_in = prior.build_graph_inputs(p64, cfg)
    tr = prior.optimize(g_in, g_in.meas, cfg, _fused=True)
    assert int(tr.iters) == int(jr.iters) == 3
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tr.marg_ok.numpy(), np.asarray(jr.marg_ok))
    np.testing.assert_allclose(tr.marg_cov.numpy(), np.asarray(jr.marg_cov), rtol=1e-6, atol=1e-15)


# ------------------------------------------------------- the marginals --

def _plain_marginals(x, g_in, bones):
    """`prior.optimize`'s tail on the plain path: (x, marg, marg_ok)."""
    p = x.shape[0]
    bad = ~torch.isfinite(x.reshape(p, -1)).all(dim=-1)
    x = torch.where(bad[:, None, None], g_in.meas, x)
    hdiag, coup, _, _ = prior._linearize_tree(x, g_in, bones)
    _, marg = tree_solve.tree_solve_levels(hdiag, coup, g_in.bone_active, torch.zeros_like(x),
                                           want_sigma=True)
    ok = torch.isfinite(marg.reshape(p, -1)).all(dim=-1) & ~bad
    return x, torch.where(ok[:, None, None, None], marg, torch.eye(3, dtype=x.dtype)), ok


@pytest.mark.parametrize("scene", sorted(FRAMES))
def test_marginals_twin_matches_tree_solve(golden_persons, scene):
    """L2's twin against the plain marginals (`tree_solve_levels` with
    want_sigma) at the LM's result, float64, with one person's joints made
    non-finite (back to its measurements, identity blocks, marg_ok
    false)."""
    cfg = config.PipelineConfig.demo_16cam().prior
    g_in, _, _, ins, bones = _start(_as(golden_persons[scene], torch.float64), cfg)
    x = prior.optimize(g_in, g_in.meas, cfg, _fused=True).x.clone()
    x[1, 3, 0] = float("nan")
    got = lm_prior.lm_marginals_plain(x, *ins)
    want = _plain_marginals(x, g_in, bones)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert not bool(got[2][1])
    assert torch.equal(got[1][1], torch.eye(3, dtype=x.dtype).expand(21, 3, 3))
    scale = want[1].abs().amax(dim=(-2, -1), keepdim=True)
    assert float(((got[1] - want[1]).abs() / scale).max()) <= F64_RTOL


# ------------------------------------------------------ against JAX ------

def _random_persons(rng, p=4):
    k = skeleton.NUM_FUSION_JOINTS
    a = rng.normal(size=(p, k, 3, 3))
    cov = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(3)) * 1e-4
    xyz = rng.normal(size=(p, k, 3)) * 0.3 + np.array([0.0, 0.0, 1.0])
    score = np.where(rng.uniform(size=(p, k)) < 0.85, rng.uniform(0.2, 0.9, (p, k)), 0.0)
    valid = np.array([True, True, False, True])[:p]
    return xyz, score, cov, valid


def _both(xyz, score, cov, valid, jcfg, tcfg):
    p = xyz.shape[0]
    jp = JaxPersons3D(jnp.asarray(xyz), jnp.asarray(score), jnp.asarray(cov),
                      jnp.asarray(valid), -jnp.ones(p, jnp.int32))
    tp = Persons3D(torch.from_numpy(xyz), torch.from_numpy(score), torch.from_numpy(cov),
                   torch.from_numpy(valid), torch.full((p,), -1, dtype=torch.int32))
    return (jax.jit(jax_prior.build_graph_inputs, static_argnums=1)(jp, jcfg),
            prior.build_graph_inputs(tp, tcfg))


@pytest.mark.parametrize("normalize_by_height", [False, True])
def test_lm_through_twins_matches_jax(rng, normalize_by_height):
    """The whole LM through the twins (`optimize(..., _fused=True)`)
    against JAX's `optimize`, float64, from a perturbed warm start: the
    budgets of test_torch_ops.py::test_prior_matches_jax."""
    jcfg = JaxPriorConfig(normalize_by_height=normalize_by_height)
    tcfg = PriorConfig(normalize_by_height=normalize_by_height)
    jg, tg = _both(*_random_persons(rng), jcfg, tcfg)
    warm = tg.meas + 0.01 * torch.from_numpy(rng.normal(size=tg.meas.shape)) * tg.active[..., None]
    jr = jax.jit(jax_prior.optimize, static_argnums=2)(jg, jnp.asarray(warm.numpy()), jcfg)
    tr = prior.optimize(tg, warm, tcfg, _fused=True)
    assert tr.iters.dtype == torch.int32 and tr.iters.dim() == 0
    assert int(tr.iters) == int(jr.iters)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tr.marg_ok.numpy(), np.asarray(jr.marg_ok))
    np.testing.assert_allclose(tr.marg_cov.numpy(), np.asarray(jr.marg_cov), rtol=1e-6, atol=1e-15)


def test_lm_and_marginals_through_twins_match_jax_on_golden_persons(golden_persons):
    """The benign frames' persons (all converge): the LM through the twins
    against JAX's, float64; and L2's twin at JAX's result against JAX's
    tree marginals."""
    cfg = config.PipelineConfig.demo_16cam().prior
    jcfg = JaxPriorConfig()
    p64 = _as(golden_persons["benign"], torch.float64)
    jp = JaxPersons3D(*(jnp.asarray(x.numpy()) for x in p64))
    jg = jax.jit(jax_prior.build_graph_inputs, static_argnums=1)(jp, jcfg)
    jr = jax.jit(jax_prior.optimize, static_argnums=2)(jg, jg.meas, jcfg)
    g_in, _, _, ins, _ = _start(p64, cfg)
    tr = prior.optimize(g_in, g_in.meas, cfg, _fused=True)
    assert int(tr.iters) == int(jr.iters) < cfg.lm_max_iterations
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tr.marg_ok.numpy(), np.asarray(jr.marg_ok))
    x, marg, ok = lm_prior.lm_marginals_plain(torch.from_numpy(np.array(jr.x)), *ins)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jr.marg_ok))
    np.testing.assert_allclose(marg.numpy(), np.asarray(jr.marg_cov), rtol=1e-6, atol=1e-15)


# ---------------------------------------------- the tables and the routes --

def test_sibling_orders_are_pinned():
    """The three parents with several children in one level, and the order
    in which the twins and the kernels add those children's eliminations
    (level index deepest first: joint 0 at the second level, joint 1 at the
    third, joint 8 at the fifth)."""
    assert lm_prior.sibling_orders() == {
        (1, skeleton.NOSE): (15, 16, 17),
        (2, skeleton.NECK): (6, 7, 8),
        (4, skeleton.MIDHIP): (0, 1, 13),
    }
    assert lm_prior.LEVELS == tuple(tuple(int(b) for b in lvl) for lvl in tree_solve.LEVELS)


def test_cuda_source_holds_the_tables():
    """csrc/lm_prior.cu's constant tables are the ones ops/lm_prior.py
    derives from the skeleton."""
    src = open(SOURCE).read()
    found = {m.group(1): [float(v.replace("f", "")) for v in m.group(2).split(",")]
             for m in re.finditer(r"__constant__ \w+ (c_\w+)\[[^\]]*\] = \{([^}]*)\};", src)}
    want = lm_prior.cuda_tables()
    assert set(found) == set(want)
    for name, values in want.items():
        assert found[name] == [float(v) for v in values], name


def test_routes(golden_persons, monkeypatch):
    """The tree solver goes to L1 and L2 on CUDA only; the CPU runs the
    plain trip and the dense solver never runs them; the kernels' route
    (forced on the CPU with `_fused`) makes one `lm_solve` call and one
    `lm_marginals` call per LM and no `loops.while_loop`; a CUDA float64
    input raises TypeError."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = config.PipelineConfig.demo_16cam().prior
    g_in = prior.build_graph_inputs(golden_persons["benign"], cfg)

    def refused(*a, **k):
        raise AssertionError("the CPU ran a kernel's route")

    assert not lm_prior.takes(g_in.meas, "tree")
    for name in ("lm_solve", "lm_trip", "lm_marginals"):
        monkeypatch.setattr(lm_prior, name, refused)
    prior.optimize(g_in, g_in.meas, cfg)
    monkeypatch.undo()

    calls = {"lm_solve": 0, "lm_marginals": 0}

    def counted(name):
        fn = getattr(lm_prior, name)

        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return call

    def no_loop(*a, **k):
        raise AssertionError("the kernels' route ran loops.while_loop")

    for name in calls:
        monkeypatch.setattr(lm_prior, name, counted(name))
    monkeypatch.setattr(lm_prior, "lm_trip", refused)
    monkeypatch.setattr(loops, "while_loop", no_loop)
    res = prior.optimize(g_in, g_in.meas, cfg, _fused=True)
    monkeypatch.undo()
    assert calls == {"lm_solve": 1, "lm_marginals": 1}
    assert 0 < int(res.iters) < cfg.lm_max_iterations
    with FakeTensorMode():
        x = torch.empty((4, 21, 3), device="cuda")
        assert lm_prior.takes(x, "tree") and not lm_prior.takes(x, "dense")
        f64 = [torch.empty(s, dtype=d, device="cuda") for s, d in (
            ((4, 21, 3), torch.float64), ((4,), torch.float64), ((4,), torch.float64),
            ((4,), torch.bool), ((), torch.int32), ((), torch.bool), ((2,), torch.int32))]
        ins = [torch.empty(s, dtype=d, device="cuda") for s, d in (
            ((4, 21, 3), torch.float64), ((4, 21), torch.bool), ((4, 21, 3, 3), torch.float64),
            ((4, 21), torch.bool), ((21,), torch.float64), ((21,), torch.float64))]
        with pytest.raises(TypeError, match="float32"):
            lm_prior.lm_trip(tuple(f64), *ins, cfg)
        with pytest.raises(TypeError, match="float32"):
            lm_prior.lm_solve(tuple(f64), *ins, cfg)
        with pytest.raises(TypeError, match="float32"):
            lm_prior.lm_marginals(f64[0], *ins)


# ------------------------------------------------------------ on a card --

@pytest.mark.cuda
def test_kernels_match_twins_on_card(golden_persons):
    """L1 and L2 against their twins, bit for bit, over a whole LM of each
    scene's persons (float32 on the card): L1 one trip a launch against
    `lm_trip_plain`, and the whole LM in one launch against
    `lm_solve_plain` and against the trips one a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: L1 and L2 are CUDA kernels")
    cfg = config.PipelineConfig.demo_16cam().prior
    dev = torch.device("cuda", 0)
    for persons in golden_persons.values():
        persons = Persons3D(*(x.to(dev) for x in persons))
        _, _, want, ins, _ = _start(persons, cfg)
        start = tuple(t.clone() for t in want)
        one = lm_prior.lm_solve(tuple(t.clone() for t in start), *ins, cfg)
        _assert_carries_equal(one, lm_prior.lm_solve_plain(start, *ins, cfg))
        got = tuple(t.clone() for t in want)
        trips = 0
        while bool(want[5]) and trips < cfg.lm_max_iterations:
            got = lm_prior.lm_trip(got, *ins, cfg)
            want = lm_prior.lm_trip_plain(want, *ins, cfg)
            trips += 1
            for a, b in zip(got[:6], want[:6]):
                assert torch.equal(a, b)
            assert got[6].tolist() == [0, 0]
        _assert_carries_equal(one, got)
        for a, b in zip(lm_prior.lm_marginals(got[0], *ins),
                        lm_prior.lm_marginals_plain(got[0], *ins)):
            assert torch.equal(a, b)
