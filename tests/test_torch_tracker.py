"""The port's offline tracker slice against the JAX package: the frame-local
precompute, the cold-start smoothing, and the plain tracker scan (the
counterpart of kernel K3) against both JAX references, the TPU kernel
`tracker_pallas.tracker_scan` in interpret mode and the XLA `lax.scan` of
`tracking.step(precomputed=...)`.

Inputs are made with numpy from a seed (the scenarios of the JAX package's
test_tracker_pallas.py, io.synthetic.tracker_scenario) and fed to both
sides; the scan tests hand both sides the same JAX `smooth_cold` output, so
they test the scan alone. JAX runs on the CPU as conftest sets it up, the port on CPU
tensors (its kernels' plain versions).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import config as jax_config
from smartedgesensor3dhumanpose_tpu import tracking as jax_tracking
from smartedgesensor3dhumanpose_tpu.ops import tracker_pallas
from smartedgesensor3dhumanpose_tpu.types import Persons3D as JaxPersons3D
from smartedgesensor3dhumanpose_tpu.types import TrackerState as JaxTrackerState
from smartedgesensor3dhumanpose_tpu_torch import config, convert, prior, tracking
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import tracker
from smartedgesensor3dhumanpose_tpu_torch.types import Persons3D, TrackerState

pytestmark = pytest.mark.torch_port

def _jax_persons(arrays, dtype):
    return JaxPersons3D(**{
        k: jnp.asarray(v, dtype) if v.dtype == np.float64 else jnp.asarray(v)
        for k, v in arrays.items()
    })


def _torch_persons(arrays, dtype):
    return Persons3D(**{
        k: torch.as_tensor(v, dtype=dtype) if v.dtype == np.float64 else torch.as_tensor(v)
        for k, v in arrays.items()
    })


def _torch_pre(jax_pre):
    """The port's `precomputed` tuple from a JAX smooth_cold output."""
    g_in, result, xyz_out, cov_out = jax.device_get(jax_pre)
    t = torch.as_tensor
    return (
        prior.GraphInputs(*(t(np.asarray(x)) for x in g_in)),
        prior.PriorResult(x=t(result.x), marg_cov=t(result.marg_cov),
                          marg_ok=t(result.marg_ok), iters=0),
        t(xyz_out),
        t(cov_out),
    )


def _assert_scan_equal(got, want, msg):
    """test_tracker_pallas's contract: integers exact, floats within its
    tolerances (float32 on both sides, the same smoothing input)."""
    st_got, out_got = got
    st_want, out_want = want

    def exact(name, a, b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{msg} {name}")

    def close(name, a, b, tol):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
        np.testing.assert_allclose(np.where(both_inf, 0.0, a), np.where(both_inf, 0.0, b),
                                   rtol=0, atol=tol, err_msg=f"{msg} {name}")

    exact("publish", out_got.fused.valid, out_want.fused.valid)
    exact("person_id", out_got.fused.person_id, out_want.fused.person_id)
    exact("pred ids", out_got.fused_pred.person_id, out_want.fused_pred.person_id)
    exact("n_dropped_spawns", out_got.n_dropped_spawns, out_want.n_dropped_spawns)
    close("pred_delta_t", out_got.pred_delta_t, out_want.pred_delta_t, 1e-6)
    close("fused.xyz", out_got.fused.xyz, out_want.fused.xyz, 1e-6)
    close("fused_pred.xyz", out_got.fused_pred.xyz, out_want.fused_pred.xyz, 1e-4)
    close("fused_pred.cov", out_got.fused_pred.cov, out_want.fused_pred.cov, 1e-6)
    for name in ("alive", "track_id", "num_obs", "next_id", "frame_nr", "est_exists"):
        exact(name, getattr(st_got, name), getattr(st_want, name))
    for name, tol in (("estimate", 1e-6), ("vel_buffer", 1e-3), ("t_prev", 0.0),
                      ("height_prev", 1e-6), ("root_prev", 1e-5),
                      ("fb_delay_buffer", 1e-7), ("t_prev_global", 0.0)):
        close(name, getattr(st_got, name), getattr(st_want, name), tol)


def _as_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor),
    )


@pytest.mark.parametrize("name", list(synthetic.TRACKER_SCENARIOS))
def test_plain_tracker_scan_matches_both_jax_scans(name):
    """tracker_scan on CPU tensors (the plain version K3 is held to on the
    card) against JAX tracker_scan(interpret=True) and the XLA scan."""
    arrays, pivots, fb, t_slots, min_obs = synthetic.tracker_scenario(name)
    jcfg = jax_config.TrackerConfig(max_tracks=t_slots, min_num_obs=min_obs)
    jprior = jax_config.PriorConfig()
    jpersons = _jax_persons(arrays, jnp.float32)
    jpre = jax.lax.map(lambda q: jax_tracking.smooth_cold(q, jprior), jpersons, batch_size=8)
    state0 = JaxTrackerState.initial(t_slots, jcfg.n_mov_avg, jcfg.avg_delay, dtype=jnp.float32)

    def body(carry, xs):
        person_t, pivot_t, fb_t, pre_t = xs
        return jax_tracking.step(carry, person_t, pivot_t, fb_t, jprior, jcfg,
                                 precomputed=pre_t)

    xla = jax.device_get(jax.lax.scan(
        body, state0, (jpersons, jnp.asarray(pivots), jnp.asarray(fb), jpre)
    ))
    pallas = jax.device_get(tracker_pallas.tracker_scan(
        state0, jpersons, jnp.asarray(pivots), jnp.asarray(fb), jpre, jprior, jcfg,
        interpret=True,
    ))

    tcfg = config.TrackerConfig(max_tracks=t_slots, min_num_obs=min_obs)
    got = tracker.tracker_scan(
        TrackerState.initial(t_slots, tcfg.n_mov_avg, tcfg.avg_delay, device="cpu"),
        _torch_persons(arrays, torch.float32), torch.as_tensor(pivots),
        torch.as_tensor(fb), _torch_pre(jpre), config.PriorConfig(), tcfg,
    )
    got = _as_numpy(got)
    _assert_scan_equal(got, xla, f"{name} vs XLA scan")
    _assert_scan_equal(got, pallas, f"{name} vs TPU kernel (interpret)")
    # The scenario must exercise what it is named for.
    assert got[1].fused.valid.sum() > 0
    if name == "capacity_drops":
        assert got[1].n_dropped_spawns.sum() > 0


def test_person_sequence_draws_as_the_jax_tests():
    """io.synthetic.person_sequence is test_tracker_pallas's generator, draw
    for draw."""
    import test_tracker_pallas

    for seed, f, p, merge_heavy in ((0, 7, 5, False), (2, 12, 8, True)):
        got = synthetic.person_sequence(np.random.default_rng(seed), f, p, merge_heavy)
        want = test_tracker_pallas._synthetic_person_seq(
            np.random.default_rng(seed), f, p, merge_heavy
        )
        for name, w in want._asdict().items():
            np.testing.assert_array_equal(np.asarray(got[name], np.asarray(w).dtype),
                                          np.asarray(w), err_msg=name)


def test_frame_local_chain_matches_jax():
    rng = np.random.default_rng(11)
    f, c, w = 23, 5, 3
    has_dets = rng.uniform(size=f) > 0.3
    fb = np.where(rng.uniform(size=(f, c)) < 0.6, rng.uniform(0.05, 0.3, size=(f, c)),
                  -1.0).astype(np.float32)
    fb[4] = -1.0  # a frame with no measured delay falls back to avg_delay
    pivots = (7.0 + np.cumsum(rng.uniform(0.01, 0.05, size=f))).astype(np.float32)
    ring0 = np.array([0.12, 0.08, 0.2], np.float32)
    cfg = config.TrackerConfig()

    jstate = JaxTrackerState.initial(4, w, cfg.avg_delay, dtype=jnp.float32)._replace(
        frame_nr=jnp.int32(5), fb_delay_buffer=jnp.asarray(ring0),
        t_prev_global=jnp.float32(6.98),
    )
    want = jax.device_get(tracker_pallas._frame_local_chain(
        jstate, jnp.asarray(has_dets), jnp.asarray(fb), jnp.asarray(pivots),
        jax_config.TrackerConfig(),
    ))
    tstate = convert.tracker_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()}, device="cpu"
    )
    got = tracker.frame_local_chain(
        tstate, torch.as_tensor(has_dets), torch.as_tensor(fb), torch.as_tensor(pivots), cfg
    )
    names = ("pred_delta_t", "slot_w", "dt_glob", "fb_final", "frame_nr")
    for name, g, wnt in zip(names, got, want):
        if name in ("slot_w", "frame_nr"):
            np.testing.assert_array_equal(g.numpy(), wnt, err_msg=name)
        else:
            # Both float32: a mean of three delays in two summation orders.
            np.testing.assert_allclose(g.numpy(), wnt, rtol=0, atol=1e-7, err_msg=name)


def test_smooth_cold_matches_jax_f64():
    """The cold-start smoothing over a [frames, persons] batch, float64 on
    both sides, against JAX smooth_cold mapped over the frames."""
    arrays = synthetic.person_sequence(np.random.default_rng(3), 6, 5)
    jprior = jax_config.PriorConfig()
    want = jax.device_get(jax.lax.map(
        lambda q: jax_tracking.smooth_cold(q, jprior), _jax_persons(arrays, jnp.float64),
        batch_size=3,
    ))
    got = tracking.smooth_cold(_torch_persons(arrays, torch.float64), config.PriorConfig())
    for name, g, w in zip(prior.GraphInputs._fields, got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_array_equal(got[1].marg_ok.numpy(), want[1].marg_ok)
    # float64 LM on both sides; they differ in summation order and in where
    # each stops inside the LM's 1e-5 error tolerance.
    np.testing.assert_allclose(got[1].x.numpy(), want[1].x, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=1e-7)
    np.testing.assert_allclose(got[3].numpy(), want[3], rtol=1e-5, atol=1e-10)
    # Grouping frames differently gives the same persons.
    split = [tracking.smooth_cold(Persons3D(*(x[lo:lo + 2] for x in
                                              _torch_persons(arrays, torch.float64))),
                                  config.PriorConfig()) for lo in (0, 2, 4)]
    np.testing.assert_allclose(torch.cat([s[1].x for s in split]).numpy(),
                               got[1].x.numpy(), rtol=0, atol=1e-12)


def test_tracker_scan_domain_is_checked():
    """K3 takes persons <= track slots <= 120 with 21 joints; other shapes
    take the per-frame loop with K1 on the card (tracker_scan routes by
    kernel_takes)."""
    assert tracker.kernel_takes(16, 24, 21)
    assert tracker.kernel_takes(40, 64, 21)
    assert tracker.kernel_takes(120, 120, 21)
    for p, t_slots, k in ((25, 24, 21), (16, 121, 21), (16, 24, 17)):
        assert not tracker.kernel_takes(p, t_slots, k)


def test_state_buffers_round_trip():
    """The kernel's state layout holds a TrackerState exactly, and the
    buffers are copies: writing them leaves the caller's state alone."""
    rng = np.random.default_rng(4)
    t_slots, w = 7, 3
    arrays = {
        "alive": rng.uniform(size=t_slots) > 0.5,
        "track_id": rng.integers(-1, 50, size=t_slots),
        "estimate": rng.normal(size=(t_slots, 21, 3)),
        "est_exists": rng.uniform(size=(t_slots, 21)) > 0.3,
        "vel_buffer": rng.normal(size=(t_slots, 21, w, 3)),
        "t_prev": rng.normal(size=t_slots),
        "num_obs": rng.integers(0, 30, size=t_slots),
        "height_prev": rng.normal(size=t_slots),
        "root_prev": rng.normal(size=(t_slots, 3)),
        "next_id": np.int32(51),
        "frame_nr": np.int32(9),
        "fb_delay_buffer": rng.uniform(size=w),
        "t_prev_global": np.float64(3.5),
    }
    state = convert.tracker_state_from_numpy(arrays, device="cpu", dtype=torch.float32)
    buf = tracker.state_buffers(state)
    back = tracker.state_from_buffers(buf, state, state.frame_nr, state.fb_delay_buffer,
                                      state.t_prev_global)
    for name, a, b in zip(TrackerState._fields, state, back):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for x in buf.values():
        x.zero_()
    assert torch.equal(state.track_id, torch.as_tensor(arrays["track_id"], dtype=torch.int32))


def test_scan_plan_stages_every_frame_within_a_block():
    """K3's shared-memory plan: the demo and scaled shapes keep everything on
    chip (two frame records and the velocity rings); across the whole
    domain (P <= T <= 120, W = 3) the plan stages each frame at least once,
    fits a block beside the kernel's static shared memory, and its byte
    count is the sum of what it holds."""
    for p, t_slots in ((16, 24), (40, 64)):
        plan = tracker.scan_plan(p, t_slots, 3)
        assert plan.stages == 2 and plan.rings_on_chip, (p, t_slots, plan)
    edge = tracker.scan_plan(tracker.MAX_TRACKS, tracker.MAX_TRACKS, 3)
    assert not (edge.stages == 2 and edge.rings_on_chip), edge
    budget = tracker.SMEM_PER_BLOCK - tracker.STATIC_SMEM_RESERVE
    assert tracker.SMEM_PER_BLOCK == 232_448
    for t_slots in range(1, tracker.MAX_TRACKS + 1):
        for p in range(1, t_slots + 1):
            plan = tracker.scan_plan(p, t_slots, 3)
            assert plan.stages in (1, 2)
            assert plan.smem_bytes <= budget, (p, t_slots, plan)
            rings = -(-4 * t_slots * 21 * 3 * 3 // 16) * 16
            want = (tracker.state_smem_bytes(p, t_slots)
                    + plan.stages * tracker.frame_layout(p)[1]
                    + (rings if plan.rings_on_chip else 0))
            assert plan.smem_bytes == want, (p, t_slots, plan)


@pytest.mark.parametrize("p", [1, 5, 16, 40, 120])
def test_frame_records_round_trip(p):
    """The packed frame record holds the ten per-frame fields exactly, each
    at a 16-byte-aligned offset, the record a multiple of 16 bytes."""
    g = torch.Generator().manual_seed(p)
    f = 3
    vals = dict(
        meas=torch.randn(f, p, 21, 3, generator=g), rx=torch.randn(f, p, 21, 3, generator=g),
        root=torch.randn(f, p, 3, generator=g), hgt=torch.randn(f, p, generator=g),
        okpk=torch.rand(f, p, 21, generator=g) > 0.5, act=torch.rand(f, p, 21, generator=g) > 0.5,
        valid=torch.rand(f, p, generator=g) > 0.5, hm=torch.rand(f, p, generator=g) > 0.5,
        fsc=torch.randn(f, 3, generator=g),
        fint=torch.randint(0, 3, (f, 2), dtype=torch.int32, generator=g),
    )
    records = tracker.pack_frames(vals, p)
    fields, nbytes = tracker.frame_layout(p)
    assert records.dtype == torch.uint8 and records.shape == (f, nbytes) and nbytes % 16 == 0
    assert [name for name, *_ in fields] == list(vals)
    for name, dtype, shape, offset in fields:
        assert offset % 16 == 0, name
        raw = records[:, offset:offset + math.prod(shape) * dtype.itemsize]
        back = raw.contiguous().view(dtype).reshape(f, *shape)
        assert torch.equal(back, vals[name].to(dtype).reshape(f, *shape)), name
    # Padding between fields is zero.
    used = torch.zeros(nbytes, dtype=torch.bool)
    for name, dtype, shape, offset in fields:
        used[offset:offset + math.prod(shape) * dtype.itemsize] = True
    assert not records[:, ~used].any()
