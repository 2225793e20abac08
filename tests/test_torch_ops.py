"""The port's geometry and smoothing ops against their JAX counterparts, one
module at a time, on the same random float64 inputs (numpy, seeded).

These ops hold no kernel; the checks localize a fault that the slice tests
(test_torch_pipeline.py) would only show end to end. Both sides compute the
same float64 algebra in another evaluation order, so values agree to a few
ulps of their magnitude: 1e-9 relative unless stated.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import prior as jax_prior
from smartedgesensor3dhumanpose_tpu.config import PriorConfig as JaxPriorConfig
from smartedgesensor3dhumanpose_tpu.ops import covariance as jax_covariance
from smartedgesensor3dhumanpose_tpu.ops import epipolar as jax_epipolar
from smartedgesensor3dhumanpose_tpu.ops import linalg as jax_linalg
from smartedgesensor3dhumanpose_tpu.ops import tree_solve as jax_tree_solve
from smartedgesensor3dhumanpose_tpu.ops import triangulation as jax_triangulation
from smartedgesensor3dhumanpose_tpu.types import Persons3D as JaxPersons3D
from smartedgesensor3dhumanpose_tpu_torch import cameras, prior, skeleton
from smartedgesensor3dhumanpose_tpu_torch.config import PriorConfig
from smartedgesensor3dhumanpose_tpu_torch.ops import (
    covariance,
    epipolar,
    linalg,
    tree_solve,
    triangulation,
)
from smartedgesensor3dhumanpose_tpu_torch.types import Persons3D

pytestmark = pytest.mark.torch_port

RTOL = 1e-9


def close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def spd(rng, shape, n):
    a = rng.normal(size=shape + (n, n))
    return a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(n)


@pytest.mark.parametrize("name", [
    "adjugate4", "smallest_eigvec4_psd", "chol2x2_packed", "chol3x3",
    "sym3_pack", "sym3_unpack",
])
def test_linalg_matches_jax(rng, name):
    inputs = {
        "adjugate4": spd(rng, (5, 3), 4),
        "smallest_eigvec4_psd": spd(rng, (7,), 4),
        "chol2x2_packed": np.stack(
            [np.full(6, 2.0), rng.uniform(-0.5, 0.5, 6), np.full(6, 1.5)], axis=-1
        ),
        "chol3x3": spd(rng, (4,), 3),
        "sym3_pack": spd(rng, (4,), 3),
        "sym3_unpack": rng.normal(size=(4, 6)),
    }[name]
    want = jax.jit(getattr(jax_linalg, name))(jnp.asarray(inputs))
    got = getattr(linalg, name)(torch.from_numpy(inputs))
    # The adjugate power iteration amplifies rounding by the eigengap of
    # these random (not DLT-like) matrices: 1e-7 relative.
    rtol = 1e-7 if name == "smallest_eigvec4_psd" else RTOL
    close(got, want, rtol=rtol)


def _views(rng, h, j, c):
    kp = np.concatenate(
        [rng.uniform(-0.6, 0.6, (h, j, c, 2)), rng.uniform(0.2, 1.0, (h, j, c, 1))],
        axis=-1,
    )
    mask = rng.uniform(size=(h, j, c)) < 0.8
    return kp, mask


def test_epipolar_matches_jax(rng):
    c = 6
    jrig = jax_cameras.hall_rig(c, dtype=jnp.float64)
    trig = cameras.hall_rig(c, dtype=torch.float64, device="cpu")
    kp = np.concatenate(
        [rng.uniform(-0.6, 0.6, (c, 4, 17, 2)), rng.uniform(0.0, 1.0, (c, 4, 17, 1))],
        axis=-1,
    )
    want = jax.jit(jax_epipolar.pairwise_association_costs_packed, static_argnums=2)(
        jnp.asarray(kp), jrig.F, 0.3
    )
    got = epipolar.pairwise_association_costs_packed(torch.from_numpy(kp), trig.F, 0.3)
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    kpv, mask = _views(rng, 3, 5, c)
    want = jax.jit(jax_epipolar.three_view_drop_scores)(
        jrig.F, jnp.asarray(kpv), jnp.asarray(mask)
    )
    got = epipolar.three_view_drop_scores(trig.F, torch.from_numpy(kpv), torch.from_numpy(mask))
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_triangulation_and_covariance_match_jax(rng):
    c = 6
    jP = jax_cameras.hall_rig(c, dtype=jnp.float64).P
    tP = cameras.hall_rig(c, dtype=torch.float64, device="cpu").P
    kp, mask = _views(rng, 3, 5, c)
    cov2d = np.stack(
        [np.full(kp.shape[:-1], 4e-5), np.full(kp.shape[:-1], 1e-6),
         np.full(kp.shape[:-1], 3e-5)], axis=-1,
    )
    jk, jm, tk, tm = jnp.asarray(kp), jnp.asarray(mask), torch.from_numpy(kp), torch.from_numpy(mask)
    T_want = jax.jit(jax_triangulation.view_contribs, static_argnums=3)(jP, jk, jm, True)
    T_got = triangulation.view_contribs(tP, tk, tm, True)
    close(T_got, T_want)
    n = tm.sum(-1)
    xyz_want = jax.jit(jax_triangulation.solve_normal)(T_want.sum(-3), jnp.asarray(n.numpy()))
    xyz_got = triangulation.solve_normal(T_got.sum(-3), n)
    # The adjugate nullvector of a random (inconsistent) view set is
    # ill-conditioned: 1e-6 relative.
    close(xyz_got, xyz_want, rtol=1e-6, atol=1e-9)
    close(triangulation.reprojection_error(xyz_got, tP, tk, tm),
          jax.jit(jax_triangulation.reprojection_error)(jnp.asarray(xyz_got.numpy()), jP, jk, jm))
    mean = xyz_got.numpy()
    close(
        covariance.triangulation_covariance(tP, tk, torch.from_numpy(cov2d), tm, torch.from_numpy(mean)),
        jax.jit(jax_covariance.triangulation_covariance)(
            jP, jk, jnp.asarray(cov2d), jm, jnp.asarray(mean)
        ),
        rtol=1e-6, atol=1e-12,
    )
    jrig = jax_cameras.hall_rig(c, dtype=jnp.float64)
    trig = cameras.hall_rig(c, dtype=torch.float64, device="cpu")
    pts = rng.uniform([-1, -1, 0.2], [1, 1, 1.8], size=(4, 3))
    cov3 = spd(rng, (4,), 3) * 1e-3
    got = covariance.project_with_covariance(
        torch.from_numpy(pts), torch.from_numpy(cov3), trig.P, trig.K
    )
    want = jax.jit(jax_covariance.project_with_covariance)(
        jnp.asarray(pts), jnp.asarray(cov3), jrig.P, jrig.K
    )
    close(got[0], want[0])
    close(got[1], want[1], rtol=1e-7)


def _persons(rng, p=4):
    k = skeleton.NUM_FUSION_JOINTS
    xyz = rng.normal(size=(p, k, 3)) * 0.3 + np.array([0.0, 0.0, 1.0])
    score = np.where(rng.uniform(size=(p, k)) < 0.85, rng.uniform(0.2, 0.9, (p, k)), 0.0)
    cov = spd(rng, (p, k), 3) * 1e-4
    valid = np.array([True, True, False, True])[:p]
    return xyz, score, cov, valid


def test_tree_solve_matches_jax(rng):
    p, k, b = 3, skeleton.NUM_FUSION_JOINTS, skeleton.NUM_BONES
    hdiag = spd(rng, (p, k), 3) + 3.0 * np.eye(3)
    coup = -spd(rng, (p, b), 3) * 0.1
    active = rng.uniform(size=(p, b)) < 0.7
    active[:, skeleton.SPINE_BONE_IDX] = False  # keep the bone graph a forest
    rhs = rng.normal(size=(p, k, 3))
    solve = jax.jit(functools.partial(jax_tree_solve.tree_solve_levels, want_sigma=True))
    want = solve(jnp.asarray(hdiag), jnp.asarray(coup), jnp.asarray(active), jnp.asarray(rhs))
    got = tree_solve.tree_solve_levels(
        torch.from_numpy(hdiag), torch.from_numpy(coup), torch.from_numpy(active),
        torch.from_numpy(rhs), want_sigma=True,
    )
    close(got[0], want[0])
    close(got[1], want[1])


@pytest.mark.parametrize("normalize_by_height", [False, True])
def test_prior_matches_jax(rng, normalize_by_height):
    xyz, score, cov, valid = _persons(rng)
    jcfg = JaxPriorConfig(normalize_by_height=normalize_by_height)
    tcfg = PriorConfig(normalize_by_height=normalize_by_height)
    jp = JaxPersons3D(jnp.asarray(xyz), jnp.asarray(score), jnp.asarray(cov),
                      jnp.asarray(valid), -jnp.ones(4, jnp.int32))
    tp = Persons3D(torch.from_numpy(xyz), torch.from_numpy(score), torch.from_numpy(cov),
                   torch.from_numpy(valid), torch.full((4,), -1, dtype=torch.int32))
    jg = jax.jit(jax_prior.build_graph_inputs, static_argnums=1)(jp, jcfg)
    tg = prior.build_graph_inputs(tp, tcfg)
    for name in jg._fields:
        close(getattr(tg, name), getattr(jg, name))
    warm = tg.meas + 0.01 * torch.from_numpy(rng.normal(size=tg.meas.shape)) * tg.active[..., None]
    jr = jax.jit(jax_prior.optimize, static_argnums=2)(jg, jnp.asarray(warm.numpy()), jcfg)
    tr = prior.optimize(tg, warm, tcfg)
    # JAX's type: a 0-d int32 count on the device.
    assert tr.iters.dtype == torch.int32 and tr.iters.dim() == 0
    assert int(tr.iters) == int(jr.iters)
    # Same LM path (equal iteration count); the tree solve's summation order
    # differs, amplified by the root's 1e4 information weight: 1e-8 m.
    close(tr.x, jr.x, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(tr.marg_ok.numpy(), np.asarray(jr.marg_ok))
    close(tr.marg_cov, jr.marg_cov, rtol=1e-6, atol=1e-15)
    got = prior.denormalize(tr, tg, tcfg)
    want = jax.jit(jax_prior.denormalize, static_argnums=2)(jr, jg, jcfg)
    close(got[0], want[0], rtol=0, atol=1e-8)
    close(got[1], want[1], rtol=1e-6, atol=1e-12)
