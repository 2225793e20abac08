"""The JAX package's public helpers that no pipeline path calls, each held
to its counterpart in the port on the same random numpy inputs: the
epipolar point-line distance, the hypothesis x detection cost, the dense
pair costs and the pairwise joint distances; the 4x4 Jacobi eigensolver;
the DLT rows and triangulation; the sequential tree solve; the type helpers
and the package root's exports.

Float64 on both sides, the same algebra in another evaluation order: 1e-9
relative unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smartedgesensor3dhumanpose_tpu as jax_pkg
import smartedgesensor3dhumanpose_tpu_torch as pkg
from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import types as jax_types
from smartedgesensor3dhumanpose_tpu.ops import epipolar as jax_epipolar
from smartedgesensor3dhumanpose_tpu.ops import linalg as jax_linalg
from smartedgesensor3dhumanpose_tpu.ops import tree_solve as jax_tree_solve
from smartedgesensor3dhumanpose_tpu.ops import triangulation as jax_triangulation
from smartedgesensor3dhumanpose_tpu_torch import cameras, skeleton, types
from smartedgesensor3dhumanpose_tpu_torch.ops import epipolar, linalg, tree_solve, triangulation

pytestmark = pytest.mark.torch_port

CAMS = 5


def close(got, want, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def t(x):
    return torch.from_numpy(np.array(x))


def _rigs():
    return jax_cameras.hall_rig(CAMS, dtype=jnp.float64), cameras.hall_rig(
        CAMS, dtype=torch.float64, device="cpu")


def _keypoints(rng, shape):
    xy = rng.uniform(-0.6, 0.6, size=shape + (2,))
    conf = rng.uniform(0.0, 1.0, size=shape + (1,))
    return np.concatenate([xy, conf], axis=-1)


def test_symmetric_epipolar_distance(rng):
    jrig, trig = _rigs()
    p1 = rng.uniform(-0.5, 0.5, size=(CAMS, CAMS, 7, 2))
    p2 = rng.uniform(-0.5, 0.5, size=(CAMS, CAMS, 7, 2))
    F = np.asarray(jrig.F)[:, :, None]
    want = jax.jit(jax_epipolar.symmetric_epipolar_distance)(F, p1, p2)
    close(epipolar.symmetric_epipolar_distance(t(F), t(p1), t(p2)), want)


def test_association_cost(rng):
    jrig, trig = _rigs()
    h, d, j = 6, 4, 17
    hyp_kp = _keypoints(rng, (h, CAMS, j))
    cam_mask = rng.uniform(size=(h, CAMS)) < 0.5
    cam_mask[0] = False  # a hypothesis with no observation
    cam_mask[1] = [True] + [False] * (CAMS - 1)  # a lone observation
    obs_score = rng.uniform(size=(h, CAMS))
    det_kp = _keypoints(rng, (d, j))
    det_valid = np.array([True, True, False, True])
    F_to_det = np.asarray(jrig.F)[:, 2]
    args = (0.3, 0.05, 1.0e6)
    want = jax.jit(jax_epipolar.association_cost, static_argnums=(6, 7, 8))(
        hyp_kp, cam_mask, obs_score, det_kp, det_valid, F_to_det, *args)
    got = epipolar.association_cost(t(hyp_kp), t(cam_mask), t(obs_score), t(det_kp),
                                    t(det_valid), t(F_to_det), *args)
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any() and not got[1].all()


@pytest.mark.parametrize("cams", [1, CAMS])
def test_pairwise_association_costs(rng, cams):
    jrig = jax_cameras.hall_rig(max(cams, 2), dtype=jnp.float64)
    F = np.asarray(jrig.F)[:cams, :cams]
    kp = _keypoints(rng, (cams, 3, 17))
    want = jax.jit(jax_epipolar.pairwise_association_costs, static_argnums=2)(kp, F, 0.3)
    got = epipolar.pairwise_association_costs(t(kp), t(F), 0.3)
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # The mirrored entry is the packed value bit for bit.
    assert torch.equal(got[0], got[0].permute(2, 3, 0, 1))


def test_pairwise_joint_epipolar_sq(rng):
    jrig, trig = _rigs()
    kp = _keypoints(rng, (4, 3, CAMS))
    mask = rng.uniform(size=(4, 3, CAMS)) < 0.7
    want = jax.jit(jax_epipolar.pairwise_joint_epipolar_sq)(jrig.F, kp, mask)
    got = epipolar.pairwise_joint_epipolar_sq(trig.F, t(kp), t(mask))
    close(got, want)
    assert torch.equal(got, got.transpose(-1, -2))


def test_eigh4_and_smallest_eigvec4(rng):
    a = rng.normal(size=(6, 4, 4))
    a = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(4)
    w_want, v_want = jax.jit(jax_linalg.eigh4)(a)
    w, v = linalg.eigh4(t(a))
    close(w, w_want)
    close(v, v_want, atol=1e-9)
    # An eigendecomposition in its own right.
    close(torch.einsum("bij,bjk->bik", t(a), v), v * w[:, None, :], atol=1e-9)
    close(linalg.smallest_eigvec4(t(a)), jax.jit(jax_linalg.smallest_eigvec4)(a), atol=1e-9)


@pytest.mark.parametrize("weight_by_conf", [True, False])
def test_dlt_rows_and_triangulate(rng, weight_by_conf):
    jrig, trig = _rigs()
    kp = _keypoints(rng, (3, 17, CAMS))
    mask = rng.uniform(size=(3, 17, CAMS)) < 0.8
    mask[0, 0] = [True] + [False] * (CAMS - 1)  # deficient: one view
    want = jax.jit(jax_triangulation.dlt_rows, static_argnums=3)(jrig.P, kp, mask, weight_by_conf)
    got = triangulation.dlt_rows(trig.P, t(kp), t(mask), weight_by_conf)
    close(got[0], want[0])
    close(got[1], want[1])
    want = jax.jit(jax_triangulation.triangulate_with_error, static_argnums=3)(
        jrig.P, kp, mask, weight_by_conf)
    got = triangulation.triangulate_with_error(trig.P, t(kp), t(mask), weight_by_conf)
    close(got[0], want[0], atol=1e-9)
    close(got[1], want[1], atol=1e-9)
    # A batch-dependent P takes the DLT rows instead of the coefficient form.
    P_j = jnp.broadcast_to(jrig.P, (3, 17) + jrig.P.shape)
    want = jax.jit(jax_triangulation.triangulate, static_argnums=3)(P_j, kp, mask, weight_by_conf)
    got = triangulation.triangulate(trig.P.expand((3, 17) + tuple(trig.P.shape)), t(kp),
                                    t(mask), weight_by_conf)
    close(got, want, atol=1e-9)


@pytest.mark.parametrize("want_sigma", [False, True])
def test_tree_solve(rng, want_sigma):
    p, k, b = 3, skeleton.NUM_FUSION_JOINTS, skeleton.NUM_BONES
    a = rng.normal(size=(p, k, 3, 3))
    hdiag = a @ np.swapaxes(a, -1, -2) + 3.0 * np.eye(3)
    c = rng.normal(size=(p, b, 3, 3))
    coup = -(c @ np.swapaxes(c, -1, -2)) * 0.1
    active = rng.uniform(size=(p, b)) < 0.7
    active[:, skeleton.SPINE_BONE_IDX] = False  # keep the bone graph a forest
    rhs = rng.normal(size=(p, k, 3))
    np.testing.assert_array_equal(tree_solve.ELIMINATION_ORDER, jax_tree_solve.ELIMINATION_ORDER)
    want = jax.jit(jax_tree_solve.tree_solve, static_argnums=4)(hdiag, coup, active, rhs,
                                                                 want_sigma)
    got = tree_solve.tree_solve(t(hdiag), t(coup), t(active), t(rhs), want_sigma)
    close(got[0], want[0])
    close(got[1], want[1])
    # The level-grouped solve the LM runs gives the same solution.
    levels = tree_solve.tree_solve_levels(t(hdiag), t(coup), t(active), t(rhs), want_sigma)
    close(levels[0], got[0])
    close(levels[1], got[1])


def test_type_helpers_and_exports():
    jrig, trig = _rigs()
    assert trig.num_cameras == jrig.num_cameras == CAMS
    arrays = dict(kp2d=np.zeros((CAMS, 2, 17, 3)), cov2d=np.zeros((CAMS, 2, 17, 3)),
                  det_score=np.zeros((CAMS, 2)), det_valid=np.zeros((CAMS, 2), bool),
                  cam_stamp=np.zeros(CAMS), fb_delay=-np.ones(CAMS))
    assert types.Frame.from_arrays(arrays, "cpu").num_cameras == \
        jax_types.Frame.from_arrays(arrays).num_cameras == CAMS
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        got = types.Persons3D.empty(5, dtype=dtype, device="cpu")
        want = jax_types.Persons3D.empty(5, dtype=jdt)
        for name in types.Persons3D._fields:
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w)
    assert pkg.__version__ == jax_pkg.__version__
    assert pkg.__all__ == jax_pkg.__all__
    for name in pkg.__all__:
        if name != "__version__":
            assert getattr(pkg, name).__name__ == getattr(jax_pkg, name).__name__
    assert pkg.Frame is types.Frame and pkg.TrackerState is types.TrackerState
