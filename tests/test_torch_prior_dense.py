"""The port's dense LM solver (prior.py, `PriorConfig.solver="dense"`)
against the JAX package's dense solver and against the port's tree solver.

The dense path assembles the full [P, 63, 63] normal equations, solves the
equilibrated system by a Cholesky factor and takes the marginals from the
equilibrated inverse, as JAX's oracle / cross-check path does. On the same
numpy inputs, in float64 the two packages agree to 1e-9 (measured ~2e-15 on
the joints). In float32 the factorizations round differently (LAPACK in
both, other blockings): the budget is 4e-6 on the normalized joints and
1e-6 on the marginal blocks (measured up to 8.5e-7 and 1.4e-7). The tree
and dense solvers solve the same equations, so on the golden scenes' fused
persons they agree within the same budgets; on the adversarial scene's
ghosts the float32 LM does not converge within its 32 iterations and its
result depends on the order of summation (ROADMAP C2), so that scene is
compared in float64.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import prior as jax_prior
from smartedgesensor3dhumanpose_tpu.config import PriorConfig as JaxPriorConfig
from smartedgesensor3dhumanpose_tpu.types import Persons3D as JaxPersons3D
from smartedgesensor3dhumanpose_tpu_torch import cameras, config, fusion, pipeline, prior, skeleton
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.types import Frame, Persons3D

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_golden_demo16.npz")
F64_TOL = 1e-9
F32_X_TOL = 4e-6
F32_MARG_TOL = 1e-6


def _persons(rng, dtype, p=4):
    k = skeleton.NUM_FUSION_JOINTS
    xyz = rng.normal(size=(p, k, 3)) * 0.3 + np.array([0.0, 0.0, 1.0])
    score = np.where(rng.uniform(size=(p, k)) < 0.85, rng.uniform(0.2, 0.9, (p, k)), 0.0)
    a = rng.normal(size=(p, k, 3, 3))
    cov = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(3)) * 1e-4
    valid = np.array([True, True, False, True])[:p]
    return xyz.astype(dtype), score.astype(dtype), cov.astype(dtype), valid


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("normalize_by_height", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_lm_matches_jax(seed, normalize_by_height, dtype):
    rng = np.random.default_rng(seed)
    xyz, score, cov, valid = _persons(rng, dtype)
    jcfg = JaxPriorConfig(normalize_by_height=normalize_by_height, solver="dense")
    tcfg = config.PriorConfig(normalize_by_height=normalize_by_height, solver="dense")
    jp = JaxPersons3D(jnp.asarray(xyz), jnp.asarray(score), jnp.asarray(cov),
                      jnp.asarray(valid), -jnp.ones(4, jnp.int32))
    tp = Persons3D(torch.from_numpy(xyz), torch.from_numpy(score), torch.from_numpy(cov),
                   torch.from_numpy(valid), torch.full((4,), -1, dtype=torch.int32))
    jg = jax.jit(jax_prior.build_graph_inputs, static_argnums=1)(jp, jcfg)
    tg = prior.build_graph_inputs(tp, tcfg)
    noise = rng.normal(size=tg.meas.shape).astype(dtype)
    warm = tg.meas + 0.01 * torch.from_numpy(noise) * tg.active[..., None]
    want = jax.jit(jax_prior.optimize, static_argnums=2)(jg, jnp.asarray(warm.numpy()), jcfg)
    got = prior.optimize(tg, warm, tcfg)
    assert int(got.iters) == int(want.iters)
    np.testing.assert_array_equal(got.marg_ok.numpy(), np.asarray(want.marg_ok))
    x_tol, marg_tol = (F64_TOL, F64_TOL) if dtype == np.float64 else (F32_X_TOL, F32_MARG_TOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=x_tol)
    np.testing.assert_allclose(got.marg_cov.numpy(), np.asarray(want.marg_cov), rtol=0,
                               atol=marg_tol)
    # The default-sigma fallback is reached through marg_ok, as in JAX.
    xyz_d, cov_d = prior.denormalize(got, tg, tcfg)
    want_d = jax.jit(jax_prior.denormalize, static_argnums=2)(want, jg, jcfg)
    np.testing.assert_allclose(xyz_d.numpy(), np.asarray(want_d[0]), rtol=0, atol=x_tol)


def _golden_persons(scene, dtype):
    """The fused persons of four frames of a golden demo scene."""
    kw = json.loads(str(np.load(GOLDEN)[f"{scene}/scene"]))
    data = synthetic.pad_detections(
        synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw)),
                                    np.float64 if dtype == torch.float64 else np.float32),
        config.FusionConfig().max_dets_per_cam,
    )
    cfg = config.PipelineConfig.demo_16cam()
    rig = cameras.hall_rig(16, dtype=dtype, device="cpu")
    out = []
    for t in (8, 24, 40, 56):
        frame, _ = pipeline.mask_stale_cameras(
            Frame.from_arrays({k: v[t] for k, v in data.items()}, "cpu"),
            cfg.fusion.max_sync_diff,
        )
        out.append(fusion.fuse_frame(frame, rig, cfg.fusion))
    return Persons3D(*(torch.cat(x) for x in zip(*out)))


@pytest.mark.parametrize("scene,dtype", [
    ("benign", torch.float32), ("benign", torch.float64), ("adversarial", torch.float64),
])
def test_dense_equals_tree_on_golden_persons(scene, dtype):
    persons = _golden_persons(scene, dtype)
    assert int(persons.valid.sum()) > 0
    cfg = config.PriorConfig()
    g = prior.build_graph_inputs(persons, cfg)
    tree = prior.optimize(g, g.meas, cfg)
    dense = prior.optimize(g, g.meas, config.PriorConfig(solver="dense"))
    assert int(tree.iters) == int(dense.iters)
    assert torch.equal(tree.marg_ok, dense.marg_ok)
    x_tol, marg_tol = (F64_TOL, F64_TOL) if dtype == torch.float64 else (F32_X_TOL, F32_MARG_TOL)
    on = g.active
    np.testing.assert_allclose(dense.x[on].numpy(), tree.x[on].numpy(), rtol=0, atol=x_tol)
    np.testing.assert_allclose(dense.marg_cov[on].numpy(), tree.marg_cov[on].numpy(),
                               rtol=0, atol=marg_tol)
