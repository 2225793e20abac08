"""Kernel F1's arithmetic against the JAX package: F1's host build (the
kernel's source compiled for the CPU, which the card's kernel equals bit
for bit) and the JAX package's fusion.triangulate_hypotheses (XLA on the
CPU) on the same hypotheses: those of the golden demo scenes' first 16
frames as the port's fusion hands them to the triangulation, and seeded
hypotheses of the wider halls that F1's wide variant takes (92, 120 and
480 cameras, with leave-one-out and three-view drops). Every
decision (person validity, joint score > 0) is the JAX package's in
float32. xyz, score and covariance are no further from the JAX package in
float64 than its float32 is: twice over in the root mean square, four
times at the worst entry (a covariance entry is a sum of sigma-point
scatters that cancel, whose rounding the order of the sum decides), at 16
cameras. Past them both factors grow as the square root of C / 16: F1
sums over views in PyTorch's CPU order (chains of multiply-adds, up to
5 x 64 terms in the UT's base product), whose rounding grows as a random
walk over the terms, XLA's in a tree (at 92 cameras the covariance's rms
reads 2.55 times the JAX float32's, at 120 the score's worst entry 4.19
times, three and a half float32 ulps). The
JAX package is a second witness beside the port's plain body
(test_torch_triangulation_kernel.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import config as jax_config
from smartedgesensor3dhumanpose_tpu import fusion as jax_fusion
from smartedgesensor3dhumanpose_tpu_torch.ops import triangulation_kernel as tk
from test_torch_triangulation_kernel import CASES, WIDE_CAMERAS, hypotheses, wide_hypotheses

pytestmark = pytest.mark.torch_port


def _jax_triangulate(flat, pose: str, dtype):
    """The JAX package's triangulation of the port's hypotheses `flat`, in
    `dtype`, as numpy arrays (xyz, score, cov, valid)."""
    cfg = jax_config.PipelineConfig.demo_16cam().fusion
    n, c = flat.cam_mask.shape
    cfg = dataclasses.replace(cfg, pose_method=pose, num_cameras=c)
    rig = jax_cameras.hall_rig(c, dtype=dtype)
    hyps = jax_fusion.HypothesisSet(
        kp=jnp.asarray(flat.kp.numpy(), dtype=dtype),
        cov=jnp.asarray(flat.cov.numpy(), dtype=dtype),
        cam_mask=jnp.asarray(flat.cam_mask.numpy()),
        obs_score=jnp.zeros((n, c), dtype=dtype),
        n_hyp=jnp.int32(n),
        n_dropped=jnp.int32(0),
    )
    out = jax.jit(lambda h: jax_fusion.triangulate_hypotheses(h, rig, cfg))(hyps)
    return rig, {k: np.asarray(getattr(out, k)) for k in ("xyz", "score", "cov", "valid")}


def _hypotheses(case):
    """(hypotheses, rig, config, pose) of a golden scene's (scene, pose) or
    of a wide hall's camera count."""
    if isinstance(case, int):
        return (*wide_hypotheses(case, seed=case), "simple")
    scene, pose = case
    return (*hypotheses(scene, pose, torch.float32), pose)


@pytest.mark.parametrize("case", CASES + WIDE_CAMERAS,
                         ids=lambda c: "-".join(c) if isinstance(c, tuple) else str(c))
def test_host_build_matches_jax(case):
    flat, rig, cfg, pose = _hypotheses(case)
    jrig, want = _jax_triangulate(flat, pose, jnp.float32)
    np.testing.assert_array_equal(np.asarray(jrig.P), rig.P.numpy())
    np.testing.assert_array_equal(np.asarray(jrig.F), rig.F.numpy())
    _, want64 = _jax_triangulate(flat, pose, jnp.float64)
    got = tk.triangulate(flat.kp, flat.cov, flat.cam_mask, rig.P, rig.F, cfg, host=True)
    what = str(case)
    grow = np.sqrt(max(flat.cam_mask.shape[1], 16) / 16)
    np.testing.assert_array_equal(got.valid.numpy(), want["valid"], err_msg=what)
    np.testing.assert_array_equal(got.score.numpy() > 0, want["score"] > 0, err_msg=what)
    assert got.valid.any() and (got.score > 0).any()
    for name in ("xyz", "score", "cov"):
        mine = getattr(got, name).numpy().astype(np.float64) - want64[name]
        ref = want[name].astype(np.float64) - want64[name]
        rms_mine, rms_ref = np.sqrt(np.mean(mine ** 2)), np.sqrt(np.mean(ref ** 2))
        assert rms_mine <= 2 * grow * rms_ref, \
            f"{what} {name} rms: {rms_mine:.3e} > {2 * grow:.2f} x {rms_ref:.3e}"
        worst_mine, worst_ref = np.abs(mine).max(), np.abs(ref).max()
        assert worst_mine <= 4 * grow * worst_ref, \
            f"{what} {name}: {worst_mine:.3e} > {4 * grow:.2f} x {worst_ref:.3e}"
