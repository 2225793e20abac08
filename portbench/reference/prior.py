"""Skeleton-model smoothing: batched Levenberg-Marquardt over all persons.

Port of the JAX package's prior.py (reference pose_prior node's gtsam
graph, pose_prior_mult_node.cpp): per person, identity-Jacobian 3D priors
on every measured joint (root shrunk by root_sigma_factor^2, :690) and
bone-length range factors (:384-481), optimized by LM from a warm start
(:483-503) with marginals from the final Hessian (:760-767). The normal
equations are solved along the bone tree (ops.tree_solve, `solver="tree"`)
or, as the JAX package's oracle / cross-check path (`solver="dense"`), as
one equilibrated 63 x 63 Cholesky solve per person with the marginals from
the equilibrated inverse (`_solve_dense`, `_marginals_dense`). The JAX
package leaves that factorization to XLA's library call (a Pallas version
was slower and was removed, prior.py:40-48 there); here it is cuSOLVER's,
through torch.linalg.cholesky_ex and torch.cholesky_solve, which check no
error on the host, so the LM still captures.

Frozen copy of the port's `prior.py` on its plain route: the LM is
`_lm_trip` in an eager loop (`ops.loops.while_loop`) on any device and
dtype; kernels L1 and L2 are not used. `LM_RUNS` records each run's
persons and trips.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import skeleton
from portbench.reference.config import PriorConfig
from portbench.reference.ops import linalg, loops, tree_solve
from portbench.reference.types import Persons3D

_K = skeleton.NUM_FUSION_JOINTS
# (persons, persons running at the start, trips summed over the running
# persons) of each LM run, the data-dependent part of kernel L1's work.
LM_RUNS: list = []


class GraphInputs(NamedTuple):
    """Per-person normalized measurement set."""

    meas: torch.Tensor         # [P, K, 3] root-centered, height-normalized
    active: torch.Tensor       # [P, K] bool — joint is measured
    inv_cov: torch.Tensor      # [P, K, 3, 3] whitening information matrices
    bone_active: torch.Tensor  # [P, B] bool
    root_xyz: torch.Tensor     # [P, 3] centering root (base frame)
    root_score: torch.Tensor   # [P]
    neck_score: torch.Tensor   # [P]
    height: torch.Tensor       # [P] normalization scale
    score_out: torch.Tensor    # [P, K] output scores
    num_meas: torch.Tensor     # [P] int32


class PriorResult(NamedTuple):
    x: torch.Tensor         # [P, K, 3] optimized normalized joints
    marg_cov: torch.Tensor  # [P, K, 3, 3] marginal covariances (normalized)
    marg_ok: torch.Tensor   # [P] marginals usable (else default sigma)
    iters: torch.Tensor     # [] int32 LM iterations run


def _safe_inv3(a):
    """Batched 3x3 inverse; singular lanes get the identity."""
    adj, det = linalg.adjugate3(a)
    ok = torch.abs(det) > 1e-30
    inv = adj / torch.where(ok, det, 1.0)[..., None, None]
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape)
    return torch.where(ok[..., None, None], inv, eye)


def build_graph_inputs(persons: Persons3D, cfg: PriorConfig) -> GraphInputs:
    """Root/neck synthesis, height normalization and measurement packing
    (reference :626-741)."""
    dtype = persons.xyz.dtype
    dev = persons.xyz.device
    xyz, score, cov = persons.xyz, persons.score, persons.cov
    p = xyz.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    if cfg.pose_method == "h36m":
        root_xyz = xyz[:, skeleton.MIDHIP]
        root_score = score[:, skeleton.MIDHIP]
        root_cov = cov[:, skeleton.MIDHIP]
        neck_xyz = xyz[:, skeleton.NECK]
        neck_score = score[:, skeleton.NECK]
        neck_cov = cov[:, skeleton.NECK]
    else:
        # Root = hip mean, neck = shoulder mean, when both sides have any
        # score (:637-655).
        lh, rh = skeleton.LHIP, skeleton.RHIP
        ls, rs = skeleton.LSHOULDER, skeleton.RSHOULDER
        have_hips = (score[:, lh] > 0) & (score[:, rh] > 0)
        root_xyz = torch.where(have_hips[:, None], 0.5 * (xyz[:, lh] + xyz[:, rh]), 0.0)
        root_score = torch.where(have_hips, 0.5 * (score[:, lh] + score[:, rh]), 0.0)
        root_cov = 0.5 * (cov[:, lh] + cov[:, rh])
        have_sh = (score[:, ls] > 0) & (score[:, rs] > 0)
        neck_xyz = torch.where(have_sh[:, None], 0.5 * (xyz[:, ls] + xyz[:, rs]), 0.0)
        neck_score = torch.where(have_sh, 0.5 * (score[:, ls] + score[:, rs]), 0.0)
        neck_cov = 0.5 * (cov[:, ls] + cov[:, rs])

    root_ok = root_score > cfg.min_score
    if cfg.normalize_by_height:
        neck_ok = neck_score > cfg.min_score
        h = torch.where(
            neck_ok,
            torch.linalg.vector_norm(neck_xyz - root_xyz, dim=-1),
            cfg.default_height,
        )
        height = torch.where(root_ok, h, 1.0)
    else:
        height = torch.ones((p,), dtype=dtype, device=dev)
    h2 = (height * height)[:, None, None]
    center = root_xyz

    reg = score > cfg.min_score
    reg[:, skeleton.MIDHIP] = False
    if cfg.pose_method != "h36m":
        reg[:, skeleton.NECK] = False
    meas_all = (xyz - center[:, None, :]) / height[:, None, None]
    meas = torch.where(reg[..., None], meas_all, 0.0)
    active = reg.clone()
    cov_n = torch.where(reg[..., None, None], cov / h2[..., None], eye3)
    score_out = torch.where(reg, torch.clamp(score, min=cfg.min_score), 0.0)

    # Root measurement at the origin with shrunken covariance (:690-693).
    rho2 = cfg.root_sigma_factor ** 2
    root_cov_n = root_cov / h2 / rho2
    meas[:, skeleton.MIDHIP] = 0.0
    active[:, skeleton.MIDHIP] = root_ok
    cov_n[:, skeleton.MIDHIP] = torch.where(root_ok[:, None, None], root_cov_n, eye3)
    score_out[:, skeleton.MIDHIP] = torch.where(
        root_ok, torch.clamp(root_score, min=cfg.min_score), 0.0
    )

    # Synthesized neck for the COCO model (:721-737).
    if cfg.pose_method != "h36m":
        neck_ok2 = neck_score > cfg.min_score
        neck_m = (neck_xyz - center) / height[:, None]
        meas[:, skeleton.NECK] = torch.where(neck_ok2[:, None], neck_m, 0.0)
        active[:, skeleton.NECK] = neck_ok2
        cov_n[:, skeleton.NECK] = torch.where(
            neck_ok2[:, None, None], neck_cov / h2, eye3
        )
        score_out[:, skeleton.NECK] = torch.where(
            neck_ok2, torch.clamp(neck_score, min=cfg.min_score), 0.0
        )

    # A person with no valid slot contributes nothing (:739-741).
    active = active & persons.valid[:, None]
    score_out = torch.where(active, score_out, 0.0)
    num_meas = torch.sum(active, dim=-1).to(torch.int32)
    inv_cov = torch.where(active[..., None, None], _safe_inv3(cov_n), eye3)

    # Bone factors: both endpoints measured; the COCO spine bone only when
    # the Belly is unmeasured (:422-423,470-471).
    bi = linalg.constant(skeleton.BONE_I, dev, torch.int64)
    bj = linalg.constant(skeleton.BONE_J, dev, torch.int64)
    bone_active = active[:, bi] & active[:, bj]
    spine = skeleton.SPINE_BONE_IDX
    bone_active[:, spine] = bone_active[:, spine] & ~active[:, skeleton.BELLY]

    return GraphInputs(
        meas=meas, active=active, inv_cov=inv_cov, bone_active=bone_active,
        root_xyz=center, root_score=root_score, neck_score=neck_score,
        height=height, score_out=score_out, num_meas=num_meas,
    )


class _Bones(NamedTuple):
    bi: torch.Tensor
    bj: torch.Tensor
    length: torch.Tensor
    weight: torch.Tensor  # 1 / sigma^2
    inc: torch.Tensor     # [B, K] signed incidence: +1 at bi, -1 at bj


def _bones(cfg: PriorConfig, dtype, device) -> _Bones:
    bone_i, bone_j, length, sigma = skeleton.bone_tables(
        cfg.normalize_by_height, cfg.effective_limb_sigma_factor
    )
    b = np.arange(len(bone_i))
    inc = np.zeros((len(bone_i), _K))
    inc[b, bone_i] += 1.0
    inc[b, bone_j] -= 1.0
    return _Bones(
        linalg.constant(bone_i, device, torch.int64),
        linalg.constant(bone_j, device, torch.int64),
        linalg.constant(length, device, dtype),
        linalg.constant(1.0 / sigma ** 2, device, dtype),
        linalg.constant(inc, device, dtype),
    )


def _residual_terms(x, g_in: GraphInputs, bones: _Bones):
    """Whitened unary residuals, bone directions and residuals, and the
    total error: (w_r [P,K,3], act [P,K], err [P], u [P,B,3], r_b [P,B],
    wb [P,B])."""
    dtype = x.dtype
    r_u = x - g_in.meas
    w_r = linalg.heinsum("pkij,pkj->pki", g_in.inv_cov, r_u)
    act = g_in.active.to(dtype)
    err = 0.5 * torch.sum(act * linalg.heinsum("pki,pki->pk", r_u, w_r), dim=-1)
    d = x[:, bones.bi] - x[:, bones.bj]
    n = torch.linalg.vector_norm(d, dim=-1)
    safe = n > 1e-12
    u = d / torch.where(safe, n, 1.0)[..., None]
    r_b = torch.where(safe, n, 0.0) - bones.length
    wb = g_in.bone_active.to(dtype) * bones.weight
    err = err + 0.5 * torch.sum(wb * r_b * r_b, dim=-1)
    return w_r, act, err, u, r_b, wb


def _linearize_tree(x, g_in: GraphInputs, bones: _Bones):
    """Normal equations in tree-factored form: (hdiag [P,K,3,3] undamped,
    coup [P,B,3,3], g [P,K,3], err [P])."""
    w_r, act, err, u, r_b, wb = _residual_terms(x, g_in, bones)
    g = act[..., None] * w_r
    g_b = (wb * r_b)[..., None] * u
    g = g + linalg.heinsum("bk,pbi->pki", bones.inc, g_b)
    uu = wb[..., None, None] * u[..., :, None] * u[..., None, :]
    hdiag = g_in.inv_cov + linalg.heinsum("bk,pbij->pkij", bones.inc.abs(), uu)
    return hdiag, -uu, g, err


def _linearize(x, g_in: GraphInputs, bones: _Bones):
    """The dense normal equations: (H [P, K, 3, K, 3] undamped, g [P, K, 3],
    err [P]); the same blocks as `_linearize_tree`, laid out in full."""
    w_r, act, err, u, r_b, wb = _residual_terms(x, g_in, bones)
    g = act[..., None] * w_r
    # Diagonal blocks: the information matrices (unmeasured joints keep
    # their unit anchors, so H stays positive definite).
    eye_k = torch.eye(_K, dtype=x.dtype, device=x.device)
    h = linalg.heinsum("kl,pkij->pkilj", eye_k, g_in.inv_cov)
    g_b = (wb * r_b)[..., None] * u
    g = g + linalg.heinsum("bk,pbi->pki", bones.inc, g_b)
    uu = wb[..., None, None] * u[..., :, None] * u[..., None, :]
    h = h + linalg.heinsum("bk,bl,pbij->pkilj", bones.inc, bones.inc, uu)
    return h, g, err


def _spd_solve(h_eq, rhs):
    """Batched SPD solve of the equilibrated system, rhs [P, N, R]: a
    Cholesky factor and two triangular solves, with no error check on the
    host (cholesky_ex), so a capture records it. cuSOLVER is pinned on the
    card: torch may give a batched factorization to MAGMA, which does not
    capture."""
    if h_eq.is_cuda:
        torch.backends.cuda.preferred_linalg_library("cusolver")
    chol, _ = torch.linalg.cholesky_ex(h_eq)
    return torch.cholesky_solve(rhs, chol)


def _equilibrate(h2):
    """Jacobi equilibration S H S of [P, N, N] with S = diag(1 / sqrt(H_ii)):
    the root's shrunk covariance puts its information ~1e8 above the unit
    anchors', a condition number beyond float32 unscaled. Returns (S H S,
    the diagonal of S)."""
    sc = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(h2, dim1=-2, dim2=-1), min=1e-30))
    return h2 * sc[:, :, None] * sc[:, None, :], sc


def _solve_dense(x, lam, g_in: GraphInputs, bones: _Bones):
    """The damped LM step from the dense equations (JAX prior.py:405-421)."""
    p = x.shape[0]
    n = 3 * _K
    h, g, _ = _linearize(x, g_in, bones)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    h_eq, sc = _equilibrate(h.reshape(p, n, n) + lam[:, None, None] * eye)
    delta = sc * _spd_solve(h_eq, (-g.reshape(p, n) * sc)[..., None])[..., 0]
    return delta.reshape(p, _K, 3)


def _marginals_dense(x, g_in: GraphInputs, bones: _Bones, bad):
    """The marginal blocks from the equilibrated inverse of the undamped
    Hessian, H^-1 = S (S H S)^-1 S (JAX prior.py:499-519): (marg [P, K, 3,
    3], marg_ok [P]); a person whose inverse is not finite gets identity
    blocks and marg_ok False."""
    p = x.shape[0]
    n = 3 * _K
    h, _, _ = _linearize(x, g_in, bones)
    h_eq, sc = _equilibrate(h.reshape(p, n, n))
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    cov = _spd_solve(h_eq, eye.expand(p, n, n)) * sc[:, :, None] * sc[:, None, :]
    marg_ok = torch.isfinite(cov.reshape(p, -1)).all(dim=-1) & ~bad
    cov = torch.where(marg_ok[:, None, None], cov, eye)
    k = torch.arange(_K, device=x.device)
    return cov.reshape(p, _K, 3, _K, 3)[:, k, :, k, :].transpose(0, 1), marg_ok


def _solve_tree(x, lam, g_in: GraphInputs, bones: _Bones, eye3):
    """The damped LM step along the bone tree."""
    hdiag, coup, g, _ = _linearize_tree(x, g_in, bones)
    damped = hdiag + lam[:, None, None, None] * eye3
    return tree_solve.tree_solve_levels(damped, coup, g_in.bone_active, -g)[0]


def _lm_trip(carry, g_in: GraphInputs, bones: _Bones, eye3, cfg: PriorConfig):
    """One LM iteration over every person: carry (x, err, lam, done, iters)
    in, the next carry out. Finished persons stay frozen: `x` and `err` move
    only where `accept & ~done` and `lam` only where `~done`, so a trip
    after every person is done returns its carry bit for bit. `iters` counts
    the trips that started with a person still running (JAX's count)."""
    x, err, lam, done, iters = carry
    iters = iters + (~done.all()).to(torch.int32)
    if cfg.solver == "dense":
        delta = _solve_dense(x, lam, g_in, bones)
    else:
        delta = _solve_tree(x, lam, g_in, bones, eye3)
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    x_new = x + delta
    err_new = _residual_terms(x_new, g_in, bones)[2]
    accept = (err_new < err) & torch.isfinite(err_new)
    dec = err - err_new
    # Converged when the attempted step barely changes the error, in
    # either direction (gtsam checkConvergence semantics).
    conv = torch.isfinite(err_new) & (
        (torch.abs(dec) <= cfg.lm_absolute_error_tol)
        | (torch.abs(dec) <= cfg.lm_relative_error_tol * err)
    )
    take = accept & ~done
    x = torch.where(take[:, None, None], x_new, x)
    err = torch.where(take, err_new, err)
    lam_next = torch.where(
        accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor
    )
    lam = torch.where(done, lam, lam_next)
    done = done | conv | (lam > cfg.lm_lambda_upper)
    return x, err, lam, done, iters


def optimize(g_in: GraphInputs, warm_start, cfg: PriorConfig) -> PriorResult:
    """Batched LM over all persons (reference :746-767).

    warm_start: [P, K, 3] initial state (previous track estimate where the
    joint persisted, else the measurement). The iteration stops when every
    person is done or after lm_max_iterations (`loops.while_loop`: a host
    test per iteration eagerly, a WHILE node in a CUDA graph); `iters`
    counts the trips run.
    """
    p = g_in.meas.shape[0]
    carry, bones = _lm_start(g_in, warm_start, cfg)
    eye3 = torch.eye(3, dtype=g_in.meas.dtype, device=g_in.meas.device)
    trips = [0]

    def trip(c):
        trips[0] += int((~c[3]).sum())
        return _lm_trip(c, g_in, bones, eye3, cfg)

    x, _, _, _, iters = loops.while_loop(
        lambda c: ~c[3].all(), trip, carry, cfg.lm_max_iterations,
    )
    LM_RUNS.append((p, int((~carry[3]).sum()), trips[0]))

    # Optimization failure falls back to the raw measurements (:748-758).
    bad = ~torch.isfinite(x.reshape(p, -1)).all(dim=-1)
    x = torch.where(bad[:, None, None], g_in.meas, x)

    # Marginals: diagonal blocks of the inverse undamped Hessian (:760-767).
    if cfg.solver == "dense":
        marg, marg_ok = _marginals_dense(x, g_in, bones, bad)
        return PriorResult(x=x, marg_cov=marg, marg_ok=marg_ok, iters=iters)
    hdiag_f, coup_f, _, _ = _linearize_tree(x, g_in, bones)
    _, marg = tree_solve.tree_solve_levels(
        hdiag_f, coup_f, g_in.bone_active, torch.zeros_like(x), want_sigma=True
    )
    marg_ok = torch.isfinite(marg.reshape(p, -1)).all(dim=-1) & ~bad
    marg = torch.where(marg_ok[:, None, None, None], marg, eye3)
    return PriorResult(x=x, marg_cov=marg, marg_ok=marg_ok, iters=iters)


def _lm_start(g_in: GraphInputs, warm_start, cfg: PriorConfig):
    """The LM's first carry (x, err, lam, done, iters) and the bone tables."""
    dtype = g_in.meas.dtype
    dev = g_in.meas.device
    bones = _bones(cfg, dtype, dev)
    x = torch.where(g_in.active[..., None], warm_start, 0.0)
    carry = (
        x,
        _residual_terms(x, g_in, bones)[2],
        torch.full((x.shape[0],), cfg.lm_initial_lambda, dtype=dtype, device=dev),
        g_in.num_meas == 0,  # persons without measurements are skipped
        torch.zeros((), dtype=torch.int32, device=dev),
    )
    return carry, bones


def denormalize(result: PriorResult, g_in: GraphInputs, cfg: PriorConfig):
    """Map optimized joints/covariances back to the base frame (:774-816)."""
    dtype = result.x.dtype
    h = g_in.height[:, None, None]
    xyz = result.x * h + g_in.root_xyz[:, None, :]
    h2 = (g_in.height ** 2)[:, None, None, None]
    cov = result.marg_cov * h2
    default = cfg.default_res_sigma ** 2 * torch.eye(3, dtype=dtype, device=xyz.device)
    cov = torch.where(result.marg_ok[:, None, None, None], cov, default)
    # Root covariance re-inflated by the pinning factor (:813-814).
    cov[:, skeleton.MIDHIP] = cov[:, skeleton.MIDHIP] * (cfg.root_sigma_factor ** 2)
    return xyz, cov
