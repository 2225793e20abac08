"""The skeleton prior's LM and tree marginals: kernels L1 and L2 and their
plain PyTorch twins.

The JAX package runs each Levenberg-Marquardt iteration of the skeleton
prior (`prior.py:438-461` there) as the body of one `lax.while_loop`, and
XLA fuses that body into a handful of kernels. This module is the port's
counterpart on the card (csrc/lm_prior.cu); it ports no `pallas_call`.

* `lm_solve` (L1): one launch runs the whole LM for every person, in place
  on the carry (x, err, lam, done, iters, running, scratch): each person's
  warp runs trips (linearise along the bone tree, damp, eliminate the tree
  levels deepest first and back-substitute, take the step with non-finite
  components 0, evaluate the new error and apply `prior._lm_trip`'s
  accept, convergence, lambda and freeze rules) until it is done or `iters`
  reaches `max_trips`. Persons are independent and a finished one is
  frozen, so this ends bit for bit where the loop of single trips ends:
  `iters` gains the trips that loop runs (the most any person ran) and
  `running` becomes "some person is not done". `scratch` (int32 [2], zero)
  carries the count across the launch's blocks and is zero again when the
  launch ends. `lm_trip` is the same kernel capped at one trip.
* `lm_marginals` (L2): one launch computes, at the final x, the
  non-finite fallback to the measurements, the undamped tree linearisation,
  the forward elimination and the sparse-inverse sweep (the diagonal
  blocks of H^-1), `marg_ok` and the identity fallback (`prior.optimize`'s
  tail).

`lm_trip_plain`, `lm_solve_plain` (the trip in a loop that stops as the
kernel does) and `lm_marginals_plain` are the twins: PyTorch in the
kernels' own order of summation (3x3 components, joints and bones in fixed
order, each parent's children added in the level's bone order; the tables
below), so the card holds each kernel to its twin bit for bit. The CPU
tests hold the twins to `prior._lm_trip`, to `tree_solve_levels` and to the
JAX package. The wrappers take the twins for CPU tensors only; for CUDA
tensors they launch the kernel (float32, else TypeError) or raise.

The twins, like the kernels, take at most one active bone per child joint
in a level (the neck's two parents: `build_graph_inputs` gates the spine
bone on an unmeasured belly).
"""

from __future__ import annotations

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch import _kernels, skeleton, tracing
from smartedgesensor3dhumanpose_tpu_torch.ops import linalg, tree_solve

K_JOINTS = skeleton.NUM_FUSION_JOINTS
N_BONES = skeleton.NUM_BONES
BONE_I = skeleton.BONE_I.astype(np.int64)
BONE_J = skeleton.BONE_J.astype(np.int64)
# Bones grouped by the depth of their child joint, deepest first.
LEVELS = tuple(tuple(int(b) for b in lvl) for lvl in tree_solve.LEVELS)

# No cap on `iters` (lm_trip's single trip).
_NO_CAP = 2**31 - 1


def _incidence():
    """Each joint's bones in ascending order, with the joint's sign in the
    bone (+1 at BONE_I, -1 at BONE_J): CSR start [K + 1], bone [2B], sign
    [2B]."""
    start, bone, sign = [0], [], []
    for k in range(K_JOINTS):
        for b in range(N_BONES):
            if BONE_I[b] == k:
                bone.append(b)
                sign.append(1.0)
            elif BONE_J[b] == k:
                bone.append(b)
                sign.append(-1.0)
        start.append(len(bone))
    return np.array(start), np.array(bone), np.array(sign)


INC_START, INC_BONE, INC_SIGN = _incidence()
MAX_DEGREE = int(np.diff(INC_START).max())


def sibling_orders() -> dict:
    """{(level, parent joint): its bones in the order their eliminations
    are added into the parent} for every parent with several children in
    one level (the order the twins and the kernels share)."""
    out = {}
    for lv, bones in enumerate(LEVELS):
        for b in bones:
            out.setdefault((lv, int(BONE_I[b])), []).append(b)
    return {k: tuple(v) for k, v in out.items() if len(v) > 1}


def cuda_tables() -> dict:
    """The topology tables csrc/lm_prior.cu holds as constants, by their
    names there (tests pin the source to these)."""
    starts = np.cumsum([0] + [len(lvl) for lvl in LEVELS])
    return {
        "c_bone_i": BONE_I.tolist(), "c_bone_j": BONE_J.tolist(),
        "c_level_start": starts.tolist(),
        "c_level_bone": [b for lvl in LEVELS for b in lvl],
        "c_inc_start": INC_START.tolist(), "c_inc_bone": INC_BONE.tolist(),
        "c_inc_sign": INC_SIGN.tolist(),
    }


# ------------------------------------------------------------ the twins --
# Fixed-order 3-vector and 3x3 algebra: each entry is ((t0 + t1) + t2) of
# its products, as the kernels' loops sum them.

def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _mv3(m, v):
    """[..., 3, 3] @ [..., 3]."""
    return _dot3(m, v[..., None, :])


def _mm3(a, b):
    """[..., 3, 3] @ [..., 3, 3]."""
    return (a[..., :, 0, None] * b[..., None, 0, :] + a[..., :, 1, None] * b[..., None, 1, :]
            ) + a[..., :, 2, None] * b[..., None, 2, :]


def _mmt3(a, b):
    """a @ b^T of [..., 3, 3]."""
    return _dot3(a[..., :, None, :], b[..., None, :, :])


def _inv3(m):
    """The adjugate over the determinant, the determinant 1 where
    |det| <= 1e-30 (tree_solve._inv3)."""
    adj, det = linalg.adjugate3(m)
    return adj / torch.where(torch.abs(det) > 1e-30, det, 1.0)[..., None, None]


def _sum_seq(v):
    """[P, N] -> [P], summed in index order."""
    s = v[:, 0]
    for i in range(1, v.shape[1]):
        s = s + v[:, i]
    return s


def _bone_terms(x, bone_active, bone_len, bone_w):
    """Bone directions, residuals and weights at x: (u [P,B,3], r_b, wb)."""
    dev = x.device
    d = x[:, linalg.constant(BONE_I, dev)] - x[:, linalg.constant(BONE_J, dev)]
    n = torch.sqrt(_dot3(d, d))
    safe = n > 1e-12
    u = d / torch.where(safe, n, 1.0)[..., None]
    r_b = torch.where(safe, n, 0.0) - bone_len
    wb = bone_active.to(x.dtype) * bone_w
    return u, r_b, wb


def _error(x, meas, active, inv_cov, bone_active, bone_len, bone_w):
    """The total error 0.5 (sum of whitened unary terms + sum of bone
    terms), each sum in index order."""
    r = x - meas
    e_u = active.to(x.dtype) * _dot3(r, _mv3(inv_cov, r))
    _, r_b, wb = _bone_terms(x, bone_active, bone_len, bone_w)
    return 0.5 * _sum_seq(e_u) + 0.5 * _sum_seq((wb * r_b) * r_b)


def _incident_sums(g_b, uu):
    """Per joint, its bones' gradients (signed) and blocks added in
    ascending bone order from 0: ([P, K, 3], [P, K, 3, 3])."""
    dev = g_b.device
    p = g_b.shape[0]
    acc_g = torch.zeros((p, K_JOINTS, 3), dtype=g_b.dtype, device=dev)
    acc_h = torch.zeros((p, K_JOINTS, 3, 3), dtype=g_b.dtype, device=dev)
    deg = np.diff(INC_START)
    for s in range(MAX_DEGREE):
        has = deg > s
        slot = np.where(has, INC_START[:-1] + s, 0)
        bone = linalg.constant(INC_BONE[slot], dev)
        sign = linalg.constant(np.where(has, INC_SIGN[slot], 0.0), dev, g_b.dtype)
        on = linalg.constant(has, dev)
        acc_g = torch.where(on[:, None], acc_g + sign[:, None] * g_b[:, bone], acc_g)
        acc_h = torch.where(on[:, None, None], acc_h + uu[:, bone], acc_h)
    return acc_g, acc_h


def _linearize(x, meas, active, inv_cov, bone_active, bone_len, bone_w):
    """The tree-factored normal equations at x: (hdiag [P,K,3,3] undamped,
    uu [P,B,3,3] (the coupling is -uu), g [P,K,3])."""
    r = x - meas
    g_u = active.to(x.dtype)[..., None] * _mv3(inv_cov, r)
    u, r_b, wb = _bone_terms(x, bone_active, bone_len, bone_w)
    g_b = (wb * r_b)[..., None] * u
    uu = (wb[..., None] * u)[..., :, None] * u[..., None, :]
    acc_g, acc_h = _incident_sums(g_b, uu)
    return inv_cov + acc_h, uu, g_u + acc_g


def _eliminate(d, r, uu, bone_active):
    """Forward elimination over LEVELS, deepest first, in place on the
    lists of per-joint blocks d [K] x [P,3,3] and r [K] x [P,3] (r may be
    None); each parent takes its children's updates in the level's bone
    order."""
    for lvl in LEVELS:
        idx = linalg.constant(np.array(lvl), uu.device)
        c_m = torch.where(bone_active[:, idx, None, None], -uu[:, idx], 0.0)
        kids = torch.stack([d[int(BONE_J[b])] for b in lvl], dim=1)
        cdinv = _mm3(c_m, _inv3(kids))
        upd_d = -_mm3(cdinv, c_m)
        upd_r = None
        if r is not None:
            upd_r = -_mv3(cdinv, torch.stack([r[int(BONE_J[b])] for b in lvl], dim=1))
        for j, b in enumerate(lvl):
            p = int(BONE_I[b])
            d[p] = d[p] + upd_d[:, j]
            if r is not None:
                r[p] = r[p] + upd_r[:, j]


def _back_substitute(d_inv, r, uu, bone_active):
    """Roots' solution, then the levels shallow to deep: x [P, K, 3]."""
    x = list(_mv3(d_inv, r).unbind(1))
    for lvl in LEVELS[::-1]:
        idx = linalg.constant(np.array(lvl), uu.device)
        on = bone_active[:, idx]
        c_m = torch.where(on[..., None, None], -uu[:, idx], 0.0)
        par = torch.stack([x[int(BONE_I[b])] for b in lvl], dim=1)
        kid = [int(BONE_J[b]) for b in lvl]
        xc = _mv3(d_inv[:, kid], r[:, kid] - _mv3(c_m, par))
        for j, c in enumerate(kid):
            x[c] = torch.where(on[:, j, None], xc[:, j], x[c])
    return torch.stack(x, dim=1)


def _sigma_sweep(d_inv, uu, bone_active):
    """Diagonal blocks of H^-1 from the eliminated blocks' inverses:
    [P, K, 3, 3]."""
    sigma = list(d_inv.unbind(1))
    for lvl in LEVELS[::-1]:
        idx = linalg.constant(np.array(lvl), uu.device)
        on = bone_active[:, idx]
        c_m = torch.where(on[..., None, None], -uu[:, idx], 0.0)
        par = torch.stack([sigma[int(BONE_I[b])] for b in lvl], dim=1)
        kid = [int(BONE_J[b]) for b in lvl]
        k_m = _mm3(d_inv[:, kid], c_m)
        s_c = d_inv[:, kid] + _mmt3(_mm3(k_m, par), k_m)
        for j, c in enumerate(kid):
            sigma[c] = torch.where(on[:, j, None, None], s_c[:, j], sigma[c])
    return torch.stack(sigma, dim=1)


def lm_trip_plain(carry, meas, active, inv_cov, bone_active, bone_len, bone_w, cfg):
    """L1's twin: the next carry (new tensors; `scratch` passed through).
    carry = (x [P,K,3], err [P], lam [P], done [P] bool, iters [] int32,
    running [] bool, scratch [2] int32); cfg a PriorConfig."""
    x, err, lam, done, iters, running, scratch = carry
    hdiag, uu, g = _linearize(x, meas, active, inv_cov, bone_active, bone_len, bone_w)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    damped = hdiag + lam[:, None, None, None] * eye
    d = list(damped.unbind(1))
    r = list((-g).unbind(1))
    _eliminate(d, r, uu, bone_active)
    d_inv = _inv3(torch.stack(d, dim=1))
    delta = _back_substitute(d_inv, torch.stack(r, dim=1), uu, bone_active)
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    x_new = x + delta
    err_new = _error(x_new, meas, active, inv_cov, bone_active, bone_len, bone_w)

    finite = torch.isfinite(err_new)
    accept = (err_new < err) & finite
    dec = err - err_new
    conv = finite & ((torch.abs(dec) <= cfg.lm_absolute_error_tol)
                     | (torch.abs(dec) <= cfg.lm_relative_error_tol * err))
    take = accept & ~done
    x = torch.where(take[:, None, None], x_new, x)
    err = torch.where(take, err_new, err)
    # A tensor divisor: torch divides a CUDA tensor by a Python scalar as
    # a product with its reciprocal, the kernel divides.
    lam_next = torch.where(accept, lam / torch.full_like(lam, cfg.lm_lambda_factor),
                           lam * cfg.lm_lambda_factor)
    lam = torch.where(done, lam, lam_next)
    done = done | conv | (lam > cfg.lm_lambda_upper)
    iters = iters + running.to(torch.int32)
    running = ~done.all()
    return x, err, lam, done, iters, running, scratch


def lm_solve_plain(carry, meas, active, inv_cov, bone_active, bone_len, bone_w, cfg,
                   max_trips=None):
    """L1's twin over a whole LM: `lm_trip_plain` while some person runs and
    `iters` is below `max_trips` (default cfg.lm_max_iterations), as the
    kernel stops; the last carry (new tensors)."""
    cap = cfg.lm_max_iterations if max_trips is None else max_trips
    for _ in range(max(0, cap - int(carry[4]))):
        if not bool(carry[5]):
            break
        carry = lm_trip_plain(carry, meas, active, inv_cov, bone_active, bone_len, bone_w, cfg)
    return carry


def lm_marginals_plain(x, meas, active, inv_cov, bone_active, bone_len, bone_w):
    """L2's twin: (x [P,K,3] with non-finite persons back at their
    measurements, marg [P,K,3,3], marg_ok [P])."""
    p = x.shape[0]
    bad = ~torch.isfinite(x.reshape(p, -1)).all(dim=-1)
    x = torch.where(bad[:, None, None], meas, x)
    hdiag, uu, _ = _linearize(x, meas, active, inv_cov, bone_active, bone_len, bone_w)
    d = list(hdiag.unbind(1))
    _eliminate(d, None, uu, bone_active)
    sigma = _sigma_sweep(_inv3(torch.stack(d, dim=1)), uu, bone_active)
    marg_ok = torch.isfinite(sigma.reshape(p, -1)).all(dim=-1) & ~bad
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    return x, torch.where(marg_ok[:, None, None, None], sigma, eye), marg_ok


# ------------------------------------------------------------ the kernels --

def takes(t: torch.Tensor, solver: str) -> bool:
    """Whether `prior.optimize` runs L1 and L2 for these tensors: the tree
    solver on CUDA (where a float64 input then raises)."""
    return solver == "tree" and t.is_cuda


def _check(name: str, tensors) -> None:
    for t in tensors:
        if t.dtype.is_floating_point and t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel {name} takes float32, got {t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"{name}: every tensor must lie on CUDA, got {t.device}")


def _launch(name, carry, inputs, cfg, max_trips: int, max_iters: int) -> None:
    """L1 on CUDA tensors, in place on the carry. While a CUDA graph is
    captured with a tracer recording (tracing.py), the launch gives it a
    trip record as a WHILE node does: the trips its last replay ran and the
    device clock at its start (stamps[0]) and end (stamps[trips])."""
    x, err, lam, done, iters, running, scratch = carry
    inputs = [t.contiguous() for t in inputs]
    _check(name, list(carry) + inputs)
    for t, field in ((x, "x"), (err, "err"), (lam, "lam"), (done, "done")):
        if not t.is_contiguous():
            raise ValueError(f"{name} updates {field} in place: it must be contiguous")
    if scratch.dtype != torch.int32 or scratch.numel() != 2:
        raise ValueError(f"{name}: scratch must be int32 [2]")
    p = x.shape[0]
    if p == 0:
        return
    log_trips = log_stamps = None
    tracer = tracing.active()
    if tracer is not None and linalg.capturing(x):
        # L1 writes both on every launch (its trips, stamps[0] and
        # stamps[trips]); `empty` adds no node to the graph.
        log_trips = torch.empty((), dtype=torch.int32, device=x.device)
        log_stamps = torch.empty(min(max_trips, max_iters) + 1, dtype=torch.int64,
                                 device=x.device)
        tracer.loop(log_trips, log_stamps, "lm")
    _kernels.launch(
        "lm_trip", "ses3d_lm_trip", x.device,
        x.data_ptr(), err.data_ptr(), lam.data_ptr(), done.data_ptr(), iters.data_ptr(),
        running.data_ptr(), scratch.data_ptr(), *(t.data_ptr() for t in inputs), p,
        max_trips, max_iters, float(cfg.lm_lambda_factor), float(cfg.lm_lambda_upper),
        float(cfg.lm_absolute_error_tol), float(cfg.lm_relative_error_tol),
        None if log_trips is None else log_trips.data_ptr(),
        None if log_stamps is None else log_stamps.data_ptr(),
        what=f"{name} launch (P = {p})")


def lm_solve(carry, meas, active, inv_cov, bone_active, bone_len, bone_w, cfg, max_trips=None):
    """The whole LM for every person (see the module docstring): trips until
    every person is done or `iters` reaches `max_trips` (default
    cfg.lm_max_iterations). CPU tensors go to the twin, which returns a new
    carry; CUDA tensors to one launch of L1, which updates the carry in
    place and returns it, with no host sync."""
    cap = cfg.lm_max_iterations if max_trips is None else max_trips
    if carry[0].device.type == "cpu":
        return lm_solve_plain(carry, meas, active, inv_cov, bone_active, bone_len, bone_w, cfg, cap)
    _launch("lm_solve", carry, (meas, active, inv_cov, bone_active, bone_len, bone_w), cfg, cap,
            cap)
    return carry


def lm_trip(carry, meas, active, inv_cov, bone_active, bone_len, bone_w, cfg):
    """One LM iteration for every person: L1 capped at one trip, with no cap
    on `iters`. CPU tensors go to the twin, which returns a new carry; CUDA
    tensors to L1, which updates the carry in place and returns it."""
    if carry[0].device.type == "cpu":
        return lm_trip_plain(carry, meas, active, inv_cov, bone_active, bone_len, bone_w, cfg)
    _launch("lm_trip", carry, (meas, active, inv_cov, bone_active, bone_len, bone_w), cfg, 1,
            _NO_CAP)
    return carry


def lm_marginals(x, meas, active, inv_cov, bone_active, bone_len, bone_w):
    """`prior.optimize`'s tail at the final x: (x, marg, marg_ok) as
    `lm_marginals_plain` gives them; L2 for CUDA tensors, the twin for CPU
    ones."""
    if x.device.type == "cpu":
        return lm_marginals_plain(x, meas, active, inv_cov, bone_active, bone_len, bone_w)
    inputs = [x.contiguous(), meas.contiguous(), inv_cov.contiguous(),
              bone_active.contiguous(), bone_len.contiguous(), bone_w.contiguous()]
    _check("lm_marginals", inputs)
    p = x.shape[0]
    x_out = torch.empty_like(inputs[0])
    marg = torch.empty((p, K_JOINTS, 3, 3), dtype=x.dtype, device=x.device)
    marg_ok = torch.empty((p,), dtype=torch.bool, device=x.device)
    if p == 0:
        return x_out, marg, marg_ok
    _kernels.launch(
        "lm_marginals", "ses3d_lm_marginals", x.device,
        *(t.data_ptr() for t in inputs), x_out.data_ptr(), marg.data_ptr(),
        marg_ok.data_ptr(), p, what=f"lm_marginals launch (P = {p})")
    return x_out, marg, marg_ok


# ----------------------------------------------------------- the bounds --
# Float operations per person, counted from csrc/lm_prior.cu: a 3-vector
# dot is 5, a 3x3 times a 3-vector 15, a 3x3 product 45, the 3x3 inverse
# 42 (nine cofactors of 3, the determinant 5, the test 1, nine divisions).
_BONE_DIR = 3 + 5 + 1 + 3 + 1 + 1     # d, |d|^2, sqrt, u, r_b, wb
_INC_ENTRIES = 2 * N_BONES            # a bone's two joints
TRIP_OPS_PER_PERSON = (
    N_BONES * (_BONE_DIR + 4 + 12)    # linearise: + wb r_b u, wb u u^T
    + K_JOINTS * (3 + 15 + 3)         # r, C r, act (C r)
    + _INC_ENTRIES * (6 + 9)          # the joint's bones: gradient, block
    + K_JOINTS * (9 + 18 + 6)         # C + ., + lam eye, -(g_u + .)
    + N_BONES * (9 + 42 + 2 * 45 + 9 + 15 + 3 + 12)  # eliminate, parent update
    + K_JOINTS * (42 + 15)            # inverses, own solves
    + N_BONES * (9 + 15 + 3 + 15)     # back-substitute
    + K_JOINTS * 6                    # the finite test, x + delta
    + K_JOINTS * (3 + 15 + 5 + 1)     # joint error terms
    + N_BONES * (_BONE_DIR - 3 + 2)   # bone error terms (no u)
    + (K_JOINTS + N_BONES + 1) + 10   # the two sums, the rules
)
MARG_OPS_PER_PERSON = (
    K_JOINTS * 3                      # the finite test of x
    + N_BONES * (_BONE_DIR + 12)      # direction, wb u u^T
    + _INC_ENTRIES * 9 + K_JOINTS * 9  # the joint's blocks, C + .
    + N_BONES * (9 + 42 + 2 * 45 + 9 + 9)  # eliminate, parent update
    + K_JOINTS * 42                   # inverses
    + N_BONES * (9 + 3 * 45 + 9)      # the sigma sweep
    + K_JOINTS * 9                    # the finite test of the blocks
)
_F32 = 4


def trip_bytes(running: int, persons: int) -> int:
    """Bytes one launch of L1 must move, a whole LM or one trip alike: every
    person's `done`, each running person's inputs read once and outputs
    written once (a done person is neither read nor written), the bone
    tables and the loop's counters. Its operations are
    TRIP_OPS_PER_PERSON for each trip of each person."""
    # Read: x, meas, C, err, lam and the flags; written: x, err, lam, done.
    per = _F32 * (2 * K_JOINTS * 3 + K_JOINTS * 9 + 2) + K_JOINTS + N_BONES
    out = _F32 * (K_JOINTS * 3 + 2) + 1
    return persons + running * (per + out) + _F32 * 2 * N_BONES + 2 * (4 + 1)


def marginals_bytes(persons: int) -> int:
    """Bytes L2 must move: x, meas, C and the bone flags read, x, the
    blocks and marg_ok written, and the bone tables."""
    per = _F32 * (2 * K_JOINTS * 3 + K_JOINTS * 9) + N_BONES
    out = _F32 * (K_JOINTS * 3 + K_JOINTS * 9) + 1
    return persons * (per + out) + _F32 * 2 * N_BONES
