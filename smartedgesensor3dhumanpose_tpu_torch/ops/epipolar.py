"""Epipolar association costs and the 3-view drop scores.

Torch form of the reference's calcCost (skeleton_3d_triang_mult_node.cpp:
335-390) evaluated once per frame for every unordered camera pair, and of the
3-view outlier test's pairwise distances (:748-792). The pipeline uses the
packed pair costs (on the card kernel E1, `pair_costs`, writes them as the
association's table in one launch) and the drop scores; the point-line
distance, the hypothesis x detection cost, the dense pair layout and the
pairwise joint distances are the JAX package's public helpers of the same
names.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch.ops import linalg


def symmetric_epipolar_distance(F, p1, p2):
    """Symmetric point-to-epipolar-line distance d1 + d2 (reference
    :355-362): d1 = |p2 . (F p1)| / ||(F p1)_xy||, d2 = |p1 . (F^T p2)| /
    ||(F^T p2)_xy||. F [..., 3, 3] (view of p1 -> view of p2), p1, p2
    [..., 2] normalized points -> [...]."""
    p1h = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    p2h = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    l1 = linalg.heinsum("...ij,...j->...i", F, p1h)  # line of p1 in view 2
    l2 = linalg.heinsum("...ji,...j->...i", F, p2h)  # F^T p2: line in view 1
    n1 = torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2)
    n2 = torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2)
    d1 = torch.abs(linalg.heinsum("...i,...i->...", p2h, l1)) / torch.where(n1 > 0, n1, 1.0)
    d2 = torch.abs(linalg.heinsum("...i,...i->...", p1h, l2)) / torch.where(n2 > 0, n2, 1.0)
    return d1 + d2


def association_cost(hyp_kp, hyp_cam_mask, hyp_obs_score, det_kp, det_valid,
                     F_to_det, min_kp_score: float, max_epipolar_error: float,
                     max_cost: float):
    """Hypothesis x detection epipolar cost with veto flags (calcCost,
    :335-390), from the hypotheses' keypoints directly: per observation the
    symmetric distance averaged over joints confident in both views, then
    averaged over observations sharing a joint; an observation above the
    gate votes if confident (score > 0.5) or alone, and the pairing is
    vetoed when the votes exceed 1 - 1/(2 n_obs). No usable observation or
    an invalid detection: max_cost and a veto.

    hyp_kp [H, C, J, 3], hyp_cam_mask [H, C], hyp_obs_score [H, C], det_kp
    [D, J, 3], det_valid [D], F_to_det [C, 3, 3] -> (cost [H, D], veto
    [H, D] bool).
    """
    hyp_conf_ok = hyp_kp[..., 2] > min_kp_score  # [H, C, J]
    det_conf_ok = det_kp[..., 2] > min_kp_score  # [D, J]
    both_ok = hyp_conf_ok[:, :, None, :] & det_conf_ok[None, None, :, :]
    d = symmetric_epipolar_distance(
        F_to_det[None, :, None, None],
        hyp_kp[:, :, None, :, :2],
        det_kp[None, None, :, :, :2].expand(hyp_kp.shape[:2] + det_kp.shape[:2] + (2,)),
    )  # [H, C, D, J]
    n_joints = torch.sum(both_ok, dim=-1)  # [H, C, D]
    dist_sum = torch.sum(torch.where(both_ok, d, 0.0), dim=-1)
    obs_cost = dist_sum / torch.where(n_joints > 0, n_joints, 1)
    obs_used = hyp_cam_mask[:, :, None] & (n_joints > 0)
    n_obs_in_hyp = torch.sum(hyp_cam_mask, dim=-1)  # [H]
    n_obs_used = torch.sum(obs_used, dim=1)  # [H, D]
    total = torch.sum(torch.where(obs_used, obs_cost, 0.0), dim=1)
    cost = total / torch.where(n_obs_used > 0, n_obs_used, 1)
    confident = (hyp_obs_score > 0.5)[:, :, None] | (n_obs_in_hyp[:, None, None] == 1)
    vote = obs_used & (obs_cost > max_epipolar_error) & confident
    n_obs_f = torch.clamp(n_obs_in_hyp, min=1).to(cost.dtype)
    tmp_veto = torch.sum(vote, dim=1).to(cost.dtype) / n_obs_f[:, None]
    veto = tmp_veto > (1.0 - 1.0 / (2.0 * n_obs_f))[:, None]
    unusable = (n_obs_used == 0) | (n_obs_in_hyp[:, None] == 0)
    cost = torch.where(unusable, max_cost, cost)
    veto = veto | unusable
    cost = torch.where(det_valid[None, :], cost, max_cost)
    return cost, veto | ~det_valid[None, :]


def pairwise_association_costs(kp, F, min_kp_score: float):
    """The per-observation cost for every ordered detection pair, dense:
    (pair_cost [C, D, C, D], pair_usable [C, D, C, D] bool), the packed
    upper triangle mirrored (the distance is symmetric under swapping the
    pair's roles, bit for bit); entries with c1 == c2 are zero and unusable.
    kp [C, D, J, 3], F [C, C, 3, 3]."""
    c, dd = kp.shape[:2]
    pair_cost = torch.zeros((c, dd, c, dd), dtype=kp.dtype, device=kp.device)
    usable = torch.zeros((c, dd, c, dd), dtype=torch.bool, device=kp.device)
    if c < 2:
        return pair_cost, usable
    cost_p, usable_p, iu, ju = pairwise_association_costs_packed(kp, F, min_kp_score)
    pair_cost[iu, :, ju, :] = cost_p
    usable[iu, :, ju, :] = usable_p
    return (pair_cost + pair_cost.permute(2, 3, 0, 1),
            usable | usable.permute(2, 3, 0, 1))


def pairwise_association_costs_packed(
    kp: torch.Tensor,
    F: torch.Tensor,
    min_kp_score: float,
):
    """calcCost's per-observation term for every unordered camera pair.

    Args:
      kp: [..., C, D, J, 3] normalized keypoints (x, y, conf); leading axes
        (frames) pass through.
      F: [C, C, 3, 3] fundamental matrices (i -> j).
      min_kp_score: joint confidence gate.

    Returns (cost [..., Np, D, D], usable [..., Np, D, D] bool, iu, ju) where
    (iu[p], ju[p]) enumerate the C(C-1)/2 pairs with iu < ju (NumPy triu
    order) and entry [p, d1, d2] is the symmetric epipolar distance between
    detection (iu[p], d1) and (ju[p], d2) averaged over joints confident in
    both; `usable` marks pairs sharing any such joint: the per-joint terms
    of `packed_pair_terms` summed by `torch.sum`. Kernel E1 (`pair_costs`)
    computes the same costs, packed as fusion.fold_inputs' table, in one
    launch.
    """
    terms, both_ok, iu, ju = packed_pair_terms(kp, F, min_kp_score)
    n_joints = torch.sum(both_ok, dim=-3)  # [..., Np, D1, D2]
    dist_sum = torch.sum(terms, dim=-3)
    cost_p = dist_sum / torch.where(n_joints > 0, n_joints, 1)
    return cost_p, n_joints > 0, iu, ju


def packed_pair_terms(kp: torch.Tensor, F: torch.Tensor, min_kp_score: float):
    """The per-joint terms of `pairwise_association_costs_packed`: kp [...,
    C, D, J, 3], F [C, C, 3, 3] -> (terms [..., Np, J, D1, D2], both_ok
    [..., Np, J, D1, D2] bool, iu, ju), `pair_terms_plain` of every pair's
    coordinates and per-detection lines."""
    c = kp.shape[-4]
    iu_np, ju_np = np.triu_indices(c, k=1)
    iu = linalg.constant(iu_np, kp.device)
    ju = linalg.constant(ju_np, kp.device)
    xT = kp[..., 0].transpose(-1, -2)  # [..., C, J, D]
    yT = kp[..., 1].transpose(-1, -2)
    conf_okT = kp[..., 2].transpose(-1, -2) > min_kp_score

    x1, y1 = xT[..., iu, :, :], yT[..., iu, :, :]  # [..., Np, J, D1]
    x2, y2 = xT[..., ju, :, :], yT[..., ju, :, :]  # [..., Np, J, D2]
    Fp = F[iu, ju]  # [Np, 3, 3]

    def line(f0, f1, f2, xs, ys):
        return (
            f0[:, None, None] * xs + f1[:, None, None] * ys
            + f2[:, None, None]
        )

    def unit(l0, l1, l2):
        den = l0 ** 2 + l1 ** 2
        inv = torch.where(den > 0, torch.rsqrt(den), 1.0)
        return l0 * inv, l1 * inv, l2 * inv

    # Line of (c1, d1, j) in camera c2: Fp @ [x1, y1, 1], scaled by
    # 1/||l_xy|| so the [..., Np, J, D1, D2] product needs no normalization.
    l10, l11, l12 = unit(
        line(Fp[:, 0, 0], Fp[:, 0, 1], Fp[:, 0, 2], x1, y1),
        line(Fp[:, 1, 0], Fp[:, 1, 1], Fp[:, 1, 2], x1, y1),
        line(Fp[:, 2, 0], Fp[:, 2, 1], Fp[:, 2, 2], x1, y1),
    )
    # Line of (c2, d2, j) back in camera c1: Fp^T @ [x2, y2, 1].
    l20, l21, l22 = unit(
        line(Fp[:, 0, 0], Fp[:, 1, 0], Fp[:, 2, 0], x2, y2),
        line(Fp[:, 0, 1], Fp[:, 1, 1], Fp[:, 2, 1], x2, y2),
        line(Fp[:, 0, 2], Fp[:, 1, 2], Fp[:, 2, 2], x2, y2),
    )

    terms, both_ok = pair_terms_plain(x1, y1, (l10, l11, l12), conf_okT[..., iu, :, :],
                                      x2, y2, (l20, l21, l22), conf_okT[..., ju, :, :])
    return terms, both_ok, iu, ju


def pair_terms_plain(x1, y1, lines1, ok1, x2, y2, lines2, ok2) -> tuple:
    """The per-joint terms of `pairwise_association_costs_packed`: side 1's
    coordinates, line (l10, l11, l12) and confident flags [..., Np, J, D1],
    side 2's [..., Np, J, D2] -> (terms [..., Np, J, D1, D2]: the distance
    of d2's point from d1's line plus d1's from d2's, |num1| + |num2|, where
    both joints are confident, else 0; both_ok [..., Np, J, D1, D2])."""
    (l10, l11, l12), (l20, l21, l22) = lines1, lines2
    num1 = (
        x2[..., None, :] * l10[..., None]
        + y2[..., None, :] * l11[..., None]
        + l12[..., None]
    )
    num2 = (
        x1[..., None] * l20[..., None, :]
        + y1[..., None] * l21[..., None, :]
        + l22[..., None, :]
    )
    d = torch.abs(num1) + torch.abs(num2)  # [..., Np, J, D1, D2]
    both_ok = ok1[..., None] & ok2[..., None, :]
    return torch.where(both_ok, d, 0.0), both_ok


class PairCosts(ctypes.Structure):
    """csrc/pair_costs.cu `Costs`, field by field: the keypoints, F and the
    table (pointers), the shapes, the cameras a block takes a round and the
    confidence gate."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("kp", "F", "ctab")] + [
        (name, ctypes.c_int) for name in ("b", "c", "d", "j", "groups")] + [
        ("min_score", ctypes.c_float)]


# What E1 takes (csrc/pair_costs.cu): a detection's confident joints are one
# 32-bit mask; a block has at most PAIR_COSTS_THREADS threads, one per
# (camera c1, detection), and keeps its shared memory within
# PAIR_COSTS_SMEM bytes; its shared arrays pad D to PAIR_COSTS_SLOTS.
PAIR_COSTS_MAX_JOINTS = 32
PAIR_COSTS_THREADS = 128
PAIR_COSTS_SLOTS = 8
PAIR_COSTS_SMEM = 56 * 1024


def pair_costs_smem_bytes(d: int, j: int, groups: int) -> int:
    """E1's shared memory at d detections, j joints and `groups` cameras a
    round (csrc/pair_costs.cu smem_floats): c2's points and masks and the
    round's lines."""
    dp = -(-d // PAIR_COSTS_SLOTS) * PAIR_COSTS_SLOTS
    return 4 * (2 * j * dp + dp + 3 * groups * j * dp)


def pair_costs_groups(d: int, j: int) -> int:
    """The cameras c1 a block of E1 takes a round at d detections and j
    joints: as many as PAIR_COSTS_THREADS threads hold, halved while the
    block's shared memory exceeds PAIR_COSTS_SMEM."""
    groups = max(1, PAIR_COSTS_THREADS // d)
    while groups > 1 and pair_costs_smem_bytes(d, j, groups) > PAIR_COSTS_SMEM:
        groups //= 2
    return groups


def pair_costs(kp: torch.Tensor, F: torch.Tensor, min_kp_score: float,
               host: bool = False) -> torch.Tensor:
    """Kernel E1 (csrc/pair_costs.cu): fusion.fold_inputs' table of pair
    costs in one launch on the current stream, no host sync: kp [..., C, D,
    J, 3] and F [C, C, 3, 3] float32 -> ctab [..., C, C*D, D], whose entry
    [c2, c1 * D + d1, d2] is `pairwise_association_costs_packed`'s cost of
    the pair (c1, d1), (c2, d2) for c1 < c2 where usable, else -1. On the
    card it equals the plain costs (`pair_terms_plain` summed by
    torch.sum) bit for bit; `host` runs its host build on CPU tensors (the
    tests' handle on its arithmetic; there the inverse norm is correctly
    rounded)."""
    from smartedgesensor3dhumanpose_tpu_torch import _kernels

    *lead, c, d, j, three = kp.shape
    dev = kp.device
    if (kp.dtype != torch.float32 or F.dtype != torch.float32 or F.device != dev
            or (dev.type == "cuda") == host):
        raise ValueError(f"kernel E1 takes float32 {'CPU' if host else 'CUDA'} tensors on one "
                         f"device; got kp {kp.dtype} on {dev}, F {F.dtype} on {F.device}")
    if three != 3 or tuple(F.shape) != (c, c, 3, 3) or j > PAIR_COSTS_MAX_JOINTS \
            or d > PAIR_COSTS_THREADS:
        raise ValueError(f"kernel E1 takes kp [..., C, D <= {PAIR_COSTS_THREADS}, J <= "
                         f"{PAIR_COSTS_MAX_JOINTS}, 3] and F [C, C, 3, 3]; got "
                         f"{tuple(kp.shape)} and {tuple(F.shape)}")
    kp = kp.contiguous()
    F = F.contiguous()
    ctab = torch.empty(tuple(lead) + (c, c * d, d), dtype=torch.float32, device=dev)
    frames = math.prod(lead)
    costs = PairCosts(kp.data_ptr(), F.data_ptr(), ctab.data_ptr(), frames, c, d, j,
                      pair_costs_groups(d, j), min_kp_score)
    what = f"pair costs launch (frames={frames}, cameras={c}, d={d}, j={j})"
    if host:
        _kernels.check(_kernels.host_library().ses3d_pair_costs_host(ctypes.byref(costs)), what)
    else:
        _kernels.launch("pair_costs", "ses3d_pair_costs", dev, ctypes.byref(costs), what=what)
    return ctab


def three_view_drop_scores(
    F: torch.Tensor,
    kp: torch.Tensor,
    view_mask: torch.Tensor,
):
    """Per-drop remaining pairwise epipolar d^2 for the exactly-3-view case.

    Args:
      F: [C, C, 3, 3]; kp: [..., C, 3]; view_mask: [..., C] bool.

    Returns (rem_d2 [..., 3], idx3 [..., 3]): rem_d2[v] is the d^2 of the
    pair left after dropping the v-th valid view; idx3 the first three valid
    view indices (ascending; arbitrary where fewer than 3 are valid).
    """
    pos = torch.cumsum(view_mask.to(torch.int32), dim=-1) - 1  # [..., C]

    def nth_valid(v):
        hit = view_mask & (pos == v)
        first = torch.argmax(hit.to(torch.int32), dim=-1)
        return torch.where(hit.any(dim=-1), first, 0)

    idx3 = torch.stack([nth_valid(0), nth_valid(1), nth_valid(2)], dim=-1)

    def gather_kp(i):
        return torch.take_along_dim(kp, i[..., None, None], dim=-2)[..., 0, :]

    p = [gather_kp(idx3[..., v]) for v in range(3)]

    def pair_d2(ia, ib, pa, pb):
        # Canonical orientation F[min, max], as the reference's
        # get_fundamental_idx.
        lo = torch.minimum(ia, ib)
        hi = torch.maximum(ia, ib)
        Fp = F[lo, hi]  # [..., 3, 3]
        fwd = (ia <= ib)[..., None]
        p1 = torch.where(fwd, pa, pb)
        p2 = torch.where(fwd, pb, pa)
        one = torch.ones_like(p1[..., :1])
        p1h = torch.cat([p1[..., :2], one], dim=-1)
        p2h = torch.cat([p2[..., :2], one], dim=-1)
        l1 = linalg.heinsum("...ij,...j->...i", Fp, p1h)
        l2 = linalg.heinsum("...ji,...j->...i", Fp, p2h)
        num1 = linalg.heinsum("...i,...i->...", p2h, l1)
        num2 = linalg.heinsum("...i,...i->...", p1h, l2)
        den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
        den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
        return num1 ** 2 / torch.where(den1 > 0, den1, 1.0) + num2 ** 2 / torch.where(
            den2 > 0, den2, 1.0
        )

    d2_01 = pair_d2(idx3[..., 0], idx3[..., 1], p[0], p[1])
    d2_02 = pair_d2(idx3[..., 0], idx3[..., 2], p[0], p[2])
    d2_12 = pair_d2(idx3[..., 1], idx3[..., 2], p[1], p[2])
    rem_d2 = torch.stack([d2_12, d2_02, d2_01], dim=-1)
    return rem_d2, idx3


def pairwise_joint_epipolar_sq(F, kp, view_mask):
    """Squared symmetric epipolar distance between every pair of views of a
    joint (:748-792): for views (a, b), num1^2 / ||l1_xy||^2 + num2^2 /
    ||l2_xy||^2 with l1 = F_ab p_a, l2 = F_ab^T p_b; invalid pairs and the
    diagonal are zero, and the upper triangle is mirrored so the result is
    exactly symmetric. F [C, C, 3, 3], kp [..., C, 3], view_mask [..., C]
    -> [..., C, C]."""
    ph = torch.cat([kp[..., :2], torch.ones_like(kp[..., :1])], dim=-1)
    l1 = linalg.heinsum("abij,...aj->...abi", F, ph)  # line of p_a in view b
    l2 = linalg.heinsum("abji,...bj->...abi", F, ph)  # F^T p_b: line in view a
    num1 = linalg.heinsum("...bi,...abi->...ab", ph, l1)
    num2 = linalg.heinsum("...ai,...abi->...ab", ph, l2)
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    d2 = num1 ** 2 / torch.where(den1 > 0, den1, 1.0) + num2 ** 2 / torch.where(
        den2 > 0, den2, 1.0
    )
    pair_ok = view_mask[..., :, None] & view_mask[..., None, :]
    eye = torch.eye(kp.shape[-2], dtype=torch.bool, device=kp.device)
    upper = torch.triu(torch.where(pair_ok & ~eye, d2, 0.0))
    return upper + upper.transpose(-1, -2)
