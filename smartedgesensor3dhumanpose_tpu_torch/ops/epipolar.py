"""Epipolar association costs and the 3-view drop scores.

Torch form of the reference's calcCost (skeleton_3d_triang_mult_node.cpp:
335-390) evaluated once per frame for every unordered camera pair, and of the
3-view outlier test's pairwise distances (:748-792).
"""

from __future__ import annotations

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch.ops import linalg


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
    both; `usable` marks pairs sharing any such joint.
    """
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

    both_ok = conf_okT[..., iu, :, :][..., None] & conf_okT[..., ju, :, :][..., None, :]
    n_joints = torch.sum(both_ok, dim=-3)  # [..., Np, D1, D2]
    dist_sum = torch.sum(torch.where(both_ok, d, 0.0), dim=-3)
    cost_p = dist_sum / torch.where(n_joints > 0, n_joints, 1)
    return cost_p, n_joints > 0, iu, ju


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
