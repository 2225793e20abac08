"""Masked, batched confidence-weighted DLT triangulation.

The reference solves each joint's 2k x 4 DLT system by JacobiSVD
(skeleton_3d_triang_mult_node.cpp:425-465); here the 4x4 normal matrix is
built from per-view contributions in closed coefficient form, so dropping or
perturbing a view is a cheap update, and solved by adjugate power iteration.
"""

from __future__ import annotations

import torch

from portbench.reference.ops import linalg


def dlt_rows(P, kp, view_mask, weight_by_conf: bool):
    """The two DLT rows per view, r1 = x P[2] - P[0] and r2 = y P[2] - P[1],
    each L2-normalized and optionally scaled by the confidence (reference
    :443-454); masked-out views' rows are zero. P [C, 3, 4] (or batched),
    kp [..., C, 3], view_mask [..., C] -> (r1, r2) [..., C, 4] each."""
    x, y, conf = kp[..., 0:1], kp[..., 1:2], kp[..., 2:3]

    def norm_rows(r):
        n = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
        r = r / torch.where(n > 0, n, 1.0)
        if weight_by_conf:
            r = r * conf
        return torch.where(view_mask[..., None], r, 0.0)

    return (norm_rows(x * P[..., 2, :] - P[..., 0, :]),
            norm_rows(y * P[..., 2, :] - P[..., 1, :]))


def coeff_constants(P: torch.Tensor, dtype) -> torch.Tensor:
    """The five constant per-camera 4x4 outer products of the coefficient
    form: [C, 5, 4, 4]."""
    p0, p1, p2 = P[:, 0], P[:, 1], P[:, 2]  # [C, 4]

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]

    a22 = outer(p2, p2)
    a02 = outer(p0, p2)
    a12 = outer(p1, p2)
    return torch.stack(
        [
            a22,
            a02 + a02.transpose(-1, -2),
            outer(p0, p0),
            a12 + a12.transpose(-1, -2),
            outer(p1, p1),
        ],
        dim=1,
    ).to(dtype)


def view_coeffs(P, kp, view_mask, weight_by_conf: bool) -> torch.Tensor:
    """Per-view scalar coefficients [..., C, 5] of the normal-matrix
    coefficient form: each normalized, weighted DLT row pair contributes
    w^2 (x p2 - p0)(x p2 - p0)^T / ||x p2 - p0||^2 (+ the y row), expanded
    over `coeff_constants`. Masked views contribute zero."""
    p0, p1, p2 = P[:, 0], P[:, 1], P[:, 2]
    n22 = torch.sum(p2 * p2, -1)
    n00 = torch.sum(p0 * p0, -1)
    n11 = torch.sum(p1 * p1, -1)
    n02 = torch.sum(p0 * p2, -1)
    n12 = torch.sum(p1 * p2, -1)

    x = kp[..., 0]
    y = kp[..., 1]
    w2 = kp[..., 2] ** 2 if weight_by_conf else torch.ones_like(x)
    nx = x * x * n22 - 2.0 * x * n02 + n00
    ny = y * y * n22 - 2.0 * y * n12 + n11
    wmask = torch.where(view_mask, w2, 0.0)
    inv_nx = wmask / torch.clamp(nx, min=1e-30)
    inv_ny = wmask / torch.clamp(ny, min=1e-30)
    return torch.stack(
        [
            x * x * inv_nx + y * y * inv_ny,
            -x * inv_nx,
            inv_nx,
            -y * inv_ny,
            inv_ny,
        ],
        dim=-1,
    )


def view_contribs(P, kp, view_mask, weight_by_conf: bool) -> torch.Tensor:
    """Per-view 4x4 normal-matrix contributions T_c, A^T A = sum_c T_c:
    [..., C, 4, 4]."""
    coeff = view_coeffs(P, kp, view_mask, weight_by_conf)
    const = coeff_constants(P, kp.dtype)
    return linalg.heinsum("...ck,ckij->...cij", coeff, const)


def triangulate(P, kp, view_mask, weight_by_conf: bool = True, sweeps: int = 8):
    """One 3D point per batch element from its masked views: the smallest
    eigenvector of A^T A (the reference's smallest singular vector, :456),
    de-homogenized. A static rig P [C, 3, 4] takes the coefficient form, a
    batched P the DLT rows. Fewer than 2 views give 0. kp [..., C, 3],
    view_mask [..., C] -> [..., 3]. `sweeps` is accepted for the JAX
    signature; the eigenvector comes from `linalg.smallest_eigvec4_psd`."""
    if P.dim() == 3:
        coeff = view_coeffs(P, kp, view_mask, weight_by_conf)
        m = linalg.heinsum("...ck,ckij->...ij", coeff, coeff_constants(P, kp.dtype))
    else:
        r1, r2 = dlt_rows(P, kp, view_mask, weight_by_conf)
        m = (linalg.heinsum("...ci,...cj->...ij", r1, r1)
             + linalg.heinsum("...ci,...cj->...ij", r2, r2))
    return solve_normal(m, torch.sum(view_mask, dim=-1))


def solve_normal(m: torch.Tensor, n_views: torch.Tensor) -> torch.Tensor:
    """min ||A x||, ||x|| = 1 from the normal matrix m = A^T A [..., 4, 4],
    de-homogenized to [..., 3]. Lanes with fewer than 2 views are biased by
    the identity (finite) and return 0; callers gate them out."""
    deficient = n_views < 2
    eye = torch.eye(4, dtype=m.dtype, device=m.device)
    m = m + torch.where(deficient[..., None, None], 1.0, 0.0).to(m.dtype) * eye
    h = linalg.smallest_eigvec4_psd(m)
    w = h[..., 3]
    w = torch.where(torch.abs(w) > 1e-20, w, 1e-20)
    xyz = h[..., :3] / w[..., None]
    return torch.where(deficient[..., None], 0.0, xyz)


def reprojection_error(xyz, P, kp, view_mask) -> torch.Tensor:
    """Confidence-weighted mean reprojection error in normalized coords,
    sum_i conf_i ||proj_i(x) - kp_i|| / sum_i conf_i over valid views
    (reference calcReprojectionError, :425-438). xyz [..., 3], kp
    [..., C, 3], view_mask [..., C] -> [...]."""
    x = xyz[..., None, 0]  # [..., 1]
    y = xyz[..., None, 1]
    zc = xyz[..., None, 2]

    def row(i):
        return P[:, i, 0] * x + P[:, i, 1] * y + P[:, i, 2] * zc + P[:, i, 3]

    z = row(2)
    z = torch.where(torch.abs(z) > 1e-20, z, 1e-20)
    ex = row(0) / z - kp[..., 0]
    ey = row(1) / z - kp[..., 1]
    err = torch.sqrt(ex * ex + ey * ey)
    conf = torch.where(view_mask, kp[..., 2], 0.0)
    norm = torch.sum(conf, dim=-1)
    total = torch.sum(conf * torch.where(view_mask, err, 0.0), dim=-1)
    return total / torch.where(norm > 0, norm, 1.0)


def triangulate_with_error(P, kp, view_mask, weight_by_conf: bool = True,
                           sweeps: int = 8):
    """`triangulate` and the weighted reprojection error of its points."""
    xyz = triangulate(P, kp, view_mask, weight_by_conf, sweeps)
    return xyz, reprojection_error(xyz, P, kp, view_mask)
