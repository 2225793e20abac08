"""Unscented covariance propagation: 2D -> 3D through the DLT
(skeleton_3d_triang_mult_node.cpp:471-523) and 3D -> 2D through the camera
projection (skeleton_reproj_mult_node.cpp:56-75,189-204)."""

from __future__ import annotations

import torch

from smartedgesensor3dhumanpose_tpu_torch.ops import linalg, triangulation

# Views the UT's base normal matrix sums in one product. The CPU's BLAS
# sums a contraction of up to 5 x 64 terms as one multiply-add chain and
# a longer one in blocks of its own choosing; summed in chunks of 64 views
# added in turn, the order is one a kernel can take (csrc/triangulation.cu
# ut_sum).
PRODUCT_VIEWS = 64


def triangulation_covariance(P, kp, cov2d, view_mask, mean_xyz, kappa=0.5):
    """3x3 covariance of a triangulated joint by the unscented transform.

    Per valid view, four sigma points perturb that view's (x, y) by the
    columns of its 2x2 Cholesky factor scaled by b = sqrt(2k + kappa);
    each is re-triangulated unweighted (calc_covariance's default, :518) and
    the covariance is the weighted scatter around the weighted mean
    triangulation `mean_xyz`. Sigma point s = 4c + v only changes view c's
    normal-matrix contribution, so M_s = M0 + (T(kp_c + delta) - T(kp_c)).

    kp [..., C, 3], cov2d [..., C, 3], view_mask [..., C], mean_xyz
    [..., 3] -> [..., 3, 3].
    """
    dtype = kp.dtype
    c = kp.shape[-2]
    n_views = torch.sum(view_mask, dim=-1)
    k = n_views.to(dtype)
    dim = 2.0 * k
    b = torch.sqrt(dim + kappa)

    chol = linalg.chol2x2_packed(cov2d)
    chol = torch.where(view_mask[..., None], chol, 0.0)
    l11 = chol[..., 0]
    l21 = chol[..., 1]
    l22 = chol[..., 2]
    zero = torch.zeros_like(l11)
    deltas = torch.stack(
        [
            torch.stack([-l11, -l21], dim=-1),
            torch.stack([zero, -l22], dim=-1),
            torch.stack([l11, l21], dim=-1),
            torch.stack([zero, l22], dim=-1),
        ],
        dim=-2,
    ) * b[..., None, None, None]  # [..., C, 4, 2]

    batch = kp.shape[:-2]
    coeff0 = triangulation.view_coeffs(P, kp, view_mask, weight_by_conf=False)
    const = triangulation.coeff_constants(P, dtype)  # [C, 5, 4, 4]
    M0 = None
    for lo in range(0, c, PRODUCT_VIEWS):
        part = linalg.heinsum("...ck,ckij->...ij", coeff0[..., lo:lo + PRODUCT_VIEWS, :],
                              const[lo:lo + PRODUCT_VIEWS])
        M0 = part if M0 is None else M0 + part
    t_0 = triangulation.solve_normal(M0, n_views)

    kp_xy_v = kp[..., None, :, :2] + deltas.movedim(-2, -3)  # [..., 4, C, 2]
    kp_v = torch.cat(
        [kp_xy_v, kp[..., None, :, 2:3].expand(kp_xy_v.shape[:-1] + (1,))],
        dim=-1,
    )
    coeff_v = triangulation.view_coeffs(
        P, kp_v, view_mask[..., None, :], weight_by_conf=False
    )  # [..., 4, C, 5]
    dcoeff = coeff_v - coeff0[..., None, :, :]
    dc = dcoeff.transpose(-3, -2)[..., None, None]  # [..., C, 4, 5, 1, 1]
    dM = sum(dc[..., kk, :, :] * const[:, kk][:, None] for kk in range(5))
    M_s = (M0[..., None, None, :, :] + dM).reshape(batch + (4 * c, 4, 4))
    t_s = triangulation.solve_normal(
        M_s, n_views[..., None].expand(batch + (4 * c,))
    )  # [..., S, 3]

    denom = 2.0 * (dim + kappa)
    w_s = torch.repeat_interleave(view_mask, 4, dim=-1).to(dtype) / denom[..., None]
    w_0 = 2.0 * kappa / denom

    d_s = t_s - mean_xyz[..., None, :]
    d_0 = t_0 - mean_xyz
    wd = w_s[..., None] * d_s
    xx, xy, xz, yy, yz, zz = [
        torch.sum(wd[..., i] * d_s[..., j], dim=-1)
        for (i, j) in [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    ]
    cov = torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )
    return cov + w_0[..., None, None] * d_0[..., :, None] * d_0[..., None, :]


def project_with_covariance(xyz, cov3d, P, K, kappa=0.5):
    """Project 3D joints with covariance into every camera by a 7-point UT
    (skeleton_reproj_mult_node.cpp:62-75,202-204).

    xyz [..., 3], cov3d [..., 3, 3], P [C, 3, 4], K [C, 4] ->
    (mean_px [..., C, 2], cov_px [..., C, 3] packed (xx, xy, yy)).
    """
    dtype = xyz.dtype
    dim = 3.0
    b = (dim + kappa) ** 0.5
    l = linalg.chol3x3(cov3d)
    cols = l.transpose(-1, -2) * b  # rows are L's columns
    zero = torch.zeros_like(xyz)[..., None, :]
    offsets = torch.cat([zero, -cols, cols], dim=-2)  # [..., 7, 3]
    samples = xyz[..., None, :] + offsets

    sx = samples[..., 0:1]
    sy = samples[..., 1:2]
    sz = samples[..., 2:3]

    def cam_row(i):
        return P[:, i, 0] * sx + P[:, i, 1] * sy + P[:, i, 2] * sz + P[:, i, 3]

    z = cam_row(2)
    z = torch.where(torch.abs(z) > 1e-20, z, 1e-20)
    px_x = K[:, 0] * cam_row(0) / z + K[:, 2]  # [..., 7, C]
    px_y = K[:, 1] * cam_row(1) / z + K[:, 3]

    denom = 2.0 * (dim + kappa)
    w = torch.cat(
        [
            torch.full((1,), 2.0 * kappa / denom, dtype=dtype, device=xyz.device),
            torch.full((6,), 1.0 / denom, dtype=dtype, device=xyz.device),
        ]
    )[:, None]  # [7, 1]
    mean_x = torch.sum(w * px_x, dim=-2)
    mean_y = torch.sum(w * px_y, dim=-2)
    dx = px_x - mean_x[..., None, :]
    dy = px_y - mean_y[..., None, :]
    cov_px = torch.stack(
        [
            torch.sum(w * dx * dx, dim=-2),
            torch.sum(w * dx * dy, dim=-2),
            torch.sum(w * dy * dy, dim=-2),
        ],
        dim=-1,
    )
    return torch.stack([mean_x, mean_y], dim=-1), cov_px
