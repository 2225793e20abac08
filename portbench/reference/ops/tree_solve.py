"""Tree-structured block elimination for the skeleton prior's normal
equations.

The active bone factors form a forest over the 21 joints, so the LM Hessian
is 3x3 diagonal blocks plus one symmetric 3x3 coupling per bone. Leaf-to-root
elimination and root-to-leaf back-substitution, grouped by tree level
(about six levels), solve it; a sparse-inverse sweep gives the marginal
covariance blocks (gtsam's Marginals).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import skeleton
from portbench.reference.ops import linalg

_B = skeleton.NUM_BONES


def _levels() -> list[np.ndarray]:
    """Bones grouped by the depth of their child joint, deepest first."""
    parents = {}
    for b in range(_B):
        parents.setdefault(int(skeleton.BONE_J[b]), []).append(
            int(skeleton.BONE_I[b])
        )

    def node_depth(n):
        if n not in parents:
            return 0
        return 1 + max(node_depth(p) for p in parents[n])

    depth_of_bone = [node_depth(int(skeleton.BONE_J[b])) for b in range(_B)]
    return [
        np.array([b for b in range(_B) if depth_of_bone[b] == d], dtype=np.int64)
        for d in sorted(set(depth_of_bone), reverse=True)
    ]


LEVELS = _levels()


def _elimination_order() -> np.ndarray:
    """Bones ordered children first (decreasing depth of the child joint)."""
    parents = {}
    for b in range(_B):
        parents.setdefault(int(skeleton.BONE_J[b]), []).append(
            int(skeleton.BONE_I[b])
        )

    def depth(n):
        if n not in parents:
            return 0
        return 1 + max(depth(p) for p in parents[n])

    return np.array(
        sorted(range(_B), key=lambda b: -depth(int(skeleton.BONE_J[b]))),
        dtype=np.int64,
    )


ELIMINATION_ORDER = _elimination_order()


def _m3(a, b):
    """Batched 3x3 @ 3x3 as componentwise multiply-adds."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _m3t(a, b):
    """Batched 3x3 @ (3x3)^T, componentwise."""
    return torch.sum(a[..., :, None, :] * b[..., None, :, :], dim=-1)


def _mv3(a, v):
    """Batched 3x3 @ 3-vector, componentwise."""
    return torch.sum(a * v[..., None, :], dim=-1)


def _inv3(m):
    adj, det = linalg.adjugate3(m)
    safe = torch.abs(det) > 1e-30
    return adj / torch.where(safe, det, 1.0)[..., None, None]


def tree_solve_levels(hdiag, bone_coup, bone_active, rhs, want_sigma=False):
    """Solve H x = rhs for the tree-structured skeleton Hessian.

    Args:
      hdiag: [P, K, 3, 3] diagonal blocks (damping already added).
      bone_coup: [P, B, 3, 3] coupling blocks H[parent_b, child_b].
      bone_active: [P, B] bool.
      rhs: [P, K, 3].
      want_sigma: also return the diagonal blocks of H^-1.

    Returns (x [P, K, 3], sigma [P, K, 3, 3]; identity when not wanted).
    """
    d = hdiag
    r = rhs
    dev = hdiag.device
    lv = [
        (
            linalg.constant(skeleton.BONE_I[lvl], dev, torch.int64),
            linalg.constant(skeleton.BONE_J[lvl], dev, torch.int64),
            linalg.constant(lvl, dev, torch.int64),
        )
        for lvl in LEVELS
    ]

    def coup_at(b_idx):
        on = bone_active[:, b_idx]  # [P, L]
        return torch.where(on[..., None, None], bone_coup[:, b_idx], 0.0), on

    # Forward: eliminate whole levels, deepest first; siblings sharing a
    # parent accumulate through index_add.
    for p_idx, c_idx, b_idx in lv:
        c_m, _ = coup_at(b_idx)
        cdinv = _m3(c_m, _inv3(d[:, c_idx]))
        d = d.index_add(1, p_idx, -_m3(cdinv, c_m))
        r = r.index_add(1, p_idx, -_mv3(cdinv, r[:, c_idx]))

    # Backward: roots, then levels from shallow to deep. A level's duplicate
    # children (the NECK's two alternative parents) are mutually exclusive.
    d_inv = _inv3(d)
    x = _mv3(d_inv, r)

    def put(old, c_idx, on, val):
        fill = on.reshape(on.shape + (1,) * (val.dim() - 2))
        upd = torch.zeros_like(old).index_add(1, c_idx, torch.where(fill, val, 0.0))
        fired = torch.zeros(old.shape[:2], dtype=old.dtype, device=dev).index_add(
            1, c_idx, on.to(old.dtype)
        ) > 0
        return torch.where(fired.reshape(fired.shape + (1,) * (old.dim() - 2)), upd, old)

    for p_idx, c_idx, b_idx in lv[::-1]:
        c_m, on = coup_at(b_idx)
        xc = _mv3(d_inv[:, c_idx], r[:, c_idx] - _mv3(c_m, x[:, p_idx]))
        x = put(x, c_idx, on, xc)

    eye = torch.eye(3, dtype=hdiag.dtype, device=dev)
    if not want_sigma:
        return x, eye.expand(hdiag.shape)

    sigma = d_inv
    for p_idx, c_idx, b_idx in lv[::-1]:
        c_m, on = coup_at(b_idx)
        k_m = _m3(d_inv[:, c_idx], c_m)
        s_c = d_inv[:, c_idx] + _m3t(_m3(k_m, sigma[:, p_idx]), k_m)
        sigma = put(sigma, c_idx, on, s_c)
    return x, sigma


def tree_solve(hdiag, bone_coup, bone_active, rhs, want_sigma=False):
    """`tree_solve_levels` one bone at a time, in ELIMINATION_ORDER: the
    sequential elimination the level-grouped form is checked against.
    Arguments and returns as `tree_solve_levels`."""
    d = hdiag.clone()
    r = rhs.clone()

    def coup(b):
        return torch.where(bone_active[:, b, None, None], bone_coup[:, b], 0.0)

    order = [int(b) for b in ELIMINATION_ORDER]
    for b in order:
        p_idx, c_idx = int(skeleton.BONE_I[b]), int(skeleton.BONE_J[b])
        c_m = coup(b)
        cdinv = _m3(c_m, _inv3(d[:, c_idx]))
        d[:, p_idx] = d[:, p_idx] - _m3(cdinv, c_m)
        r[:, p_idx] = r[:, p_idx] - _mv3(cdinv, r[:, c_idx])

    d_inv = _inv3(d)  # the children's blocks as at their elimination
    x = _mv3(d_inv, r)
    for b in order[::-1]:
        p_idx, c_idx = int(skeleton.BONE_I[b]), int(skeleton.BONE_J[b])
        on = bone_active[:, b]
        xc = _mv3(d_inv[:, c_idx], r[:, c_idx] - _mv3(coup(b), x[:, p_idx]))
        x[:, c_idx] = torch.where(on[:, None], xc, x[:, c_idx])

    if not want_sigma:
        return x, torch.eye(3, dtype=hdiag.dtype, device=hdiag.device).expand(hdiag.shape)
    sigma = d_inv.clone()
    for b in order[::-1]:
        p_idx, c_idx = int(skeleton.BONE_I[b]), int(skeleton.BONE_J[b])
        on = bone_active[:, b]
        k_m = _m3(d_inv[:, c_idx], coup(b))
        s_c = d_inv[:, c_idx] + _m3t(_m3(k_m, sigma[:, p_idx]), k_m)
        sigma[:, c_idx] = torch.where(on[:, None, None], s_c, sigma[:, c_idx])
    return x, sigma
