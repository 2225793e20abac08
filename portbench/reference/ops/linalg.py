"""Batched small-matrix linear algebra (adjugate nullvectors, closed-form
Cholesky factors) and the IEEE-fp32 einsum every geometry contraction uses.

All functions are shape-polymorphic over leading batch dimensions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def require_ieee_fp32() -> None:
    """Pin float32 matrix products to IEEE fp32 and check that nothing has
    switched them to TF32. A TF32 product keeps ~10 mantissa bits; on the
    association costs that flips near-gate decisions (the bf16 analogue of
    this fault flipped 3 person-validity decisions on the TPU). cuBLAS and
    cuDNN both read these flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}; the port needs "
            "'highest' (IEEE fp32, no TF32)"
        )


def capturing(t: torch.Tensor) -> bool:
    """Whether `t` lies on CUDA while the current stream captures a CUDA
    graph (graphs.py). A capture may not read a device value on the host,
    so the loops that test one eagerly become WHILE nodes then
    (ops/loops.py)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


# Unbounded: the tables are few, and a captured CUDA graph reads them by
# address, so an evicted table would be freed under a live graph.
@functools.lru_cache(maxsize=None)
def _uploaded(data: bytes, np_dtype: str, shape: tuple, device: torch.device, dtype):
    arr = np.frombuffer(data, dtype=np_dtype).reshape(shape)
    return torch.as_tensor(arr.copy(), dtype=dtype, device=device)


def constant(array, device, dtype=None) -> torch.Tensor:
    """A small host constant (a skeleton or pair index table) as a tensor on
    `device`, uploaded once per (contents, device, dtype) and then reused:
    on CUDA every host-to-device copy is a host sync. The returned tensor is
    shared by every caller, never freed, and must never be written in
    place."""
    a = np.ascontiguousarray(array)
    return _uploaded(a.tobytes(), a.dtype.str, a.shape, torch.device(device), dtype)


def heinsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """einsum at full precision: the port of the JAX package's
    Precision.HIGHEST einsum. On CUDA it lowers to cuBLAS, which stays IEEE
    fp32 as long as `require_ieee_fp32` holds (the pipeline calls it)."""
    return torch.einsum(equation, *operands)


def adjugate4(a: torch.Tensor) -> torch.Tensor:
    """Adjugate (transposed cofactor matrix) of batched 4x4 matrices:
    adj(A) A = det(A) I, closed form."""
    m = a

    def det3(r0, r1, r2, c0, c1, c2):
        return (
            m[..., r0, c0]
            * (m[..., r1, c1] * m[..., r2, c2] - m[..., r1, c2] * m[..., r2, c1])
            - m[..., r0, c1]
            * (m[..., r1, c0] * m[..., r2, c2] - m[..., r1, c2] * m[..., r2, c0])
            + m[..., r0, c2]
            * (m[..., r1, c0] * m[..., r2, c1] - m[..., r1, c1] * m[..., r2, c0])
        )

    rows = (0, 1, 2, 3)
    adj_cols = []
    for i in range(4):
        ri = tuple(r for r in rows if r != i)
        col = []
        for j in range(4):
            cj = tuple(c for c in rows if c != j)
            cof = det3(ri[0], ri[1], ri[2], cj[0], cj[1], cj[2])
            col.append(((-1.0) ** (i + j)) * cof)
        adj_cols.append(torch.stack(col, dim=-1))
    return torch.stack(adj_cols, dim=-1)


# Cyclic order of the six off-diagonal (p, q) pivots of a 4x4 Jacobi sweep.
_JACOBI_PAIRS_4 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _jacobi_rotation(app, aqq, apq, eps):
    """Jacobi rotation (c, s) annihilating the (p, q) off-diagonal entry,
    t = sign(tau) / (|tau| + sqrt(1 + tau^2)); the identity when
    |apq| <= eps."""
    small = torch.abs(apq) <= eps
    safe_apq = torch.where(small, 1.0, apq)
    tau = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)  # tau == 0: a 45-degree rotation
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    return torch.where(small, 1.0, c), torch.where(small, 0.0, s)


def eigh4(a: torch.Tensor, sweeps: int = 8):
    """Eigendecomposition of symmetric 4x4 batches by `sweeps` cyclic Jacobi
    sweeps (6-8 reach machine precision at 4x4). Returns (w [..., 4]
    eigenvalues, unsorted; v [..., 4, 4] eigenvectors in columns)."""
    eps = 1e-36 if a.dtype == torch.float64 else 1e-18
    v = torch.eye(4, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    a = a.clone()
    for _ in range(sweeps):
        for p, q in _JACOBI_PAIRS_4:
            c, s = _jacobi_rotation(a[..., p, p], a[..., q, q], a[..., p, q], eps)
            c_, s_ = c[..., None], s[..., None]
            # A <- G^T A G as a row update, then a column update; V <- V G.
            row_p = c_ * a[..., p, :] - s_ * a[..., q, :]
            row_q = s_ * a[..., p, :] + c_ * a[..., q, :]
            a[..., p, :], a[..., q, :] = row_p, row_q
            col_p = c_ * a[..., :, p] - s_ * a[..., :, q]
            col_q = s_ * a[..., :, p] + c_ * a[..., :, q]
            a[..., :, p], a[..., :, q] = col_p, col_q
            v_p = c_ * v[..., :, p] - s_ * v[..., :, q]
            v_q = s_ * v[..., :, p] + c_ * v[..., :, q]
            v[..., :, p], v[..., :, q] = v_p, v_q
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def smallest_eigvec4(a: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric 4x4 batches."""
    w, v = eigh4(a, sweeps=sweeps)
    idx = torch.argmin(w, dim=-1)
    return torch.take_along_dim(v, idx[..., None, None], dim=-1)[..., 0]


def smallest_eigvec4_psd(a: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Near-nullspace eigenvector of symmetric PSD 4x4 batches by adjugate
    power iteration: start from the dominant column of adj(A), apply adj(A)
    `iters - 1` more times, normalize; e4 where the result vanishes."""
    adj = adjugate4(a)
    norms = torch.sum(adj * adj, dim=-2)
    idx = torch.argmax(norms, dim=-1)
    v = sum(
        torch.where((idx == k)[..., None], adj[..., :, k], 0.0)
        for k in range(4)
    )
    for _ in range(iters - 1):
        v = sum(adj[..., :, k] * v[..., k:k + 1] for k in range(4))
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = v / torch.where(n > 0, n, 1.0)
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ok = n[..., 0] > 1e-30
    e4 = torch.zeros_like(v)
    e4[..., 3] = 1.0
    return torch.where(ok[..., None], v / torch.where(n > 0, n, 1.0), e4)


def chol2x2_packed(cov: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Cholesky factor (l11, l21, l22) of packed 2x2 covariances
    (xx, xy, yy); zero / non-PSD inputs give zeros, not NaNs."""
    xx = cov[..., 0]
    xy = cov[..., 1]
    yy = cov[..., 2]
    l11 = torch.sqrt(torch.clamp(xx, min=eps))
    safe = l11 > 0
    l21 = torch.where(safe, xy / torch.where(safe, l11, 1.0), 0.0)
    l22 = torch.sqrt(torch.clamp(yy - l21 * l21, min=0.0))
    return torch.stack([l11, l21, l22], dim=-1)


def chol3x3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky of batched symmetric PSD 3x3 matrices;
    zero pivots are clamped so masked lanes stay finite."""

    def safe_div(num, den):
        ok = den > 0
        return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)

    l11 = torch.sqrt(torch.clamp(a[..., 0, 0], min=0.0))
    l21 = safe_div(a[..., 1, 0], l11)
    l31 = safe_div(a[..., 2, 0], l11)
    l22 = torch.sqrt(torch.clamp(a[..., 1, 1] - l21 * l21, min=0.0))
    l32 = safe_div(a[..., 2, 1] - l31 * l21, l22)
    l33 = torch.sqrt(torch.clamp(a[..., 2, 2] - l31 * l31 - l32 * l32, min=0.0))
    zero = torch.zeros_like(l11)
    row0 = torch.stack([l11, zero, zero], dim=-1)
    row1 = torch.stack([l21, l22, zero], dim=-1)
    row2 = torch.stack([l31, l32, l33], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def sym3_pack(a: torch.Tensor) -> torch.Tensor:
    """3x3 symmetric matrix -> packed (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [a[..., 0, 0], a[..., 0, 1], a[..., 0, 2],
         a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]],
        dim=-1,
    )


def sym3_unpack(p: torch.Tensor) -> torch.Tensor:
    """Packed (xx, xy, xz, yy, yz, zz) -> full symmetric 3x3."""
    row0 = torch.stack([p[..., 0], p[..., 1], p[..., 2]], dim=-1)
    row1 = torch.stack([p[..., 1], p[..., 3], p[..., 4]], dim=-1)
    row2 = torch.stack([p[..., 2], p[..., 4], p[..., 5]], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def adjugate3(m: torch.Tensor):
    """(adjugate, determinant) of batched 3x3 matrices; callers divide with
    their own singularity guard."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    adj = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj, det
