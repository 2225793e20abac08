"""Rectangular linear-sum assignment (Jonker-Volgenant): kernel K1 and its
plain PyTorch version.

The reference links a C++ Munkres (Hungarian.h:24) for the cross-view and
the track association. Here the solver is the JV algorithm of the JAX
package's TPU kernel (ops/hungarian_pallas.py::_jv_kernel): a row-reduction
initialization, then a Dijkstra augmenting search for the rows left free.

`linear_sum_assignment` launches the CUDA kernel (csrc/jv_assign.cu) for a
CUDA tensor and runs the plain version `linear_sum_assignment_reference`
for a CPU tensor; there is no other path. The plain version is the same
algorithm with the same tie rules, written as a Python loop over tensor
ops, so in float32 the two agree bit for bit.

Widths: the plain version takes any n = max(R, C). The kernel solves a
problem of up to MAX_N_REG = 255 columns with one warp, its columns in
registers (1-8 slots of 32; K2 and K3 embed the same routine up to MAX_N =
120), and up to MAX_N_WIDE with one block of `block_warps(n)` warps, its
columns in shared memory (csrc/jv.cuh::jv_solve_block_smem); it refuses
wider problems. The JAX package's XLA JV (ops/hungarian.py there) has no
width limit.

Precision note: in float32, keep infeasible placeholder costs at a moderate
ceiling (callers clip at 1e3) so reduced costs stay accurate.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from smartedgesensor3dhumanpose_tpu_torch import _kernels

MAX_N = 120  # columns + the virtual column fit 4 register slots of 32 lanes
# K1's register routine: up to 8 slots of 32 lanes; past it one block per
# problem.
MAX_N_REG = 255
# The block routine's limit: its state for n columns, 25 bytes per column
# (wide_state_bytes), fits one block's shared memory up to here.
MAX_N_WIDE = 8192
MAX_BLOCK_WARPS = 16
# The block routine's posts (jv.cuh::JvPosts): key, column and value per
# warp, double-buffered.
BLOCK_POST_BYTES = 3 * 2 * MAX_BLOCK_WARPS * 4
_INF = 3.0e38
# The kernel's layout: one warp per problem, up to WARPS_PER_BLOCK problems
# per block (one per SM sub-partition), within the H100's shared memory per
# block.
WARPS_PER_BLOCK = 4
SMEM_LIMIT = 232_448

# Search steps the plain version has taken (the data-dependent part of the
# work, which a kernel's bound counts).
PLAIN_SEARCH_STEPS = 0


class JvPlan(NamedTuple):
    """K1's launch layout for B problems of [R, C] (csrc/jv_assign.cu)."""

    slots: int       # register slots per lane: the n + 1 columns in groups
                     # of 32; 0 = past MAX_N_REG, the block routine
    stride: int      # words of one staged cost row (odd: no bank conflicts)
    per_block: int   # problems per block, one warp each
    smem_bytes: int  # dynamic shared memory per block
    blocks: int
    staged: bool = True  # the cost tile in shared memory, else read from
                         # device memory (where one problem's tile does not
                         # fit a block)
    warps: int = 0       # 0: one warp per problem; past MAX_N_REG one
                         # problem per block of this many warps


def wide_state_bytes(n: int) -> int:
    """The block routine's state for n columns (jv.cuh::
    jv_wide_state_bytes): a float4 and an int per column, a float and a
    byte per row, n + 1 entries rounded up to 16."""
    return 25 * (-(-(n + 1) // 16) * 16)


def block_warps(n: int) -> int:
    """The block routine's warps for n columns (jv.cuh::jv_block_warps):
    ~4 columns per thread, 2 to MAX_BLOCK_WARPS warps."""
    return min(MAX_BLOCK_WARPS, max(2, (n + 128) // 128))


@functools.lru_cache(maxsize=256)
def jv_plan(batch: int, rows: int, cols: int) -> JvPlan:
    """Up to MAX_N_REG columns one warp per problem, as many problems per
    block as WARPS_PER_BLOCK and SMEM_LIMIT allow; past it one problem per
    block of `block_warps(n)` warps. Each problem's shared memory: its cost
    tile [R, stride] float32 where one problem with it fits a block (else
    the cost is read from device memory), and up to MAX_N_REG columns one
    int per column slot (the claims, then the inverse map; the state is in
    registers), past it the warps' posts and the solver state
    (`wide_state_bytes`; the tile after them).
    csrc/jv_assign.cu::problem_bytes computes the same."""
    n = _check_shape(rows, cols)
    stride = cols | 1
    tile = 4 * rows * stride
    warps = 0
    if n <= MAX_N_REG:
        slots = n // 32 + 1
        fixed = 4 * 32 * slots
    else:
        slots = 0
        warps = block_warps(n)
        fixed = BLOCK_POST_BYTES + wide_state_bytes(n)
    staged = fixed + tile <= SMEM_LIMIT
    problem = fixed + tile if staged else fixed
    per_block = 1 if warps else max(1, min(WARPS_PER_BLOCK, batch, SMEM_LIMIT // problem))
    return JvPlan(slots, stride, per_block, per_block * problem, -(-batch // per_block), staged,
                  warps)


def _jv_plain(cost: torch.Tensor, n: int, n_rows: int, row_active=None):
    """The JV core on a [n_rows, n] cost (dummy columns already zero).

    Returns roc [n] int64: the row matched to each column, -1 if free.
    `row_active` [n_rows] bool skips rows (see `linear_sum_assignment`).
    """
    global PLAIN_SEARCH_STEPS
    dev, dt = cost.device, cost.dtype
    inf = torch.tensor(_INF, dtype=dt, device=dev)
    cols = torch.arange(n, device=dev)
    act = (
        torch.ones(n_rows, dtype=torch.bool, device=dev)
        if row_active is None else row_active.to(torch.bool)
    )

    # Row reduction: u = row minima; each active row claims its first
    # argmin column, the lowest claiming row wins.
    rowmin = cost.amin(dim=1)
    amin = torch.argmax((cost == rowmin[:, None]).to(torch.int32), dim=1)
    claim = (amin[:, None] == cols[None, :]) & act[:, None]  # [R, n]
    rows = torch.arange(n_rows, device=dev)
    winner = torch.where(claim, rows[:, None], n_rows).amin(dim=0)
    roc = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    roc[:n] = torch.where(winner < n_rows, winner, -1)
    u = rowmin.clone()
    v = torch.zeros(n + 1, dtype=dt, device=dev)

    for r in range(n_rows):
        if not bool(act[r]) or bool((roc[:n] == r).any()):
            continue
        roc[n] = r
        minv = torch.full((n,), _INF, dtype=dt, device=dev)
        way = torch.full((n,), n, dtype=torch.int64, device=dev)
        used = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        tree = torch.zeros(n_rows, dtype=torch.bool, device=dev)
        j0 = n
        step = 0
        while int(roc[j0]) >= 0 and step <= n + 1:
            i0 = int(roc[j0])
            used[j0] = True
            tree[i0] = True
            cur = cost[i0] - u[i0] - v[:n]
            better = (cur < minv) & ~used[:n]
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(used[:n], inf, minv)
            delta = masked.min()
            j1 = int(torch.argmax((masked == delta).to(torch.int32)))
            u = torch.where(tree, u + delta, u)
            v = torch.where(used, v - delta, v)
            minv = torch.where(~used[:n], minv - delta, minv)
            j0 = j1
            step += 1
        PLAIN_SEARCH_STEPS += step
        j = j0
        step = 0
        while j != n and step <= n + 1:
            jp = int(way[j])
            roc[j] = roc[jp]
            j = jp
            step += 1
    return roc[:n]


def _check_shape(r: int, c: int) -> int:
    """n = max(R, C) if the kernel takes it, else raise."""
    n = max(r, c)
    if n > MAX_N_WIDE:
        raise ValueError(
            f"the assignment kernel supports up to {MAX_N_WIDE} rows/cols, got {n}"
        )
    return n


def linear_sum_assignment_reference(cost: torch.Tensor, row_active=None):
    """Plain PyTorch K1 for one [R, C] problem, of any size: col_of_row [R]
    int32."""
    r, c = cost.shape
    n = max(r, c)
    padded = torch.zeros((r, n), dtype=cost.dtype, device=cost.device)
    padded[:, :c] = cost
    roc = _jv_plain(padded, n, r, row_active)
    col_of_row = torch.full((r,), -1, dtype=torch.int64, device=cost.device)
    matched = (roc >= 0) & (roc < r)
    cols = torch.arange(n, device=cost.device)
    col_of_row[roc[matched]] = cols[matched]
    return torch.where(col_of_row < c, col_of_row, -1).to(torch.int32)


def linear_sum_assignment_batched_reference(cost: torch.Tensor, row_active=None):
    """Plain PyTorch K1 for [B, R, C] problems: col_of_row [B, R] int32."""
    if cost.shape[0] == 0:
        return torch.empty(cost.shape[:2], dtype=torch.int32, device=cost.device)
    return torch.stack([
        linear_sum_assignment_reference(
            cost[b], None if row_active is None else row_active[b]
        )
        for b in range(cost.shape[0])
    ])


def _launch(cost: torch.Tensor, row_active) -> torch.Tensor:
    """K1 on the card: cost [B, R, C] float32 contiguous CUDA tensor, one
    device launch (a bool row_active goes to the kernel as its bytes)."""
    if cost.dtype != torch.float32:
        raise TypeError(f"the CUDA assignment kernel takes float32, got {cost.dtype}")
    if not cost.is_contiguous():
        raise ValueError("cost must be contiguous")
    b, r, c = cost.shape
    plan = jv_plan(max(b, 1), r, c)
    act = None
    if row_active is not None:
        if row_active.shape != (b, r) or row_active.device != cost.device:
            raise ValueError(
                f"row_active must be [{b}, {r}] on {cost.device}, got "
                f"{tuple(row_active.shape)} on {row_active.device}"
            )
        act = row_active if row_active.dtype == torch.bool else row_active != 0
        act = act.contiguous()
    out = torch.empty((b, r), dtype=torch.int32, device=cost.device)
    if b == 0 or r == 0:
        return out
    _kernels.launch(
        "jv_assign", "ses3d_jv_assign", cost.device,
        cost.data_ptr(), None if act is None else act.data_ptr(),
        out.data_ptr(), b, r, c, plan.per_block, plan.smem_bytes, what="jv_assign launch",
    )
    return out


def linear_sum_assignment(cost: torch.Tensor, row_active=None) -> torch.Tensor:
    """Minimum-cost assignment of one [R, C] cost matrix.

    With R <= C every row gets a distinct column; with R > C only C rows
    get columns (dummy zero columns absorb the rest) and the others return
    -1 (hungarian.py:179-205 of the JAX package).

    row_active: optional [R] mask; rows with 0 claim no column in the row
    reduction, skip their augmenting search and return -1. Pass it with
    some rows on only for rows whose assignment the caller discards and
    whose cost rows sit on a tier strictly above every active row's
    entries, and only with R <= C. A problem whose whole result the caller
    discards may turn all its rows off, at any shape: it then runs the row
    reduction and no search, and returns -1 everywhere.

    Returns col_of_row [R] int32, -1 for unassigned rows. CUDA tensors go to
    kernel K1 (one warp per problem up to MAX_N_WIDE columns; wider
    raises), CPU tensors to the plain version (any width).
    """
    if cost.dim() != 2:
        raise ValueError(f"cost must be [R, C], got {tuple(cost.shape)}")
    if cost.device.type == "cpu":
        return linear_sum_assignment_reference(cost, row_active)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    act = None if row_active is None else row_active[None]
    return _launch(cost[None].contiguous(), act)[0]


def linear_sum_assignment_batched(cost: torch.Tensor, row_active=None) -> torch.Tensor:
    """`linear_sum_assignment` over a batch: cost [B, R, C] -> [B, R] int32;
    one launch on the card, one warp per problem (`jv_plan`)."""
    if cost.dim() != 3:
        raise ValueError(f"cost must be [B, R, C], got {tuple(cost.shape)}")
    if cost.device.type == "cpu":
        return linear_sum_assignment_batched_reference(cost, row_active)
    if cost.device.type != "cuda":
        raise ValueError(f"unsupported device {cost.device}")
    return _launch(cost.contiguous(), row_active)
