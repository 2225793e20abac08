"""Rectangular linear-sum assignment (Jonker-Volgenant), plain PyTorch:
a frozen copy of the port's plain version (`ops/hungarian.py`), the same
algorithm and tie rules as kernel K1, a Python loop over tensor ops on
any device and dtype. `PLAIN_SEARCH_STEPS` counts the augmenting-search
steps taken, the data-dependent part of K1's work that its roofline
bound counts (portbench/counts/K1.py).
"""

from __future__ import annotations

import torch

MAX_N = 120
_INF = 3.0e38
# Search steps the plain version has taken.
PLAIN_SEARCH_STEPS = 0


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



def linear_sum_assignment(cost: torch.Tensor, row_active=None) -> torch.Tensor:
    """Minimum-cost assignment of one [R, C] cost matrix: col_of_row [R]
    int32, -1 for unassigned rows (the plain version on any device)."""
    return linear_sum_assignment_reference(cost, row_active)


def linear_sum_assignment_batched(cost: torch.Tensor, row_active=None) -> torch.Tensor:
    """`linear_sum_assignment` over a batch: cost [B, R, C] -> [B, R] int32."""
    return linear_sum_assignment_batched_reference(cost, row_active)
