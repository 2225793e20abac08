"""Kernel K1 (csrc/jv_assign.cu, the JV assignment) on the tracker's
problem: a [rows, cols] float32 cost and a row mask read once, one column
index per row written; the row reduction (rows x n compares) and ~4
operations per column of each augmenting-search step, with the steps the
plain reference's JV takes on these inputs (n = max(rows, cols)).
Copied from chip_smoke.py's `k1_bound`, which counted the steps with the
port's own plain JV; here the benchmark's reference counts them.
"""

from portbench.lib.peaks import bound_ms

# The kernel's names in a device trace.
TRACE_NAMES = ("jv_assign_kernel", "jv_assign_wide_kernel")


def nbytes(rows: int, cols: int) -> int:
    return rows * cols * 4 + rows + rows * 4


def ops(rows: int, cols: int, search_steps: int) -> int:
    n = max(rows, cols)
    return rows * n + search_steps * n * 4


def bound(rows: int, cols: int, search_steps: int) -> float:
    """Milliseconds one launch needs at the least."""
    return bound_ms(nbytes(rows, cols), ops(rows, cols, search_steps))
