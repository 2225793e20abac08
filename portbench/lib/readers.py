"""What the per-layer metric readers (portbench/metrics/<name>.py) share.

A reader's `read(ctx)` gets the run's spans and counts (`wait_ms`,
`step_ms`, `graph_kernels`, `frames`), its device trace (`trace`, a
trace.TraceData), the data-dependent work the reference counted (`work`)
and the cell (`cell`); it returns a number, or None where the run holds
nothing to read (the harness then leaves the metric out).
"""

from __future__ import annotations

import statistics



def kernel_ms(ctx, key: str):
    """Median device milliseconds of a kernel's traced launches."""
    tr = ctx.get("trace")
    if tr is None or not tr.launches.get(key):
        return None
    return statistics.median(tr.launches[key]) * 1e3


def roofline(ctx, key: str, bounds_ms) -> float | None:
    """Percent of its roofline a kernel reaches: the median launch's bound
    (the median of `bounds_ms`, one per counted launch) over its median
    traced device time."""
    ms = kernel_ms(ctx, key)
    if ms is None or not bounds_ms:
        return None
    return 100.0 * statistics.median(bounds_ms) / ms


def fusion(ctx) -> dict:
    return ctx["cell"].config["pipeline"]["fusion"]
