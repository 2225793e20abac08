"""Kernel F1's wide variant (csrc/triangulation.cu
`triangulation_wide_kernel`, rigs of 92 to 742 cameras) on `hyps`
hypothesis slots of `cameras` views each: the same function and the same
least work as F1 (portbench/counts/F1.py, whose bound it takes). The
per-view arrays it keeps in device memory between its phases are its own
choice, not work the function needs, and are not counted."""

from portbench.lib import manifest

# The kernel's names in a device trace.
TRACE_NAMES = ("triangulation_wide_kernel",)

_F1 = manifest.kernel_count("F1")
nbytes, ops = _F1.nbytes, _F1.ops


def bound(hyps: int, cameras: int) -> float:
    """Milliseconds one launch over `hyps` slots needs at the least."""
    return _F1.bound(hyps, cameras)
