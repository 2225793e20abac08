"""Kernel K2 (csrc/association_fold.cu, the association fold) on `frames`
frames: the pair-cost table [C, C*D, D], the confident-voter flags and
the usable-detection mask read once, the hypotheses' detection slots and
two counters written once; per frame the fold's camera steps (every
hypothesis against every detection of every earlier camera pair) and its
JV solves at their widest (C*D searches of (h_cap + 1) x h_cap steps of
~4 operations). Copied from kernel_ab.py's `fold_bound`.
"""

from portbench.lib.peaks import bound_ms

# The kernel's names in a device trace.
TRACE_NAMES = ("association_fold_kernel",)


def nbytes(frames: int, cameras: int, dets: int, h_cap: int) -> int:
    c, d = cameras, dets
    return frames * (c * c * d * d * 4 + c * d * 4 + c * d + h_cap * c * 4 + 8)


def ops(frames: int, cameras: int, dets: int, h_cap: int) -> int:
    c, d = cameras, dets
    return frames * (h_cap * d * c * (c - 1) // 2 + c * d * (h_cap + 1) * h_cap * 4)


def bound(frames: int, cameras: int, dets: int, h_cap: int) -> float:
    """Milliseconds one launch over `frames` frames needs at the least."""
    return bound_ms(nbytes(frames, cameras, dets, h_cap), ops(frames, cameras, dets, h_cap))
