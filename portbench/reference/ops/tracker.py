"""The offline tracker scan, plain PyTorch: a frozen copy of the port's
plain scan (`ops/tracker.py::tracker_scan_reference`, what kernel K3
computes), `tracking.step` frame by frame with the precomputed smoothing
and the plain JV.
"""

from __future__ import annotations

import torch

from portbench.reference import tracking
from portbench.reference.ops import hungarian
from portbench.reference.types import Persons3D, TrackerState


def _rebuild(like, values):
    """A tuple or NamedTuple of the same type as `like` holding `values`."""
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def _frame(tree, f: int):
    """Frame f of a stacked Persons3D / precomputed tuple (PriorResult's
    iteration count, a 0-d tensor or an int, passes through)."""
    if isinstance(tree, torch.Tensor):
        return tree[f] if tree.dim() else tree
    if isinstance(tree, int):
        return tree
    return _rebuild(tree, [_frame(x, f) for x in tree])


def stack_frames(items):
    """Stack a list of per-frame outputs (TrackStepOutput, StepOutput, any
    tuple tree of tensors) along a new leading frame axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return _rebuild(first, [stack_frames(list(xs)) for xs in zip(*items)])


def tracker_scan_steps(state0: TrackerState, persons: Persons3D, pivots,
                       fb_delay, pre, prior_cfg, cfg, assign):
    """`tracking.step(..., precomputed=pre_t)` frame by frame, each frame's
    assignment solved by `assign`. Arguments and returns as
    `tracker_scan`."""
    dtype = persons.xyz.dtype
    state = state0
    outs = []
    for f in range(pivots.shape[0]):
        state, out = tracking.step(
            state, _frame(persons, f), pivots[f].to(dtype), fb_delay[f],
            prior_cfg, cfg, precomputed=_frame(pre, f), assign=assign,
        )
        outs.append(out)
    return state, stack_frames(outs)


def tracker_scan_reference(state0: TrackerState, persons: Persons3D, pivots,
                           fb_delay, pre, prior_cfg, cfg):
    """Plain PyTorch K3: `tracker_scan_steps` with the plain JV. Arguments
    and returns as `tracker_scan`."""
    return tracker_scan_steps(state0, persons, pivots, fb_delay, pre, prior_cfg,
                              cfg, hungarian.linear_sum_assignment_reference)


tracker_scan = tracker_scan_reference
