"""Tracker-state checkpoint / resume.

The reference keeps all tracker state in process memory and loses it on
restart (SURVEY.md: no checkpointing; the disconnected reset() hook,
pose_prior_mult_node.cpp:182-189). The tracker is one NamedTuple of
tensors, so a checkpoint is an NPZ of every field plus a version tag: the
JAX package's format, field for field, so a checkpoint written by either
package resumes in the other. `reset` reproduces the reference's reset()
semantics (fresh tracks, fresh ids, reseeded delay buffer).
"""

from __future__ import annotations

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch.convert import host
from smartedgesensor3dhumanpose_tpu_torch.types import TrackerState

_VERSION = 1
_FIELDS = TrackerState._fields


def save_tracker_state(path: str, state: TrackerState) -> None:
    arrays = {f: host(getattr(state, f)) for f in _FIELDS}
    np.savez_compressed(path, __version__=_VERSION, **arrays)


def load_tracker_state(path: str, dtype=torch.float32, device="cuda") -> TrackerState:
    """The saved state on `device`, float fields in `dtype`."""
    with np.load(path) as z:
        version = int(z["__version__"])
        if version != _VERSION:
            raise ValueError(
                f"tracker checkpoint version {version} != {_VERSION}"
            )
        kwargs = {}
        for f in _FIELDS:
            a = torch.as_tensor(z[f], device=device)
            kwargs[f] = a.to(dtype) if a.is_floating_point() else a
        return TrackerState(**kwargs)


def reset(state: TrackerState, avg_delay: float = 0.10) -> TrackerState:
    """Fresh tracker with the same shapes, dtype and device (reference
    reset(), :182-189).

    The reference reseeds the feedback-delay buffer with the DEFAULT
    g_avg_delay, discarding the learned value
    (pose_prior_mult_node.cpp:186), so `avg_delay` defaults to that
    constant rather than the buffer mean.
    """
    t = state.alive.shape[0]
    w = state.fb_delay_buffer.shape[0]
    return TrackerState.initial(
        t, w, avg_delay, dtype=state.estimate.dtype, device=state.alive.device
    )
