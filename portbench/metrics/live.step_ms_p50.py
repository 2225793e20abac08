"""Median captured step: from the entry of `Pipeline.step` (copy-in, graph
replay, copy-out) to the return of the device synchronize after it, over
the window's stepped sets (host clock)."""

import numpy as np


def read(ctx):
    step = ctx.get("step_ms")
    return None if step is None or not len(step) else float(np.median(step))
