"""Median wait of a stepped set in the online loop and sync layer: from
the due time of its newest message to the entry of its step (the native
synchronizer, the latest-wins slot, the consumer's poll and the frame
builder), over the window's stepped sets (host clock)."""

import numpy as np


def read(ctx):
    wait = ctx.get("wait_ms")
    return None if wait is None or not len(wait) else float(np.median(wait))
