"""Median hold of a stepped set in the synchronizer: from the push of its
newest message to the synchronizer's pop that emitted it (the port's live
loop, `sync.hold`; host clock), over the sets of the program's traced live
phase (portbench/lib/spans.py)."""

import numpy as np

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    if prog is None or not len(prog["sets"]):
        return None
    return float(np.median(spans.set_ms(prog, 1, 2)))
