"""Median hand-off of a stepped set: from the synchronizer's pop to its
step's entry, i.e. `sync.pack` + `slot` (put -> take) + `frame.build`
(host clock), over the sets of the program's traced live phase
(portbench/lib/spans.py)."""

import numpy as np

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    if prog is None or not len(prog["sets"]):
        return None
    return float(np.median(spans.set_ms(prog, 2, 5)))
