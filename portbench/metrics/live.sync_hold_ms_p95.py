"""95th percentile of a stepped set's hold in the synchronizer (`sync.hold`:
newest message's push -> the pop that emitted the set; host clock), over
the sets of the program's traced live phase (portbench/lib/spans.py)."""

import numpy as np

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    if prog is None or not len(prog["sets"]):
        return None
    return float(np.percentile(spans.set_ms(prog, 1, 2), 95))
