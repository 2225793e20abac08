"""Median device self time of the step's `tracking` stage (`tracking.step`:
assignment K1, spawn and decay, velocity rings, prediction, the merge
loop, the publish gate) less its `prior` stage, between its stage marks on
the device clock, over the program's traced live phase
(portbench/lib/spans.py)."""

import numpy as np

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    if prog is None:
        return None
    ms = spans.stage_ms(prog, "Pipeline.step", "tracking", self_time=True)
    return float(np.median(ms)) if len(ms) else None
