"""Median device time of the step's `prior` stage inside `tracking`: the
LM warm start, `prior.optimize` (kernels L1 and L2 and their set-up) and
the denormalisation, between its stage marks on the device clock, over the
program's traced live phase (portbench/lib/spans.py)."""

import numpy as np

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    ms = None if prog is None else spans.stage_ms(prog, "Pipeline.step", "prior")
    return None if ms is None or not len(ms) else float(np.median(ms))
