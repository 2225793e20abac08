"""Median device time of the step's `feedback` stage (the reprojection of
the predictions into every camera, the boxes, the outputs), between its
stage marks on the device clock, over the program's traced live phase
(portbench/lib/spans.py)."""

import numpy as np

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    ms = None if prog is None else spans.stage_ms(prog, "Pipeline.step", "feedback")
    return None if ms is None or not len(ms) else float(np.median(ms))
