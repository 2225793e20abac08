"""Median device time of the step's `fusion` stage (stale-camera masking
and `fusion.fuse_frame`: normalisation, epipolar table, the association
fold K2, triangulation, gates, merge), between its stage marks on the
device clock, over the program's traced live phase (portbench/lib/spans.py)."""

import numpy as np

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    ms = None if prog is None else spans.stage_ms(prog, "Pipeline.step", "fusion")
    return None if ms is None or not len(ms) else float(np.median(ms))
