"""Median over the traced calls of the `feedback` stage's device time
(`offline_outputs`: the reprojection of every frame, boxes, outputs) over
the call's frames, between its stage marks (portbench/lib/spans.py)."""

from portbench.lib import spans


def read(ctx):
    return spans.offline_stage(ctx, "feedback")
