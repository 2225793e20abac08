"""Median over the traced calls of the `smoothing` stage's device time
(`smooth_offline`: the cold-start LM per chunk, L1 and L2) over the call's
frames, between its stage marks (portbench/lib/spans.py)."""

from portbench.lib import spans


def read(ctx):
    return spans.offline_stage(ctx, "smoothing")
