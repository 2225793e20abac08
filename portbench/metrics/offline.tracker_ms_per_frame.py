"""Median over the traced calls of the `tracker` stage's device time (the
tracker scan, K3, and its packing) over the call's frames, between its
stage marks (portbench/lib/spans.py)."""

from portbench.lib import spans


def read(ctx):
    return spans.offline_stage(ctx, "tracker")
