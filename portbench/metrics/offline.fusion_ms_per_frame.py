"""Median over the traced calls of the `fusion` stage's device time
(`fuse_offline`: every chunk's masking and fusion, K2 per chunk) over the
call's frames, between its stage marks (portbench/lib/spans.py)."""

from portbench.lib import spans


def read(ctx):
    return spans.offline_stage(ctx, "fusion")
