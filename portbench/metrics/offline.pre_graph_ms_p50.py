"""Median time from a traced offline call's host entry to its graph's first
stage mark on the device (the inputs' copy-in, the graph's launch and the
device's start), on the one clock of the program's tracer
(portbench/lib/spans.py)."""

from portbench.lib import spans


def read(ctx):
    return spans.offline_edges(ctx, before=True)
