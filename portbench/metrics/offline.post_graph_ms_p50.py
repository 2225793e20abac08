"""Median time from a traced offline call's last stage mark on the device
to the return of the host's synchronize (the outputs' allocation and
copy-out after the graph), on the one clock of the program's tracer
(portbench/lib/spans.py)."""

from portbench.lib import spans


def read(ctx):
    return spans.offline_edges(ctx, before=False)
