"""Kernel nodes at the top level of the captured `run_offline` graph,
over the frames of the sequence it replays."""


def read(ctx):
    nodes = ctx.get("graph_kernels")
    return None if nodes is None else nodes / ctx["frames"]
