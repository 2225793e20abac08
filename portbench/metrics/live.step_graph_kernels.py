"""Kernel nodes at the top level of the captured step's CUDA graph
(cuGraphGetNodes, as chip_smoke.py's `graph_nodes` reads them): the
launch-bound work of a step."""


def read(ctx):
    return ctx.get("graph_kernels")
