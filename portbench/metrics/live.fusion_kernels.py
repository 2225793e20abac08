"""Kernel nodes the traced step graph captured in its `fusion` stage (the
program's counter `fusion.kernels`, top-level kernel nodes between the
stage's marks, the marks left out)."""

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    return None if prog is None else spans.counter(prog, "Pipeline.step", "fusion.kernels")
