"""Kernel nodes the traced step graph captured in its `tracking` stage, its
`prior` stage included (the program's counter `tracking.kernels`, the
marks left out)."""

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    return None if prog is None else spans.counter(prog, "Pipeline.step", "tracking.kernels")
