"""Kernel nodes the traced `run_offline` graph captured in its `fusion`
stage (the program's counter `fusion.kernels`, the marks left out), over
the frames of the sequence it replays."""

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    n = None if prog is None else spans.counter(prog, "Pipeline.run_offline", "fusion.kernels")
    return None if n is None else n / prog["frames"]
