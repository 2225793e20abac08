"""Percent of the live steps' host time in which the step graph did not
run on the device: 100 x (1 - the sum of each step's device span, its
first stage mark to its last on the device clock, over the sum of its host
`step` span, entry to the synchronize's return), over the program's traced
live phase (portbench/lib/spans.py). Taken from the program's own marks:
no profiler stretches the host spans."""

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    if prog is None:
        return None
    dev, host = spans.device_and_host_ms(prog, "Pipeline.step", "step")
    return None if not len(dev) else 100.0 * (1.0 - float(dev.sum()) / float(host.sum()))
