"""Camera steps the association runs a fusion chunk, from the program's
counter `fusion.association.scan_steps` (one per chunk of the traced
`run_offline`: the cameras on the camera scan, 0 on the fold, absent
where the program counts none)."""

from portbench.lib import spans


def read(ctx):
    prog = spans.program(ctx)
    if prog is None:
        return None
    return spans.counter(prog, "Pipeline.run_offline", "fusion.association.scan_steps")
