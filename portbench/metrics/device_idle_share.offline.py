"""Percent of the traced phase (calls back to back) in which the device
ran no kernel, copy or set (the union of the trace's device intervals).
Left out where the trace misses launches the replayed graphs hold."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.complete() or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
