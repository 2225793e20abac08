"""Kernel K1's share of its roofline in the live step (the track
assignment): the bound of each assignment the reference solved on the
sampled steps, with its search steps (portbench/counts/K1.py); the
median bound over the median traced launch."""

from portbench.lib import manifest, readers


def read(ctx):
    k1 = manifest.kernel_count("K1")
    bounds = [k1.bound(r, c, steps) for r, c, steps in ctx["work"].get("assignments", ())]
    return readers.roofline(ctx, "K1", bounds)
