"""Kernel L1's share of its roofline in the offline replay (one launch per
fusion chunk): the bound of each chunk's LM as the reference ran it on
the checked call, with its persons' trips (portbench/counts/L1.py); the
median bound over the median traced launch."""

from portbench.lib import manifest, readers


def read(ctx):
    l1 = manifest.kernel_count("L1")
    bounds = [l1.bound(p, running, trips) for p, running, trips in ctx["work"].get("lm_runs", ())]
    return readers.roofline(ctx, "L1", bounds)
