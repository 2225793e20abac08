"""Kernel F1's share of its roofline in the live step: one frame's
hypothesis slots a launch (portbench/counts/F1.py), over the median
traced launch; nothing where the program has no F1."""

from portbench.lib import manifest, readers


def read(ctx):
    f = readers.fusion(ctx)
    bound = manifest.kernel_count("F1").bound(f["max_hypotheses"], f["num_cameras"])
    return readers.roofline(ctx, "F1", [bound])
