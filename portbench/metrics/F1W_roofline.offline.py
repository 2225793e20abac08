"""Kernel F1's wide variant's share of its roofline in the offline replay
of a rig past 91 cameras: the hypothesis slots of one fusion chunk of
`fusion_batch` frames a launch (portbench/counts/F1W.py), over the median
traced launch; nothing where the program has no wide variant."""

from portbench.lib import manifest, readers


def read(ctx):
    f = readers.fusion(ctx)
    batch = min(int(ctx["cell"].config["fusion_batch"]), ctx["frames"])
    bound = manifest.kernel_count("F1W").bound(batch * f["max_hypotheses"], f["num_cameras"])
    return readers.roofline(ctx, "F1W", [bound])
