"""Kernel K2's share of its roofline in the live step: one frame a launch
(portbench/counts/K2.py), over the median traced launch."""

from portbench.lib import manifest, readers


def read(ctx):
    f = readers.fusion(ctx)
    bound = manifest.kernel_count("K2").bound(1, f["num_cameras"], f["max_dets_per_cam"],
                                      f["max_hypotheses"])
    return readers.roofline(ctx, "K2", [bound])
