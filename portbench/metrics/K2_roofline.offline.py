"""Kernel K2's share of its roofline in the offline replay: one fusion
chunk of `fusion_batch` frames a launch (portbench/counts/K2.py), over
the median traced launch."""

from portbench.lib import manifest, readers


def read(ctx):
    f = readers.fusion(ctx)
    batch = min(int(ctx["cell"].config["fusion_batch"]), ctx["frames"])
    bound = manifest.kernel_count("K2").bound(batch, f["num_cameras"], f["max_dets_per_cam"],
                                      f["max_hypotheses"])
    return readers.roofline(ctx, "K2", [bound])
