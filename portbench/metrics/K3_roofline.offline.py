"""Kernel K3's share of its roofline in the offline replay (one launch per
call): the bound of the checked call's sequence, with its valid persons
and detection frames (portbench/counts/K3.py), over the median traced
launch."""

from portbench.lib import manifest, readers


def read(ctx):
    w, cfg = ctx["work"], ctx["cell"].config["pipeline"]
    if "valid_persons" not in w:
        return None
    bound = manifest.kernel_count("K3").bound(
        w["frames"], cfg["fusion"]["max_hypotheses"], cfg["tracker"]["max_tracks"],
        cfg["tracker"]["n_mov_avg"], w["valid_persons"], w["detection_frames"])
    return readers.roofline(ctx, "K3", [bound])
