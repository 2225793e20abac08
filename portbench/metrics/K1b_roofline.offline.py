"""Kernel K1's share of its roofline as the camera scan's batched solve
(K1b) in the offline replay: one launch a camera step, the chunk's
`fusion_batch` problems of [max_hypotheses, max_dets_per_cam] each
(portbench/counts/K1.py, its bytes and its row reduction; the search
steps, which the reference does not count on the scan, left out: the
least a launch needs), over the median traced launch of K1."""

from portbench.lib import manifest, peaks, readers


def read(ctx):
    f = readers.fusion(ctx)
    k1 = manifest.kernel_count("K1")
    batch = min(int(ctx["cell"].config["fusion_batch"]), ctx["frames"])
    rows, cols = f["max_hypotheses"], f["max_dets_per_cam"]
    bound = peaks.bound_ms(batch * k1.nbytes(rows, cols), batch * k1.ops(rows, cols, 0))
    return readers.roofline(ctx, "K1", [bound])
