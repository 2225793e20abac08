"""Neural models: the 2D keypoint detector of the fully-fused end-to-end
variant (images -> heatmaps -> keypoints -> 3D fusion on one card). The
reference runs its 2D CNN on external EdgeTPU sensor boards (README.md:7-11)
and the pipeline normally ingests their detections; this package brings an
equivalent detector onto the card."""
