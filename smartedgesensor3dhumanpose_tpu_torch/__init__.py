"""PyTorch + CUDA port of the SmartEdgeSensor3DHumanPose pipeline.

The online per-frame path (`pipeline.Pipeline.step`) and the offline
replay of a recorded sequence (`pipeline.Pipeline.run_offline`): 2D
detections from a synchronized camera array go in; fused, tracked and
predicted 3D skeletons plus per-camera reprojection feedback come out. The
sequential solvers on those paths run as hand-written CUDA kernels on the
card (`ops.hungarian`, `ops.association`, `ops.tracker`, sources in
`csrc/`) and as their plain PyTorch versions on the CPU.

This package imports torch and numpy only; the JAX package
`smartedgesensor3dhumanpose_tpu` is the reference it is tested against.
"""

from smartedgesensor3dhumanpose_tpu_torch.config import (  # noqa: F401
    FusionConfig,
    PipelineConfig,
    PriorConfig,
    TrackerConfig,
)
