"""PyTorch + CUDA port of the SmartEdgeSensor3DHumanPose pipeline.

The online per-frame path (`pipeline.Pipeline.step`) and the offline
replay of a recorded sequence (`pipeline.Pipeline.run_offline`): 2D
detections from a synchronized camera array go in; fused, tracked and
predicted 3D skeletons plus per-camera reprojection feedback come out. The
sequential solvers on those paths run as hand-written CUDA kernels on the
card (`ops.hungarian`, `ops.association`, `ops.tracker`, sources in
`csrc/`) and as their plain PyTorch versions on the CPU.

Around them, as in the JAX package: the demo CLI (`demo`, every mode, on
the card unless `--device cpu`), the live loops (`online`: latest-wins, and
per-camera messages through the native approximate-time synchronizer of
`sync` + `native/runtime.cpp`), record and replay (`io.replay`), the closed
feedback loop through virtual sensors (`io.sensors`), tracker checkpoints,
the stage profiler, MPJPE/PCK evaluation, health events and dashboards.

This package imports torch and numpy only; the JAX package
`smartedgesensor3dhumanpose_tpu` is the reference it is tested against.
"""

from smartedgesensor3dhumanpose_tpu_torch.config import (
    FusionConfig,
    PipelineConfig,
    PriorConfig,
    TrackerConfig,
)
from smartedgesensor3dhumanpose_tpu_torch.types import (
    CameraRig,
    Frame,
    Persons3D,
    Reprojection2D,
    TrackerState,
)

__version__ = "0.1.0"

__all__ = [
    "CameraRig",
    "Frame",
    "FusionConfig",
    "Persons3D",
    "PipelineConfig",
    "PriorConfig",
    "Reprojection2D",
    "TrackerConfig",
    "TrackerState",
    "__version__",
]
