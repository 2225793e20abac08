"""Configuration dataclasses (PyTorch port).

The same knob tree as `smartedgesensor3dhumanpose_tpu.config`, with the
defaults of the reference nodes (skeleton_3d_triang_mult_node.cpp:56-64,
pose_prior_mult_node.cpp:46-66). Every value the JAX package accepts runs
here too:

* `FusionConfig.assignment_impl` picks the cross-view association's route
  (`fusion.association_route`, decided once per shape when a `Pipeline` is
  built):
  - "auto" (default, as in JAX): the association fold
    (`ops.association.associate_fold`: kernel K2 on the card, its plain
    version on the CPU) while it fits K2 (hypothesis slots and padded
    detections <= 120, the fold's shared-memory plan), else the camera scan.
    JAX's "auto" takes its fused Pallas fold on the TPU and the camera scan
    elsewhere; the two give the same decisions (they differ only on exactly
    tied solver optima), so the port keeps the fold on the CPU too;
  - "cond_while", "pallas", "unrolled": the camera scan
    (`ops.association.associate_scan`): one camera folded into the
    hypotheses per step, one batched JV per step (kernel K1 on the card, the
    plain JV on the CPU). In JAX the three differ only in how XLA schedules
    the same function;
  - "pallas_scan" (and its alias "kernel"): the fold; a `Pipeline` refuses
    it outside K2's domain;
  - "reference": the plain fold on any device (a test aid).
* `PriorConfig.solver`: "tree" (the level-grouped block elimination of
  `ops.tree_solve`) or "dense" (the equilibrated 63 x 63 Cholesky, JAX's
  oracle / cross-check path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

ASSIGNMENT_IMPLS = (
    "auto", "cond_while", "pallas_scan", "pallas", "unrolled", "kernel", "reference",
)
SOLVERS = ("tree", "dense")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Multi-view association + triangulation stage (reference skeleton_3d)."""

    num_cameras: int = 16
    # Fixed padded sizes: validity masks instead of dynamic vectors.
    max_dets_per_cam: int = 8
    max_hypotheses: int = 16

    pose_method: str = "simple"  # "simple" (COCO-17) or "h36m"
    # Keypoint confidence gate for association / triangulation (:58).
    min_kp_score: float = 0.30
    # Symmetric epipolar gate in normalized image coords (:60).
    max_epipolar_error: float = 0.050
    # Reprojection error gate triggering outlier rejection (:59).
    reproj_error_max_acceptable: float = 0.050
    # Person-level gate on the number of valid fused keypoints (:57).
    min_num_valid_keypoints: int = 9
    # Joints farther than this from the root are dropped (:61).
    max_joint_dist_to_root: float = 2.0
    # Feet must be within +-50cm of the ground plane (:963).
    max_feet_height: float = 0.50
    # Skeletons closer (mean joint distance) than this are merged (:62).
    merge_dist_thresh: float = 0.20
    # Cameras more than this behind the pivot stamp are masked out (:64).
    max_sync_diff: float = 0.067
    # Sigma for the limb-length-model covariance inflation (:149).
    limb_cov_offset_sigma: float = 0.075
    # Unscented-transform scaling for 2D->3D covariance propagation (:475).
    ut_kappa: float = 0.5
    # Cost assigned to infeasible pairings (MAX_COSTS, :43).
    max_cost: float = 1.0e6
    # One of ASSIGNMENT_IMPLS (see the module docstring).
    assignment_impl: str = "auto"

    @property
    def num_input_joints(self) -> int:
        return 17

    @property
    def num_fusion_joints(self) -> int:
        return 21


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Skeleton-model smoothing stage (reference pose_prior, gtsam LM)."""

    pose_method: str = "simple"
    normalize_by_height: bool = False
    # Minimum keypoint score to enter the factor graph (g_min_score, :50).
    min_score: float = 0.10
    # Root unary covariance shrink factor (g_root_sigma_factor, :52).
    root_sigma_factor: float = 100.0
    # Fallback isotropic result sigma when marginals are indeterminate (:48).
    default_res_sigma: float = 0.10
    # Sigma multiplier for limb lengths; None -> 2 if height-normalized else 1.
    limb_sigma_factor: Optional[float] = None
    # Default height when the neck is unobserved in normalized mode (:666).
    default_height: float = 0.60
    # Levenberg-Marquardt schedule (gtsam defaults).
    lm_initial_lambda: float = 1.0e-5
    lm_lambda_factor: float = 10.0
    lm_lambda_upper: float = 1.0e5
    lm_max_iterations: int = 32
    lm_relative_error_tol: float = 1.0e-5
    lm_absolute_error_tol: float = 1.0e-5
    # Linear solver for the LM normal equations + marginals: "tree" or
    # "dense" (see the module docstring).
    solver: str = "tree"

    @property
    def effective_limb_sigma_factor(self) -> float:
        if self.limb_sigma_factor is not None:
            return self.limb_sigma_factor
        return 2.0 if self.normalize_by_height else 1.0


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Temporal track management + velocity prediction (reference pose_prior)."""

    max_tracks: int = 24
    # Tracks die after this many seconds without observation (:62).
    max_unobserved_time: float = 1.0
    # Gate on the velocity-sigma-normalized association distance (:63).
    dist_threshold: float = 5.0
    # Tracks closer than this (mean joint distance) are merged (:64).
    merge_dist_thresh: float = 0.20
    # Number of observations before a track is published (:66).
    min_num_obs: int = 10
    # Moving-average window for velocities and feedback delay (:53).
    n_mov_avg: int = 3
    # Default average pipeline delay seeding the prediction horizon (:51).
    avg_delay: float = 0.10
    # Prediction noise sigma added to predicted covariances (:47).
    pred_noise_sigma: float = 0.12
    # Cost for infeasible track/detection pairings (MAX_DIST, :65).
    max_dist: float = 1.0e6


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full closed-loop pipeline: fusion -> prior/tracking -> reprojection."""

    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    prior: PriorConfig = dataclasses.field(default_factory=PriorConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    # Compute dtype of the hot path ("float32" on the card; the CPU tests
    # also run "float64").
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.fusion.pose_method != self.prior.pose_method:
            raise ValueError(
                "fusion.pose_method and prior.pose_method must agree, got "
                f"{self.fusion.pose_method!r} vs {self.prior.pose_method!r}"
            )
        if self.fusion.assignment_impl not in ASSIGNMENT_IMPLS:
            raise ValueError(
                f"fusion.assignment_impl must be one of {ASSIGNMENT_IMPLS}, "
                f"got {self.fusion.assignment_impl!r}"
            )
        if self.prior.solver not in SOLVERS:
            raise ValueError(
                f"prior.solver must be one of {SOLVERS}, got {self.prior.solver!r}"
            )

    @staticmethod
    def demo_16cam(**overrides) -> "PipelineConfig":
        """The 16-camera / 6-person hall demo configuration
        (pose_triangulate_demo.launch:2-6)."""
        fusion = FusionConfig(num_cameras=16, max_epipolar_error=0.045)
        return PipelineConfig(fusion=fusion, **overrides)

    @staticmethod
    def scaled_64cam(**overrides) -> "PipelineConfig":
        """Scaled synthetic hall: 64 cameras x 25 people."""
        fusion = FusionConfig(
            num_cameras=64,
            max_dets_per_cam=32,
            max_hypotheses=40,
            max_epipolar_error=0.045,
        )
        tracker = TrackerConfig(max_tracks=64)
        return PipelineConfig(fusion=fusion, tracker=tracker, **overrides)
