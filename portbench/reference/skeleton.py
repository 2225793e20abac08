"""Skeleton model tables as constant arrays.

Re-encodes the reference's skeleton data as NumPy constants (the same tables
as the JAX package's skeleton.py) consumed by the pipeline stages:

* the canonical 21-joint "fusion" skeleton
  (reference skeleton_3d/include/skeleton_3d/fusion_body_parts.h:4-33),
* the two 17-joint input models, COCO-order "simple" and H36M
  (skeleton_3d_triang_mult_node.cpp:81-145),
* the bone-length prior factor tables of the smoothing stage
  (pose_prior_mult_node.cpp:384-481).

These are calibration *data* (H36M statistics / COCO OKS sigmas), kept
numerically identical to the reference for output parity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# --------------------------------------------------------------------------
# 21-joint fusion skeleton (fusion_body_parts.h)
# --------------------------------------------------------------------------

NOSE, NECK, RSHOULDER, RELBOW, RWRIST = 0, 1, 2, 3, 4
LSHOULDER, LELBOW, LWRIST, MIDHIP = 5, 6, 7, 8
RHIP, RKNEE, RANKLE, LHIP, LKNEE, LANKLE = 9, 10, 11, 12, 13, 14
REYE, LEYE, REAR, LEAR, HEAD, BELLY = 15, 16, 17, 18, 19, 20
NUM_FUSION_JOINTS = 21

FUSION_JOINT_NAMES = (
    "Nose", "Neck", "RShoulder", "RElbow", "RWrist",
    "LShoulder", "LElbow", "LWrist", "MidHip",
    "RHip", "RKnee", "RAnkle", "LHip", "LKnee", "LAnkle",
    "REye", "LEye", "REar", "LEar", "Head", "Belly",
)

# Parent tree, mean limb lengths (m, H36M statistics) and gating thresholds
# (fusion_body_parts.h:27-30).
FUSION_PARENT = np.array(
    [-1, 0, 1, 2, 3, 1, 5, 6, 20, 1, 9, 10, 1, 12, 13, 0, 0, 15, 16, 0, 1],
    dtype=np.int32,
)
FUSION_LIMB_LENGTH = np.array(
    [-1, 0.20, 0.15, 0.28, 0.25, 0.15, 0.28, 0.25, 0.24, 0.48, 0.45, 0.445,
     0.48, 0.45, 0.445, 0.05, 0.05, 0.10, 0.10, 0.12, 0.26],
    dtype=np.float64,
)
FUSION_LIMB_THRESH = np.array(
    [-1, 0.20, 0.15, 0.25, 0.25, 0.15, 0.25, 0.25, 0.25, 0.40, 0.40, 0.40,
     0.40, 0.40, 0.40, 0.10, 0.10, 0.15, 0.15, 0.15, 0.25],
    dtype=np.float64,
)
HIP_DIST, HIP_DIST_THRESH = 0.27, 0.25

# COCO OKS sigmas mapped onto the fusion joint set (fusion_body_parts.h:32).
FUSION_OKS_SIGMAS = np.array(
    [0.026, 0.079, 0.079, 0.072, 0.062, 0.079, 0.072, 0.062, 0.107, 0.107,
     0.087, 0.089, 0.107, 0.087, 0.089, 0.025, 0.025, 0.035, 0.035, 0.079,
     0.107],
    dtype=np.float64,
)
# Per-joint velocity sigmas (m/s) for track-association gating
# (fusion_body_parts.h:33).
FUSION_VEL_SIGMAS = np.array(
    [2.0, 1.0, 1.0, 2.0, 3.0, 1.0, 2.0, 3.0, 1.0, 1.0, 2.0, 3.0, 1.0, 2.0,
     3.0, 2.0, 2.0, 2.0, 2.0, 2.0, 1.0],
    dtype=np.float64,
)


# --------------------------------------------------------------------------
# 17-joint input models (skeleton_3d_triang_mult_node.cpp:81-145)
# --------------------------------------------------------------------------

NUM_INPUT_JOINTS = 17


@dataclasses.dataclass(frozen=True)
class InputModel:
    """One of the two 17-joint 2D detector joint layouts."""

    name: str
    parent: np.ndarray          # [17] parent joint index in the same layout
    limb_length: np.ndarray     # [17] mean length to parent (m), -1 = undefined
    limb_sigma: np.ndarray      # [17] sigma of the limb length, -1 = undefined
    to_fusion: np.ndarray       # [17] index into the 21-joint fusion layout
    # "simple" has no neck joint; the shoulder pair gets a special
    # limb-length check (RShoulder <-> LShoulder, :103,875-882).
    shoulder_pair: tuple        # (r_idx, l_idx) or (-1, -1)
    shoulder_dist: float
    shoulder_sigma: float


# COCO-order "simple" model (EdgeTPU_BodyParts_Simple, :81-109).
SIMPLE_MODEL = InputModel(
    name="simple",
    parent=np.array(
        [-1, 0, 0, 1, 2, 0, 0, 5, 6, 7, 8, 5, 6, 11, 12, 13, 14],
        dtype=np.int32,
    ),
    limb_length=np.array(
        [-1, 0.05, 0.05, 0.10, 0.10, -1, -1, 0.28, 0.28, 0.25, 0.25, 0.50,
         0.50, 0.45, 0.45, 0.446, 0.446],
        dtype=np.float64,
    ),
    limb_sigma=np.array(
        [-1, 0.05, 0.05, 0.05, 0.05, -1, -1, 0.10, 0.10, 0.10, 0.10, 0.15,
         0.15, 0.10, 0.10, 0.10, 0.10],
        dtype=np.float64,
    ),
    # COCO order: nose, leye, reye, lear, rear, lsho, rsho, lelb, relb,
    # lwri, rwri, lhip, rhip, lkne, rkne, lank, rank  (:139-142).
    to_fusion=np.array(
        [NOSE, LEYE, REYE, LEAR, REAR, LSHOULDER, RSHOULDER, LELBOW, RELBOW,
         LWRIST, RWRIST, LHIP, RHIP, LKNEE, RKNEE, LANKLE, RANKLE],
        dtype=np.int32,
    ),
    shoulder_pair=(6, 5),  # (RShoulder, LShoulder) in COCO order
    shoulder_dist=0.35,
    shoulder_sigma=0.15,
)

# H36M-order model (EdgeTPU_BodyParts_H36M, :111-137).
H36M_MODEL = InputModel(
    name="h36m",
    parent=np.array(
        [-1, 0, 0, 2, 3, 2, 2, 5, 6, 7, 8, 4, 4, 11, 12, 13, 14],
        dtype=np.int32,
    ),
    limb_length=np.array(
        [-1, 0.115, 0.116, 0.255, 0.238, 0.149, 0.149, 0.28, 0.28, 0.25,
         0.25, 0.134, 0.134, 0.449, 0.449, 0.446, 0.446],
        dtype=np.float64,
    ),
    limb_sigma=np.array(
        [-1, 0.07, 0.07, 0.15, 0.15, 0.10, 0.10, 0.15, 0.15, 0.15, 0.15,
         0.10, 0.10, 0.20, 0.20, 0.20, 0.20],
        dtype=np.float64,
    ),
    # H36M order: nose, head, neck, belly, root, lsho, rsho, lelb, relb,
    # lwri, rwri, lhip, rhip, lkne, rkne, lank, rank  (:143-145).
    to_fusion=np.array(
        [NOSE, HEAD, NECK, BELLY, MIDHIP, LSHOULDER, RSHOULDER, LELBOW,
         RELBOW, LWRIST, RWRIST, LHIP, RHIP, LKNEE, RKNEE, LANKLE, RANKLE],
        dtype=np.int32,
    ),
    shoulder_pair=(-1, -1),
    shoulder_dist=-1.0,
    shoulder_sigma=-1.0,
)

INPUT_MODELS = {"simple": SIMPLE_MODEL, "h36m": H36M_MODEL}


def input_model(pose_method: str) -> InputModel:
    try:
        return INPUT_MODELS[pose_method]
    except KeyError:
        raise ValueError(
            f"unknown pose_method {pose_method!r}; expected 'simple' or 'h36m'"
        ) from None


# --------------------------------------------------------------------------
# Bone-length prior factor tables (pose_prior_mult_node.cpp:384-481)
# --------------------------------------------------------------------------
# Rows: (joint_i, joint_j, mean_length, sigma). Sigma is multiplied by the
# config's limb_sigma_factor at graph build time. A bone factor is active only
# when both endpoints are measured; the MidHip<->Neck bone (the "spine" of the
# COCO model) additionally requires the Belly joint to be *unmeasured*
# (:422-423,470-471).

_BONES_COMMON = [
    (MIDHIP, RHIP), (MIDHIP, LHIP),
    (RHIP, RKNEE), (RKNEE, RANKLE), (LHIP, LKNEE), (LKNEE, LANKLE),
    (NECK, NOSE), (NECK, RSHOULDER), (NECK, LSHOULDER),
    (RSHOULDER, RELBOW), (RELBOW, RWRIST),
    (LSHOULDER, LELBOW), (LELBOW, LWRIST),
    # H36M-only chain
    (MIDHIP, BELLY), (BELLY, NECK), (NOSE, HEAD),
    # Simple-baselines-only chain (spine handled separately; see below)
    (NOSE, REYE), (NOSE, LEYE), (REYE, REAR), (LEYE, LEAR),
    # Spine bone: MidHip <-> Neck, gated on NOT Belly. Kept LAST.
    (MIDHIP, NECK),
]

# Absolute bone lengths in meters (:433-480).
_BONE_LEN_ABS = [0.134, 0.134, 0.449, 0.446, 0.449, 0.446, 0.20, 0.15, 0.15,
                 0.28, 0.25, 0.28, 0.25, 0.23846, 0.25534, 0.11500,
                 0.05, 0.05, 0.10, 0.10, 0.50]
_BONE_SIG_ABS = [0.033, 0.033, 0.051, 0.051, 0.051, 0.051, 0.025, 0.042,
                 0.042, 0.045, 0.063, 0.045, 0.063, 0.071, 0.035, 0.035,
                 0.035, 0.035, 0.05, 0.05, 0.071]

# Height-normalized bone lengths (:385-431).
_BONE_LEN_NORM = [0.17, 0.17, 0.694, 0.708, 0.694, 0.708, 0.33, 0.262, 0.262,
                  0.515, 0.444, 0.515, 0.444, 0.49, 0.51, 0.23,
                  0.085, 0.085, 0.167, 0.167, 1.000]
_BONE_SIG_NORM = [0.062, 0.062, 0.111, 0.097, 0.111, 0.097, 0.050, 0.092,
                  0.092, 0.071, 0.084, 0.071, 0.084, 0.05, 0.05, 0.05,
                  0.06, 0.06, 0.08, 0.08, 0.02]

NUM_BONES = len(_BONES_COMMON)
BONE_I = np.array([b[0] for b in _BONES_COMMON], dtype=np.int32)
BONE_J = np.array([b[1] for b in _BONES_COMMON], dtype=np.int32)
BONE_LENGTH_ABS = np.array(_BONE_LEN_ABS, dtype=np.float64)
BONE_SIGMA_ABS = np.array(_BONE_SIG_ABS, dtype=np.float64)
BONE_LENGTH_NORM = np.array(_BONE_LEN_NORM, dtype=np.float64)
BONE_SIGMA_NORM = np.array(_BONE_SIG_NORM, dtype=np.float64)
# Index of the spine bone that is disabled when Belly is measured.
SPINE_BONE_IDX = NUM_BONES - 1

assert len(_BONE_LEN_ABS) == NUM_BONES
assert len(_BONE_SIG_ABS) == NUM_BONES
assert len(_BONE_LEN_NORM) == NUM_BONES
assert len(_BONE_SIG_NORM) == NUM_BONES


def bone_tables(normalize_by_height: bool, limb_sigma_factor: float):
    """Return (bone_i, bone_j, lengths, sigmas) for the chosen mode."""
    if normalize_by_height:
        lengths, sigmas = BONE_LENGTH_NORM, BONE_SIGMA_NORM
    else:
        lengths, sigmas = BONE_LENGTH_ABS, BONE_SIGMA_ABS
    return BONE_I, BONE_J, lengths, sigmas * limb_sigma_factor


# --------------------------------------------------------------------------
# Rendering helpers (limb list for 2D/3D visualization, C23 equivalent)
# --------------------------------------------------------------------------

# COCO limb pairs used by the reference's pose2D_plot_node.py for overlays.
COCO_LIMB_PAIRS = np.array(
    [(0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),
     (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14), (14, 16)],
    dtype=np.int32,
)
