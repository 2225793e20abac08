"""Synthetic multi-camera pose scene generator (pure NumPy).

The same generator as `smartedgesensor3dhumanpose_tpu.io.synthetic`, draw
for draw: the same seed gives bit-identical arrays in both packages.

The reference is demoed against `poses2D_16cam.bag` (16 cameras, 6 people —
README.md:41-45), which is hosted externally. This module generates an
equivalent synthetic hall scene with exact ground truth: articulated 17-joint
skeletons walking through the capture volume, projected into every camera
with configurable noise, per-keypoint covariance, confidence jitter, dropped
joints and dropped detections. Used by the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np

from portbench.reference import cameras as cameras_lib
from portbench.reference.types import CameraRig


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    num_cameras: int = 16
    num_people: int = 6
    num_frames: int = 100
    frame_rate: float = 30.0
    # Hall extents (people wander inside this box, meters, base frame).
    area: Tuple[float, float] = (4.0, 4.0)
    walk_speed: float = 1.0  # m/s
    # Observation model.
    pixel_noise: float = 1.5  # std of added 2D noise (pixels)
    conf_range: Tuple[float, float] = (0.45, 0.98)
    keypoint_dropout: float = 0.05  # per-joint missing probability
    detection_dropout: float = 0.02  # per-person-per-camera missing prob
    # Camera timing jitter (seconds) around the nominal frame time.
    stamp_jitter: float = 0.004
    # Permute detection slots independently per camera (real detectors emit
    # people in arbitrary order; association must not rely on alignment).
    shuffle_detections: bool = True
    # 17-joint layout emitted: "simple" (COCO order) or "h36m".
    pose_method: str = "simple"
    # ---- adversarial detector noise (all off by default) ----
    # False positives: extra ghost-detection slots per camera, each occupied
    # with this probability per frame. A ghost is a plausible-looking
    # skeleton visible in ONE camera only (no cross-view consistency) — the
    # input the reference's veto accumulation exists to reject
    # (skeleton_3d_triang_mult_node.cpp:344-381).
    num_ghost_slots: int = 0
    ghost_rate: float = 0.0
    # Identity-swap noise: probability per (frame, camera) that a random
    # subset of joints is exchanged between two detections (detector
    # cross-person confusion; stresses per-joint outlier rejection).
    identity_swap_rate: float = 0.0
    # Correlated occlusions: this many events, each hiding one person from a
    # contiguous arc of ~1/3 of the cameras for a multi-frame window
    # (structural, not i.i.d., dropout).
    occlusion_events: int = 0
    seed: int = 0


# Canonical standing pose offsets for the 17 COCO joints relative to the
# mid-hip (x right, y forward, z up), roughly human-proportioned.
_COCO_POSE = np.array(
    [
        (0.00, 0.07, 0.62),   # nose
        (-0.03, 0.06, 0.66),  # left eye
        (0.03, 0.06, 0.66),   # right eye
        (-0.08, 0.02, 0.64),  # left ear
        (0.08, 0.02, 0.64),   # right ear
        (-0.18, 0.00, 0.48),  # left shoulder
        (0.18, 0.00, 0.48),   # right shoulder
        (-0.22, 0.02, 0.22),  # left elbow
        (0.22, 0.02, 0.22),   # right elbow
        (-0.24, 0.05, -0.02), # left wrist
        (0.24, 0.05, -0.02),  # right wrist
        (-0.10, 0.00, 0.00),  # left hip
        (0.10, 0.00, 0.00),   # right hip
        (-0.11, 0.02, -0.45), # left knee
        (0.11, 0.02, -0.45),  # right knee
        (-0.12, 0.04, -0.88), # left ankle
        (0.12, 0.04, -0.88),  # right ankle
    ]
)
_HIP_HEIGHT = 0.92


def _coco_to_h36m(coco_pose: np.ndarray) -> np.ndarray:
    """Derive the 17-joint H36M layout from a COCO-order pose.

    H36M order: nose, head, neck, belly, root(mid-hip), lsho, rsho, lelb,
    relb, lwri, rwri, lhip, rhip, lkne, rkne, lank, rank (reference
    EdgeTPU_BodyParts_H36M, skeleton_3d_triang_mult_node.cpp:111-137).
    """
    nose = coco_pose[0]
    lsho, rsho = coco_pose[5], coco_pose[6]
    lhip, rhip = coco_pose[11], coco_pose[12]
    neck = 0.5 * (lsho + rsho)
    root = 0.5 * (lhip + rhip)
    head = nose + np.array([0.0, -0.04, 0.10])
    belly = root + 0.45 * (neck - root)
    return np.stack(
        [
            nose, head, neck, belly, root,
            lsho, rsho, coco_pose[7], coco_pose[8], coco_pose[9],
            coco_pose[10], lhip, rhip, coco_pose[13], coco_pose[14],
            coco_pose[15], coco_pose[16],
        ]
    )


def _person_trajectories(cfg: SceneConfig, rng: np.random.Generator):
    """Smooth random-walk trajectories for each person, [T, P, 2]."""
    t = cfg.num_frames
    p = cfg.num_people
    dt = 1.0 / cfg.frame_rate
    pos = np.zeros((t, p, 2))
    ax, ay = cfg.area
    pos[0] = rng.uniform([-ax / 2, -ay / 2], [ax / 2, ay / 2], size=(p, 2))
    heading = rng.uniform(0, 2 * np.pi, size=p)
    for ti in range(1, t):
        heading += rng.normal(0, 0.3, size=p)
        step = cfg.walk_speed * dt
        nxt = pos[ti - 1] + step * np.stack(
            [np.cos(heading), np.sin(heading)], axis=-1
        )
        # Bounce off the walls.
        for d, lim in enumerate((ax / 2, ay / 2)):
            over = np.abs(nxt[:, d]) > lim
            heading[over] = np.pi - heading[over] if d == 0 else -heading[over]
            nxt[:, d] = np.clip(nxt[:, d], -lim, lim)
        pos[ti] = nxt
    return pos


def generate_scene(cfg: SceneConfig, rig: Optional[CameraRig] = None):
    """Generate ground-truth skeletons and noisy per-camera 2D observations.

    Returns a dict of NumPy arrays:
      gt_xyz:      [T, P, 17, 3] ground-truth joints (base frame).
      kp2d:        [T, C, P, 17, 3] pixel observations (x, y, conf);
                   conf = 0 where dropped.
      cov2d:       [T, C, P, 17, 3] packed 2x2 pixel covariance (xx, xy, yy).
      det_valid:   [T, C, P] bool.
      det_score:   [T, C, P].
      cam_stamp:   [T, C] per-camera timestamps (s).
      fb_delay:    [T, C] simulated measured feedback delay (s).
    plus the rig (built if not supplied).
    """
    rng = np.random.default_rng(cfg.seed)
    if rig is None:
        # Only the rig's numbers are read, on the host.
        rig = cameras_lib.hall_rig(cfg.num_cameras, device="cpu")
    P_mat = rig.P.detach().cpu().numpy().astype(np.float64)
    K = rig.K.detach().cpu().numpy().astype(np.float64)
    size = rig.image_size.detach().cpu().numpy().astype(np.float64)
    t, c, p = cfg.num_frames, cfg.num_cameras, cfg.num_people

    traj = _person_trajectories(cfg, rng)
    scale = rng.uniform(0.9, 1.1, size=p)
    phase = rng.uniform(0, 2 * np.pi, size=p)

    gt = np.zeros((t, p, 17, 3))
    times = np.arange(t) / cfg.frame_rate
    for ti in range(t):
        # Light arm/leg swing animation so joints move relative to the root.
        swing = 0.08 * np.sin(2 * np.pi * 1.5 * times[ti] + phase)
        for pi in range(p):
            pose = _COCO_POSE * scale[pi]
            pose = pose.copy()
            pose[[7, 9], 1] += swing[pi]    # left arm
            pose[[8, 10], 1] -= swing[pi]   # right arm
            pose[[13, 15], 1] -= 0.5 * swing[pi]
            pose[[14, 16], 1] += 0.5 * swing[pi]
            root = np.array(
                [traj[ti, pi, 0], traj[ti, pi, 1], _HIP_HEIGHT * scale[pi]]
            )
            joints = root + pose
            if cfg.pose_method == "h36m":
                joints = _coco_to_h36m(joints)
            gt[ti, pi] = joints

    kp2d = np.zeros((t, c, p, 17, 3), np.float32)
    cov2d = np.zeros((t, c, p, 17, 3), np.float32)
    det_valid = np.zeros((t, c, p), bool)
    det_score = np.zeros((t, c, p), np.float32)

    # Project everything at once: [T, C, P, 17]
    gt_h = np.concatenate([gt, np.ones((t, p, 17, 1))], axis=-1)
    cam_pts = np.einsum("cij,tpkj->tcpki", P_mat, gt_h)
    z = cam_pts[..., 2]
    in_front = z > 0.1
    with np.errstate(all="ignore"):
        px = K[None, :, None, None, 0] * cam_pts[..., 0] / z + K[
            None, :, None, None, 2
        ]
        py = K[None, :, None, None, 1] * cam_pts[..., 1] / z + K[
            None, :, None, None, 3
        ]
    in_img = (
        in_front
        & (px >= 0)
        & (px < size[None, :, None, None, 0])
        & (py >= 0)
        & (py < size[None, :, None, None, 1])
    )

    noise = rng.normal(0, cfg.pixel_noise, size=(t, c, p, 17, 2))
    conf = rng.uniform(*cfg.conf_range, size=(t, c, p, 17)).astype(np.float32)
    kp_drop = rng.uniform(size=(t, c, p, 17)) < cfg.keypoint_dropout
    det_drop = rng.uniform(size=(t, c, p)) < cfg.detection_dropout

    visible = in_img & ~kp_drop & ~det_drop[..., None]

    # Correlated occlusions: person x camera-arc x frame-window blocks.
    for _ in range(cfg.occlusion_events):
        pi = int(rng.integers(0, p))
        f0 = int(rng.integers(0, max(1, t - 4)))
        # 4-16 frame windows, clamped for short scenes (t - f0 can be < 4).
        hi = min(16, t - f0)
        dur = int(rng.integers(min(4, hi), hi + 1))
        c0 = int(rng.integers(0, c))
        arc = max(1, c // 3)
        cams = (c0 + np.arange(arc)) % c
        visible[f0 : f0 + dur, cams, pi, :] = False

    kp2d[..., 0] = np.where(visible, px + noise[..., 0], 0.0)
    kp2d[..., 1] = np.where(visible, py + noise[..., 1], 0.0)
    kp2d[..., 2] = np.where(visible, conf, 0.0)

    sigma = cfg.pixel_noise if cfg.pixel_noise > 0 else 1.0
    cov2d[..., 0] = np.where(visible, sigma**2, 0.0)
    cov2d[..., 2] = np.where(visible, sigma**2, 0.0)

    # Identity-swap noise: exchange a random joint subset between two
    # detections of the same camera (before scores are derived).
    if cfg.identity_swap_rate > 0 and p >= 2:
        for ti in range(t):
            for ci in range(c):
                if rng.uniform() >= cfg.identity_swap_rate:
                    continue
                cand = np.nonzero(visible[ti, ci].any(axis=-1))[0]
                if cand.size < 2:
                    continue
                a, b = rng.choice(cand, size=2, replace=False)
                jsel = rng.uniform(size=17) < rng.uniform(0.2, 0.6)
                if not jsel.any():
                    continue
                for arr in (kp2d, cov2d):
                    tmp = arr[ti, ci, a, jsel].copy()
                    arr[ti, ci, a, jsel] = arr[ti, ci, b, jsel]
                    arr[ti, ci, b, jsel] = tmp
                tmp = visible[ti, ci, a, jsel].copy()
                visible[ti, ci, a, jsel] = visible[ti, ci, b, jsel]
                visible[ti, ci, b, jsel] = tmp

    det_valid[:] = np.sum(visible, axis=-1) > 0
    # Person score: mean confidence of valid joints.
    with np.errstate(invalid="ignore"):
        conf_now = kp2d[..., 2]
        mean_conf = np.sum(
            np.where(visible, conf_now, 0.0), axis=-1
        ) / np.maximum(np.sum(visible, axis=-1), 1)
    det_score[:] = np.where(det_valid, mean_conf, 0.0).astype(np.float32)

    # False positives: ghost skeletons visible in exactly one camera.
    if cfg.num_ghost_slots > 0:
        g = cfg.num_ghost_slots
        g_kp = np.zeros((t, c, g, 17, 3), np.float32)
        g_cov = np.zeros((t, c, g, 17, 3), np.float32)
        g_valid = rng.uniform(size=(t, c, g)) < cfg.ghost_rate
        g_score = np.zeros((t, c, g), np.float32)
        ax, ay = cfg.area
        for ti in range(t):
            for ci in range(c):
                for gi in range(g):
                    if not g_valid[ti, ci, gi]:
                        continue
                    root = np.array([
                        rng.uniform(-ax / 2, ax / 2),
                        rng.uniform(-ay / 2, ay / 2),
                        _HIP_HEIGHT,
                    ])
                    joints = root + _COCO_POSE * rng.uniform(0.9, 1.1)
                    if cfg.pose_method == "h36m":
                        joints = _coco_to_h36m(joints)
                    jh = np.concatenate([joints, np.ones((17, 1))], axis=-1)
                    cp = jh @ P_mat[ci].T
                    z = cp[:, 2]
                    ok = z > 0.1
                    with np.errstate(all="ignore"):
                        gx = K[ci, 0] * cp[:, 0] / z + K[ci, 2]
                        gy = K[ci, 1] * cp[:, 1] / z + K[ci, 3]
                    ok &= (
                        (gx >= 0) & (gx < size[ci, 0])
                        & (gy >= 0) & (gy < size[ci, 1])
                    )
                    if ok.sum() <= 17 // 2:  # too few joints to matter
                        g_valid[ti, ci, gi] = False
                        continue
                    gc = rng.uniform(*cfg.conf_range, size=17).astype(
                        np.float32
                    )
                    g_kp[ti, ci, gi, :, 0] = np.where(
                        ok, gx + rng.normal(0, cfg.pixel_noise, 17), 0.0
                    )
                    g_kp[ti, ci, gi, :, 1] = np.where(
                        ok, gy + rng.normal(0, cfg.pixel_noise, 17), 0.0
                    )
                    g_kp[ti, ci, gi, :, 2] = np.where(ok, gc, 0.0)
                    g_cov[ti, ci, gi, :, 0] = np.where(ok, sigma**2, 0.0)
                    g_cov[ti, ci, gi, :, 2] = np.where(ok, sigma**2, 0.0)
                    g_score[ti, ci, gi] = gc[ok].mean()
        kp2d = np.concatenate([kp2d, g_kp], axis=2)
        cov2d = np.concatenate([cov2d, g_cov], axis=2)
        det_valid = np.concatenate([det_valid, g_valid], axis=2)
        det_score = np.concatenate([det_score, g_score], axis=2)
        p_total = p + g
    else:
        p_total = p

    if cfg.shuffle_detections:
        for ti in range(t):
            for ci in range(c):
                perm = rng.permutation(p_total)
                kp2d[ti, ci] = kp2d[ti, ci, perm]
                cov2d[ti, ci] = cov2d[ti, ci, perm]
                det_valid[ti, ci] = det_valid[ti, ci, perm]
                det_score[ti, ci] = det_score[ti, ci, perm]

    nominal = times[:, None] + np.zeros((t, c))
    cam_stamp = nominal + rng.normal(0, cfg.stamp_jitter, size=(t, c))
    # OPEN-loop placeholder feedback delay (nominal 0.1 s, the reference's
    # assumed default, skeleton_3d_triang_mult_node.cpp:63). The genuine
    # closed-loop path measures this instead: io.sensors.VirtualSensorArray
    # receives each frame's Reprojection2D feedback and overrides fb_delay
    # with the sensor-measured round-trip (demo --closed-loop /
    # io.sensors.run_closed_loop).
    fb_delay = np.full((t, c), 0.1, np.float32) + rng.normal(
        0, 0.01, size=(t, c)
    ).astype(np.float32)

    return {
        "gt_xyz": gt,
        "kp2d": kp2d,
        "cov2d": cov2d,
        "det_valid": det_valid,
        "det_score": det_score,
        "cam_stamp": cam_stamp,
        "fb_delay": fb_delay,
        "rig": rig,
        "config": cfg,
    }


def frames_from_scene(scene, dtype=np.float32):
    """Pack a generated scene into per-frame Frame pytree fields (NumPy).

    Returns dict of arrays with a leading time axis matching types.Frame
    field order; feed scene["rig"] alongside.
    """
    return {
        "kp2d": scene["kp2d"].astype(dtype),
        "cov2d": scene["cov2d"].astype(dtype),
        "det_score": scene["det_score"].astype(dtype),
        "det_valid": scene["det_valid"],
        "cam_stamp": scene["cam_stamp"],
        "fb_delay": scene["fb_delay"].astype(dtype),
    }


def pad_detections(data: dict, num_dets: int) -> dict:
    """Pad the detection axis (axis 2 of the [T, C, D, ...] fields of
    `frames_from_scene`) with empty slots (det_valid False) up to
    `num_dets`, e.g. a 6-person scene at the demo config's 8 slots."""
    d = data["kp2d"].shape[2]
    if d > num_dets:
        raise ValueError(f"{d} detections exceed {num_dets} slots")
    out = dict(data)
    for k in ("kp2d", "cov2d", "det_score", "det_valid"):
        widths = [(0, 0)] * data[k].ndim
        widths[2] = (0, num_dets - d)
        out[k] = np.pad(data[k], widths)
    return out


def frames_digest(data: dict) -> str:
    """SHA-256 over the frame fields, to pin a stored result to its input."""
    h = hashlib.sha256()
    for k in ("kp2d", "cov2d", "det_score", "det_valid", "cam_stamp", "fb_delay"):
        h.update(np.ascontiguousarray(data[k]).tobytes())
    return h.hexdigest()


# Tracker-scan scenarios: fabricated fusion outputs that drive the tracker
# through spawn churn, capacity overflow (dropped spawns), decay,
# detection-free frames and close-track merges, as the JAX package's
# tests/test_tracker_pallas.py builds them. name -> (persons, track slots,
# merge-heavy, seed, frames, min_num_obs).
TRACKER_SCENARIOS = {
    "spawn_churn": (5, 8, False, 0, 30, 3),
    "capacity_drops": (6, 6, False, 1, 30, 3),
    "merges": (8, 12, True, 2, 30, 3),
    "scaled": (30, 64, False, 7, 10, 2),
}


def person_sequence(rng: np.random.Generator, f: int, p: int, merge_heavy=False):
    """Fabricated fusion outputs (Persons3D fields as float64/bool/int32
    NumPy arrays with a leading frame axis): wandering people with
    teleports, dropouts, detection-free frames and, with `merge_heavy`,
    tight clusters. The same draws as test_tracker_pallas's generator."""
    k = 21
    base = rng.uniform(-3, 3, size=(p, 3))
    xyz = np.zeros((f, p, k, 3))
    score = np.zeros((f, p, k))
    valid = np.zeros((f, p), bool)
    pos = base.copy()
    for t in range(f):
        pos = pos + rng.normal(scale=0.02, size=(p, 3))
        jump = rng.uniform(size=p) < 0.08  # teleports: track loss + respawn
        pos[jump] = rng.uniform(-3, 3, size=(jump.sum(), 3))
        if merge_heavy and t > f // 3:
            pos[: p // 2] = pos[0] + rng.normal(scale=0.02, size=(p // 2, 3))
        offs = rng.normal(scale=0.25, size=(p, k, 3))
        xyz[t] = pos[:, None, :] + offs
        xyz[t, :, :, 2] += 0.9
        score[t] = rng.uniform(0.3, 1.0, size=(p, k))
        score[t][rng.uniform(size=(p, k)) < 0.15] = 0.0
        valid[t] = rng.uniform(size=p) > 0.25
        if rng.uniform() < 0.1:
            valid[t] = False  # detection-free frame
    cov = np.broadcast_to(np.eye(3) * 4e-3, (f, p, k, 3, 3)).copy()
    cov += rng.uniform(0, 1e-3, size=(f, p, 1, 1, 1)) * np.eye(3)
    return dict(xyz=xyz, score=score, cov=cov, valid=valid,
                person_id=-np.ones((f, p), np.int32))


def tracker_scenario(name: str):
    """(persons arrays, pivots [F] float32, fb_delay [F, C] float32, track
    slots, min_num_obs) of a TRACKER_SCENARIOS entry."""
    p, t_slots, merge_heavy, seed, f, min_obs = TRACKER_SCENARIOS[name]
    rng = np.random.default_rng(seed)
    arrays = person_sequence(rng, f, p, merge_heavy)
    if name == "scaled":
        pivots = (np.arange(f) / 30.0).astype(np.float32)
        fb = np.full((f, 8), 0.1, np.float32)
    else:
        pivots = (np.arange(f) / 30.0 + rng.normal(scale=1e-3, size=f)).astype(np.float32)
        fb = np.where(rng.uniform(size=(f, 4)) < 0.8, rng.uniform(0.05, 0.2, size=(f, 4)),
                      -1.0).astype(np.float32)
    return arrays, pivots, fb, t_slots, min_obs
