"""Visualization: 2D keypoint overlays and 3D skeleton plots.

Replaces the reference's debug viz stack — the per-camera 2D overlay node
(person_msgs/scripts/pose2D_plot_node.py: COCO keypoints + limb pairs + bbox
on a white canvas) and the rviz MarkerArray skeletons (LINE_LIST bones +
SPHERE_LIST joints with per-joint colors, skeleton_3d_triang_mult_node.cpp:
676-921, colors :1140-1170). Matplotlib-based; optional (the pipeline never
imports this module, and matplotlib is imported only by the functions that
draw: where it is missing they raise an ImportError that names it).
`SigmaStats` is NumPy only. Tensors, on any device, are read on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from smartedgesensor3dhumanpose_tpu_torch import skeleton
from smartedgesensor3dhumanpose_tpu_torch.convert import host

# Per-joint RGB colors of the fusion skeleton (reference :1142-1162, 0-255).
FUSION_COLORS = (
    np.array(
        [
            (255, 0, 0), (85, 170, 0), (0, 255, 0), (0, 255, 170),
            (0, 170, 255), (85, 255, 0), (0, 255, 85), (0, 255, 255),
            (0, 85, 170), (0, 0, 255), (100, 0, 255), (255, 0, 255),
            (0, 85, 255), (50, 0, 255), (170, 0, 255), (255, 170, 0),
            (255, 85, 0), (170, 255, 0), (255, 255, 0), (255, 150, 0),
            (42, 128, 85),
        ],
        dtype=np.float64,
    )
    / 255.0
)


# Second color scheme for the RAW (pre-smoothing) triangulation output —
# the rviz setup displays both skeleton_3d (raw) and skeleton3d_fused
# (/root/reference/pose_hall.rviz:148-167); dimming the per-joint palette
# toward gray keeps joints identifiable while fused stays visually dominant.
RAW_COLORS = 0.35 * FUSION_COLORS + 0.55

# Third scheme for ground-truth skeletons (the rviz setup reserves a
# skeleton3d_gt_new display, pose_hall.rviz:167): uniform dark green.
GT_COLORS = np.tile(
    np.array([0.05, 0.45, 0.05]), (skeleton.NUM_FUSION_JOINTS, 1)
)


def require_matplotlib():
    """matplotlib set to its headless backend; an ImportError that names it
    when it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the pose dashboards (--viz, --live) draw with matplotlib, which "
            "is not installed in this environment"
        ) from e
    matplotlib.use("Agg")
    return matplotlib


def draw_2d_overlay(
    ax,
    kp2d: np.ndarray,
    kp_valid: Optional[np.ndarray] = None,
    bbox: Optional[np.ndarray] = None,
    image_size: Sequence[float] = (640, 480),
    min_score: float = 0.0,
    colors: Optional[np.ndarray] = None,
    linewidth: float = 2.0,
):
    """Draw one camera's detections (COCO-17 layout) on a matplotlib axis.

    Args:
      kp2d: [P, 17, 3] pixel keypoints (x, y, score).
      kp_valid: optional [P, 17] mask (defaults to score > min_score).
      bbox: optional [P, 4] (x0, y0, x1, y1).
      colors: optional per-fusion-joint palette (RAW_COLORS for the dim
        input-detection layer).
    """
    require_matplotlib()
    import matplotlib.patches as patches

    kp2d = host(kp2d)
    if kp_valid is None:
        kp_valid = kp2d[..., 2] > min_score
    if colors is None:
        colors = FUSION_COLORS
    to_fusion = host(skeleton.SIMPLE_MODEL.to_fusion)
    for p in range(kp2d.shape[0]):
        if not kp_valid[p].any():
            continue
        for a, b in host(skeleton.COCO_LIMB_PAIRS):
            if kp_valid[p, a] and kp_valid[p, b]:
                ax.plot(
                    [kp2d[p, a, 0], kp2d[p, b, 0]],
                    [kp2d[p, a, 1], kp2d[p, b, 1]],
                    color=colors[to_fusion[b]],
                    linewidth=linewidth,
                )
        for j in range(kp2d.shape[1]):
            if kp_valid[p, j]:
                ax.plot(
                    kp2d[p, j, 0],
                    kp2d[p, j, 1],
                    "o",
                    color=colors[to_fusion[j]],
                    markersize=3,
                )
        if bbox is not None and kp_valid[p].any():
            x0, y0, x1, y1 = host(bbox[p])
            ax.add_patch(
                patches.Rectangle(
                    (x0, y0), x1 - x0, y1 - y0, fill=False, edgecolor="gray"
                )
            )
    ax.set_xlim(0, image_size[0])
    ax.set_ylim(image_size[1], 0)
    ax.set_aspect("equal")


def draw_skeleton_3d(
    ax,
    xyz: np.ndarray,
    score: np.ndarray,
    person_id: Optional[int] = None,
    colors: Optional[np.ndarray] = None,
    linewidth: float = 2.0,
    marker_size: float = 15.0,
):
    """Draw one 21-joint fusion skeleton on a 3D matplotlib axis, bones
    following the parent tree (reference marker construction :901-918).
    Pass colors=RAW_COLORS for the raw (pre-smoothing) display layer."""
    xyz = host(xyz)
    score = host(score)
    if colors is None:
        colors = FUSION_COLORS
    parent = skeleton.FUSION_PARENT
    for j in range(skeleton.NUM_FUSION_JOINTS):
        if score[j] <= 0:
            continue
        ax.scatter(*xyz[j], color=colors[j], s=marker_size)
        pj = parent[j]
        if pj >= 0 and score[pj] > 0:
            ax.plot(
                [xyz[j, 0], xyz[pj, 0]],
                [xyz[j, 1], xyz[pj, 1]],
                [xyz[j, 2], xyz[pj, 2]],
                color=colors[j],
                linewidth=linewidth,
            )
    if person_id is not None and score.max() > 0:
        top = xyz[score > 0][:, 2].max()
        center = xyz[score > 0].mean(axis=0)
        ax.text(center[0], center[1], top + 0.15, f"#{person_id}")


def draw_covariance_ellipsoid(ax, xyz, cov, color, n_std=2.7955, alpha=0.25):
    """2-sigma covariance ellipsoid (the reference's vis_cov markers,
    skeleton_3d_triang_mult_node.cpp:279-301; 2.7955 = sqrt(chi2inv(.95,3)))."""
    w, v = np.linalg.eigh(host(cov))
    w = np.maximum(w, 0.0)
    radii = n_std * np.sqrt(w)
    u = np.linspace(0, 2 * np.pi, 16)
    t = np.linspace(0, np.pi, 8)
    sphere = np.stack(
        [
            np.outer(np.cos(u), np.sin(t)),
            np.outer(np.sin(u), np.sin(t)),
            np.outer(np.ones_like(u), np.cos(t)),
        ],
        axis=-1,
    )
    pts = sphere * radii
    pts = pts @ v.T + host(xyz)
    ax.plot_surface(
        pts[..., 0], pts[..., 1], pts[..., 2], color=color, alpha=alpha,
        linewidth=0,
    )


class SigmaStats:
    """Global min/max 3D sigma tracking, printed at shutdown when vis_cov is
    on (reference :147-148,303-309,1243-1247)."""

    def __init__(self):
        self.min_eig = np.full(3, np.inf)
        self.max_eig = np.full(3, -np.inf)

    def update(self, cov: np.ndarray, score: np.ndarray):
        """cov [P, K, 3, 3], score [P, K]."""
        mask = host(score) > 0
        if not mask.any():
            return
        eigs = np.linalg.eigvalsh(host(cov)[mask])  # [M, 3] ascending
        self.min_eig = np.minimum(self.min_eig, eigs.min(axis=0))
        self.max_eig = np.maximum(self.max_eig, eigs.max(axis=0))

    def report(self) -> str:
        if not np.isfinite(self.min_eig).all():
            return "Sigmas 3D: no valid joints observed"
        mn = np.sqrt(self.min_eig) * 1e3
        mx = np.sqrt(self.max_eig) * 1e3
        return (
            "Sigmas 3D [mm]:\n"
            f"min: x: {mn[0]:.2f}mm, y: {mn[1]:.2f}mm, z: {mn[2]:.2f}mm.\n"
            f"max: x: {mx[0]:.2f}mm, y: {mx[1]:.2f}mm, z: {mx[2]:.2f}mm."
        )


def _draw_gt_layer(ax3d, gt_xyz, pose_method: str):
    """Ground-truth skeletons (input-model 17-joint layout) as the third
    display layer (rviz skeleton3d_gt_new, pose_hall.rviz:167)."""
    model = skeleton.input_model(pose_method)
    to_f = host(model.to_fusion)
    kf = skeleton.NUM_FUSION_JOINTS
    for g in range(host(gt_xyz).shape[0]):
        xyz_f = np.zeros((kf, 3))
        score_f = np.zeros((kf,))
        xyz_f[to_f] = host(gt_xyz)[g]
        score_f[to_f] = 1.0
        draw_skeleton_3d(
            ax3d, xyz_f, score_f, colors=GT_COLORS,
            linewidth=0.8, marker_size=4.0,
        )


def render_frame_summary(
    out,
    rig,
    path: str,
    cameras_to_show: Sequence[int] = (0, 1, 2, 3),
    input_frame=None,
    gt_xyz=None,
    pose_method: str = "simple",
):
    """Save a PNG with the 3D skeletons — RAW triangulation output (dim
    palette) under the FUSED/smoothed result, matching the rviz double
    display (pose_hall.rviz:148-167: skeleton_3d + skeleton3d_fused) — plus
    a grid of per-camera feedback overlays (C26).

    input_frame: optional Frame (single frame) whose raw 2D input detections
    are drawn dimly under each camera's feedback overlay.
    gt_xyz: optional [G, J, 3] ground-truth skeletons (input-model layout)
    drawn as a dark-green third layer (rviz skeleton3d_gt_new)."""
    require_matplotlib()
    import matplotlib.pyplot as plt

    n_cams = len(cameras_to_show)
    fig = plt.figure(figsize=(4 * (n_cams + 1), 4))
    ax3d = fig.add_subplot(1, n_cams + 1, 1, projection="3d")
    if gt_xyz is not None:
        _draw_gt_layer(ax3d, gt_xyz, pose_method)
    raw_valid = host(out.persons_raw.valid)
    for p in np.nonzero(raw_valid)[0]:
        draw_skeleton_3d(
            ax3d,
            host(out.persons_raw.xyz[p]),
            host(out.persons_raw.score[p]),
            colors=RAW_COLORS,
            linewidth=1.2,
            marker_size=8.0,
        )
    valid = host(out.fused.valid)
    for p in np.nonzero(valid)[0]:
        draw_skeleton_3d(
            ax3d,
            host(out.fused.xyz[p]),
            host(out.fused.score[p]),
            int(host(out.fused.person_id[p])),
        )
    ax3d.set_title(
        "3D: raw (dim) + fused" + (" + GT (green)" if gt_xyz is not None else "")
    )
    size = host(rig.image_size)
    for k, c in enumerate(cameras_to_show):
        ax = fig.add_subplot(1, n_cams + 1, k + 2)
        if input_frame is not None:
            kp_in = host(input_frame.kp2d[c])
            ok_in = (kp_in[..., 2] > 0) & host(
                input_frame.det_valid[c]
            )[:, None]
            draw_2d_overlay(
                ax, kp_in, ok_in, image_size=size[c],
                colors=RAW_COLORS, linewidth=1.0,
            )
        draw_2d_overlay(
            ax,
            host(out.feedback.kp2d[c]),
            host(out.feedback.kp_valid[c]),
            host(out.feedback.bbox[c]),
            image_size=size[c],
        )
        ax.set_title(
            f"cam {c} feedback" + (" + input" if input_frame is not None else "")
        )
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)
    return path


def render_live_dashboard(
    outs,
    rig,
    path: str,
    cameras_to_show: Sequence[int] = (0, 1, 2, 3),
    fps: int = 10,
    max_frames: int = 120,
    input_frames=None,
):
    """Animated operator dashboard over a whole replay — the live equivalent
    of the reference's rviz 3D view + rqt camera tiles (pose_hall.rviz:
    148-167, pose_hall.perspective; C26). The 3D pane layers the RAW
    triangulation output (dim palette, the rviz skeleton_3d display) under
    the fused/smoothed skeletons (skeleton3d_fused).

    Args:
      outs: StepOutput pytree with a leading time axis (pipeline.run_offline
        output, or stacked per-frame outputs).
      path: output file; ``.gif`` writes an animated GIF (Pillow),
        ``.html`` a self-contained scrubbable HTML player (no display
        needed — both work headless).
      input_frames: optional Frame pytree (leading time axis) whose raw 2D
        input detections are drawn dimly under each camera's feedback.

    Returns the path written.
    """
    require_matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib import animation

    t_total = int(host(outs.fused.valid).shape[0])
    t_show = min(t_total, max_frames)
    n_cams = len(cameras_to_show)
    size = host(rig.image_size)

    fig = plt.figure(figsize=(4 * (n_cams + 1), 4))
    ax3d = fig.add_subplot(1, n_cams + 1, 1, projection="3d")
    axes2d = [
        fig.add_subplot(1, n_cams + 1, k + 2) for k in range(n_cams)
    ]

    fused_xyz = host(outs.fused.xyz)
    fused_score = host(outs.fused.score)
    fused_valid = host(outs.fused.valid)
    fused_id = host(outs.fused.person_id)
    raw_xyz = host(outs.persons_raw.xyz)
    raw_score = host(outs.persons_raw.score)
    raw_valid = host(outs.persons_raw.valid)
    fb_kp = host(outs.feedback.kp2d)
    fb_ok = host(outs.feedback.kp_valid)
    fb_bbox = host(outs.feedback.bbox)
    if input_frames is not None:
        in_kp = host(input_frames.kp2d)
        in_ok = (in_kp[..., 2] > 0) & host(
            input_frames.det_valid
        )[..., None]

    def draw(t):
        ax3d.cla()
        for p in np.nonzero(raw_valid[t])[0]:
            draw_skeleton_3d(
                ax3d, raw_xyz[t, p], raw_score[t, p],
                colors=RAW_COLORS, linewidth=1.2, marker_size=8.0,
            )
        for p in np.nonzero(fused_valid[t])[0]:
            draw_skeleton_3d(
                ax3d, fused_xyz[t, p], fused_score[t, p], int(fused_id[t, p])
            )
        ax3d.set_title(f"raw (dim) + fused 3D — frame {t}")
        ax3d.set_xlim(-4, 4)
        ax3d.set_ylim(-4, 4)
        ax3d.set_zlim(0, 2.5)
        for k, c in enumerate(cameras_to_show):
            ax = axes2d[k]
            ax.cla()
            if input_frames is not None:
                draw_2d_overlay(
                    ax, in_kp[t, c], in_ok[t, c], image_size=size[c],
                    colors=RAW_COLORS, linewidth=1.0,
                )
            draw_2d_overlay(
                ax, fb_kp[t, c], fb_ok[t, c], fb_bbox[t, c],
                image_size=size[c],
            )
            ax.set_title(f"cam {c} feedback")
        return []

    anim = animation.FuncAnimation(
        fig, draw, frames=t_show, interval=1000 // fps, blit=False
    )
    if path.endswith(".html"):
        with open(path, "w") as f:
            f.write(anim.to_jshtml(fps=fps, default_mode="loop"))
    else:
        anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path
