"""Training for the keypoint detector on synthetic hall scenes.

The reference never trains anything in-repo (its 2D CNNs live on the edge
sensors); this module makes the end-to-end variant (models/end_to_end.py)
demonstrably functional: it renders synthetic camera images from the
ground-truth scene generator (io/synthetic), trains the heatmap CNN on them
(MSE on rendered Gaussian targets, Adam), and returns a detector good
enough that pixels -> detector -> fusion -> 3D lands within centimeters of
the scene ground truth (tests/test_torch_models.py, chip_smoke.py phase 11).

Joints are color-coded in the synthetic renderer — each joint id maps to a
fixed RGB color — so a small backbone can learn the joint identities from
local appearance, which is the property the real edge-sensor CNNs provide.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch.models import keypoint_cnn
from smartedgesensor3dhumanpose_tpu_torch.ops import linalg

# Elements of one rendering chunk's [cameras, D, J, H, W] blob tensor (1 GiB
# of float32 at 2^28): 16 cameras x 6 people at 480x640 would hold ~2 GB.
_RENDER_CHUNK_ELEMENTS = 1 << 28


def joint_colors(num_joints: int = 17) -> np.ndarray:
    """[J, 3] distinct RGB colors in (0, 1] (golden-ratio hue wheel)."""
    cols = []
    for j in range(num_joints):
        h = (j * 0.61803398875) % 1.0
        i = int(h * 6.0)
        f = h * 6.0 - i
        v, p, q, t = 1.0, 0.25, 1.0 - 0.75 * f, 0.25 + 0.75 * f
        rgb = [
            (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)
        ][i % 6]
        cols.append(rgb)
    return np.asarray(cols, np.float32)


def render_images(
    kp2d: torch.Tensor,
    kp_valid: torch.Tensor,
    image_size: Tuple[int, int],
    radius: float = 3.0,
    noise: float = 0.02,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Render color-coded joint disks into synthetic camera images, a few
    cameras at a time (at most `_RENDER_CHUNK_ELEMENTS` blob elements).

    Args:
      kp2d: [C, D, J, 2] pixel keypoints.
      kp_valid: [C, D, J] bool.
      image_size: (H, W).
      generator: draws the pixel noise (on kp2d's device); None -> no noise.

    Returns:
      [C, H, W, 3] images in [0, 1].
    """
    h, w = image_size
    c, d, j = kp2d.shape[:3]
    dev = kp2d.device
    cols = linalg.constant(joint_colors(j), dev, kp2d.dtype)
    yy = torch.arange(h, dtype=kp2d.dtype, device=dev)[:, None]
    xx = torch.arange(w, dtype=kp2d.dtype, device=dev)[None, :]
    per_chunk = max(1, _RENDER_CHUNK_ELEMENTS // (d * j * h * w))
    chunks = []
    for lo in range(0, c, per_chunk):
        kps, ok = kp2d[lo:lo + per_chunk], kp_valid[lo:lo + per_chunk]
        d2 = (yy - kps[..., 1, None, None]) ** 2 + (xx - kps[..., 0, None, None]) ** 2
        blob = torch.exp(-d2 / (2.0 * radius ** 2))  # [c, D, J, H, W]
        blob = torch.where(ok[..., None, None], blob, 0.0)
        inten = blob.amax(dim=1)  # [c, J, H, W]: max over detections
        chunks.append(torch.einsum("cjhw,jk->chwk", inten, cols).clamp(0.0, 1.0))
    imgs = torch.cat(chunks)
    if generator is not None and noise > 0:
        imgs = torch.clamp(
            imgs + noise * torch.randn(imgs.shape, generator=generator, dtype=imgs.dtype,
                                       device=dev),
            0.0, 1.0,
        )
    return imgs


def _batch(kp2d, det_valid, det_cfg, generator):
    """(images, target heatmaps) of [B, D, J, 3] keypoints and [B, D] masks."""
    kp_valid = det_valid[..., None] & (kp2d[..., 2] > 0)
    images = render_images(kp2d[..., :2], kp_valid, det_cfg.image_size, generator=generator)
    targets = keypoint_cnn.gaussian_targets(kp2d[..., :2], kp_valid, det_cfg)
    return images, targets


def make_training_batch(scene_frames_np, t, cam_sel, det_cfg, generator=None, device="cuda"):
    """One batch of (images, target heatmaps) on `device` from a synthetic
    scene's pixel keypoints (io/synthetic.frames_from_scene output)."""
    kp2d = torch.as_tensor(scene_frames_np["kp2d"][t][cam_sel], device=device)  # [B, D, J, 3]
    det_valid = torch.as_tensor(scene_frames_np["det_valid"][t][cam_sel], device=device)
    return _batch(kp2d, det_valid, det_cfg, generator)


def train_detector(
    det_cfg: keypoint_cnn.DetectorConfig,
    scene_frames_np,
    steps: int = 300,
    batch_cams: int = 4,
    lr: float = 2e-3,
    seed: int = 0,
    log_every: int = 0,
    device="cuda",
) -> Tuple[keypoint_cnn.KeypointCNN, float]:
    """Train the detector on rendered synthetic frames, on `device`.

    The frame and camera draws come from numpy's generator at `seed`, in
    the JAX package's order; the initial weights (a CPU generator) and the
    pixel noise (a generator on `device`) from torch generators at `seed`.
    torch's Adam with its defaults is optax.adam's update (b1 0.9, b2 0.999,
    eps 1e-8 added to the root of the corrected second moment). The scene's
    keypoints and every step's draw go to the device once, so no step waits
    for the one before it (only `log_every` reads the loss back).

    Returns (model, final loss), the loss of the last batch before its
    update.
    """
    device = torch.device(device)
    model = keypoint_cnn.init_detector(det_cfg, torch.Generator().manual_seed(seed), device)
    noise = torch.Generator(device=device).manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    num_frames, num_cams = scene_frames_np["kp2d"].shape[:2]
    np_rng = np.random.default_rng(seed)
    draws = np.empty((steps, batch_cams), np.int64)
    for it in range(steps):
        t = int(np_rng.integers(0, num_frames))
        draws[it] = t * num_cams + np_rng.choice(num_cams, size=batch_cams, replace=False)
    kp_all = torch.as_tensor(scene_frames_np["kp2d"], device=device).flatten(0, 1)
    valid_all = torch.as_tensor(scene_frames_np["det_valid"], device=device).flatten(0, 1)
    draws = torch.as_tensor(draws, device=device)

    loss = torch.tensor(float("nan"))
    for it in range(steps):
        images, targets = _batch(kp_all.index_select(0, draws[it]),
                                 valid_all.index_select(0, draws[it]), det_cfg, noise)
        loss = keypoint_cnn.heatmap_loss(model, images, targets)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (it % log_every == 0):
            print(f"step {it}: loss {float(loss.detach()):.6f}")
    return model, float(loss.detach())
