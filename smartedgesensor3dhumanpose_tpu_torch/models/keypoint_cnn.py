"""2D keypoint CNN (heatmap head) and its fixed-slot multi-person decoder.

The reference's 2D pose CNNs run on the smart edge sensors themselves
(Google EdgeTPU boards, README.md:7-11) and only their keypoint/covariance
messages reach this system. For the fully-fused end-to-end variant this
module provides an equivalent detector that runs on the same card as the
fusion pipeline:

* a small convolutional backbone + heatmap head with float32 parameters
  and bfloat16 compute, laid out like the JAX package's flax module (NHWC
  in and out, flax's SAME padding, GroupNorm and initialisers), so
  parameters carry across either way (`convert.detector_params_from_flax`);
* a fixed-slot multi-person decoder: D peaks per camera by greedy masked
  argmax (the suppression box is the NMS), each joint claimed inside a box
  around its person's seed and refined to sub-pixel by a local soft-argmax,
  with per-keypoint confidence and a 2x2 covariance from the local heatmap
  moments: the Keypoint2D(+cov) message the fusion stage ingests.

The convolutions are `torch.nn.functional.conv2d` (cuDNN on the card); the
JAX package leaves them to XLA as well, outside any Pallas kernel. The
decoder runs without a host sync: every decision is a tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

GROUPS = 8
# flax.linen.GroupNorm's epsilon (torch.nn.GroupNorm's is 1e-5).
GN_EPS = 1e-6
# flax's lecun_normal draws from a normal truncated at two standard
# deviations, whose standard deviation is this fraction of the untruncated
# one; the draw is scaled up by it so the variance is 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    num_joints: int = 17
    image_size: Tuple[int, int] = (480, 640)  # (H, W)
    heatmap_stride: int = 8
    width: int = 128  # base channel count
    depth: int = 4    # conv stages in the backbone
    max_detections: int = 6
    # Peak decoding.
    nms_radius: int = 12       # heatmap pixels suppressed around a peak
    window: int = 5            # soft-argmax window (odd)
    min_peak_score: float = 0.1
    # Channels averaged for person seeding (None -> all joints). Compact
    # root joints (e.g. the COCO hips, (11, 12)) give one clean peak per
    # person instead of a body-wide blob.
    seed_joints: Tuple[int, ...] | None = None
    # Search radius (heatmap cells) for a person's joints around its seed;
    # None -> nms_radius. Widen it (with a compact seed, e.g. the hips) when
    # a body extends further than the seed blob.
    joint_radius: int | None = None
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16


def stage_plan(cfg: DetectorConfig):
    """(in channels, out channels, stride) of each 3x3 backbone stage:
    stride 2 while the heatmap stride is not reached, widths doubling from
    `width` up to 256."""
    plan, c_in, width, strides_left = [], 3, cfg.width, cfg.heatmap_stride
    for _ in range(cfg.depth):
        stride = 2 if strides_left > 1 else 1
        strides_left = max(1, strides_left // 2)
        plan.append((c_in, width, stride))
        c_in, width = width, min(2 * width, 256)
    return plan


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's SAME rule: out = ceil(size / stride),
    the total is what that output needs, the low side gets the smaller
    half. At stride 2 on an even size a 3x3 kernel pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = GROUPS, eps: float = GN_EPS) -> torch.Tensor:
    """flax.linen.GroupNorm on NHWC `x`: statistics in at least float32 over
    (H, W, channels of the group), the fast variance max(E[x^2] - E[x]^2,
    0), (x - mean) * (rsqrt(var + eps) * scale) + bias in that type, cast
    back to x's dtype."""
    b, h, w, c = x.shape
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt).reshape(b, h, w, groups, c // groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    mean2 = (xf * xf).mean(dim=(1, 2, 4), keepdim=True)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    mul = torch.rsqrt(var + eps) * weight.to(dt).reshape(groups, c // groups)
    y = (xf - mean) * mul + bias.to(dt).reshape(groups, c // groups)
    return y.reshape(b, h, w, c).to(x.dtype)


def _lecun_normal(shape, fan_in: int, dtype, generator) -> nn.Parameter:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=dtype)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return nn.Parameter(w)


class Conv(nn.Module):
    """A k x k convolution with flax's SAME padding on NHWC tensors; the
    kernel is OIHW, computed and biased in the compute dtype."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, dtype, generator):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = _lecun_normal((c_out, c_in, kernel, kernel), c_in * kernel * kernel,
                                    dtype, generator)
        self.bias = nn.Parameter(torch.zeros(c_out, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h_lo, h_hi = same_padding(x.shape[1], self.kernel, self.stride)
        w_lo, w_hi = same_padding(x.shape[2], self.kernel, self.stride)
        if h_lo or h_hi or w_lo or w_hi:
            x = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), stride=self.stride)
        # The bias is added after the product is rounded, as flax does.
        return y.permute(0, 2, 3, 1) + self.bias.to(x.dtype)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias)


class KeypointCNN(nn.Module):
    """Conv backbone + per-joint heatmap head.

    Input:  [B, H, W, 3] images in [0, 1].
    Output: [B, H/stride, W/stride, J] heatmaps (sigmoid activations, float32).

    Parameters are `cfg.param_dtype` and start from flax's initialisers:
    kernels lecun_normal (truncated normal, variance 1 / fan_in), biases 0,
    GroupNorm scale 1 and bias 0; `generator` draws them (None: torch's
    default generator). They are made on the CPU, so one seed gives the
    same weights for every device.
    """

    def __init__(self, cfg: DetectorConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        c_out = 3
        for i, (c_in, c_out, stride) in enumerate(stage_plan(cfg)):
            setattr(self, f"conv{i}", Conv(c_in, c_out, 3, stride, cfg.param_dtype, generator))
            setattr(self, f"gn{i}", GroupNorm(c_out, cfg.param_dtype))
        self.head = Conv(c_out, cfg.num_joints, 1, 1, cfg.param_dtype, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.cfg.compute_dtype)
        for i in range(self.cfg.depth):
            x = torch.relu(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
        return torch.sigmoid(self.head(x).to(torch.promote_types(x.dtype, torch.float32)))


class Peaks(NamedTuple):
    """The decoder's integer decisions and the scores they were made on."""

    seed_y: torch.Tensor      # [B, D] person seed cell (heatmap rows)
    seed_x: torch.Tensor      # [B, D]
    seed_score: torch.Tensor  # [B, D] seed-map value at the seed
    joint_y: torch.Tensor     # [B, D, J] each joint's claimed cell
    joint_x: torch.Tensor     # [B, D, J]
    joint_peak: torch.Tensor  # [B, D, J] heatmap value there


def _channel_mean(heatmaps: torch.Tensor, joints) -> torch.Tensor:
    """Mean over the listed joint channels, summed in channel order and
    scaled by the float32 reciprocal of their count: bit for bit what XLA
    makes of jnp.mean on the CPU, and one fixed order on every device, so
    the card seeds where the CPU does."""
    total = heatmaps[..., joints[0]]
    for j in joints[1:]:
        total = total + heatmaps[..., j]
    return total * (1.0 / len(joints))


def _box(yy, xx, cy, cx, radius: int) -> torch.Tensor:
    """Cells within `radius` (Chebyshev) of (cy, cx) [...] -> [..., Hh, Wh]."""
    return ((yy - cy[..., None, None]).abs() <= radius) & (
        (xx - cx[..., None, None]).abs() <= radius
    )


def find_peaks(heatmaps: torch.Tensor, cfg: DetectorConfig) -> Peaks:
    """The decoder's integer part: D person seeds per image by greedy masked
    argmax over the seed map (each seed's `nms_radius` box set to -1 before
    the next; sequential, as the JAX lax.scan), then per seed and joint the
    argmax of that joint's heatmap inside the `joint_radius` box. Ties go
    to the first index in row-major order, as jnp.argmax."""
    b, hh, wh, j = heatmaps.shape
    dev = heatmaps.device
    yy = torch.arange(hh, device=dev)[:, None]
    xx = torch.arange(wh, device=dev)[None, :]
    joints = cfg.seed_joints if cfg.seed_joints is not None else range(j)
    pm = _channel_mean(heatmaps, tuple(joints))  # [B, Hh, Wh]
    ys, xs, scores = [], [], []
    for _ in range(cfg.max_detections):
        flat = pm.reshape(b, hh * wh)
        idx = flat.argmax(dim=1)
        py, px = idx // wh, idx % wh
        scores.append(flat.gather(1, idx[:, None])[:, 0])
        ys.append(py)
        xs.append(px)
        pm = torch.where(_box(yy, xx, py, px, cfg.nms_radius), -1.0, pm)
    seed_y, seed_x = torch.stack(ys, 1), torch.stack(xs, 1)

    radius = cfg.joint_radius if cfg.joint_radius is not None else cfg.nms_radius
    near = _box(yy, xx, seed_y, seed_x, radius)  # [B, D, Hh, Wh]
    hm_t = heatmaps.permute(0, 3, 1, 2)  # [B, J, Hh, Wh]
    masked = torch.where(near[:, :, None], hm_t[:, None], -1.0).reshape(b, -1, j, hh * wh)
    jidx = masked.argmax(dim=-1)  # [B, D, J]
    peak = masked.gather(-1, jidx[..., None])[..., 0]
    return Peaks(seed_y, seed_x, torch.stack(scores, 1), jidx // wh, jidx % wh, peak)


def decode_heatmaps(
    heatmaps: torch.Tensor, cfg: DetectorConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-slot multi-person decoding of per-joint heatmaps.

    Person peaks are seeded from the joint-mean heatmap (`find_peaks`); each
    seed claims, per joint, the dominant response inside its neighborhood,
    refined by a soft-argmax over the `window` x `window` patch around it
    (clamped inside the map). Confidence = peak activation; the 2x2
    covariance comes from the patch's second moments (scaled to pixels,
    floored at 0.25 px^2) — the uncertainty the fusion stage propagates
    through the UT.

    Args:
      heatmaps: [B, Hh, Wh, J].

    Returns:
      (kp2d [B, D, J, 3] pixel (x, y, score),
       cov2d [B, D, J, 3] packed (xx, xy, yy),
       det_score [B, D],
       det_valid [B, D])
    """
    b, hh, wh, j = heatmaps.shape
    d = cfg.max_detections
    stride = cfg.heatmap_stride
    win = cfg.window
    peaks = find_peaks(heatmaps, cfg)

    oy = (peaks.joint_y - win // 2).clamp(0, hh - win)  # [B, D, J]
    ox = (peaks.joint_x - win // 2).clamp(0, wh - win)
    offs = torch.arange(win, device=heatmaps.device)
    cells = ((oy[..., None] + offs)[..., :, None] * wh
             + (ox[..., None] + offs)[..., None, :]).reshape(b, d, j, win * win)
    hm_t = heatmaps.permute(0, 3, 1, 2).reshape(b, 1, j, hh * wh).expand(b, d, j, hh * wh)
    patch = hm_t.gather(-1, cells).reshape(b, d, j, win, win)

    wy = offs.to(heatmaps.dtype)[:, None]
    wx = offs.to(heatmaps.dtype)[None, :]
    wsum = torch.clamp_min(patch.sum(dim=(-2, -1)), 1e-6)
    my = (patch * wy).sum(dim=(-2, -1)) / wsum
    mx = (patch * wx).sum(dim=(-2, -1)) / wsum
    dy = wy - my[..., None, None]
    dx = wx - mx[..., None, None]
    vyy = (patch * dy ** 2).sum(dim=(-2, -1)) / wsum
    vxx = (patch * dx ** 2).sum(dim=(-2, -1)) / wsum
    vxy = (patch * dy * dx).sum(dim=(-2, -1)) / wsum
    # Heatmap cells -> pixels.
    px_x = (ox + mx) * stride + (stride - 1) / 2.0
    px_y = (oy + my) * stride + (stride - 1) / 2.0
    s2 = float(stride * stride)

    peak = peaks.joint_peak
    score = torch.where(peak > cfg.min_peak_score, peak, 0.0)
    kp2d = torch.stack([px_x, px_y, score], dim=-1)
    cov2d = torch.stack(
        [torch.clamp_min(vxx * s2, 0.25), vxy * s2, torch.clamp_min(vyy * s2, 0.25)], dim=-1
    )
    cov2d = torch.where(score[..., None] > 0, cov2d, 0.0)
    det_valid = peaks.seed_score > cfg.min_peak_score
    det_score = torch.where(det_valid, peaks.seed_score, 0.0)
    return kp2d, cov2d, det_score, det_valid


def init_detector(cfg: DetectorConfig, generator: torch.Generator | None = None,
                  device="cuda") -> KeypointCNN:
    """A KeypointCNN with flax's initialisers, drawn from `generator` (a
    CPU generator; see KeypointCNN), on `device`."""
    return KeypointCNN(cfg, generator).to(device)


@torch.no_grad()
def detect(model: KeypointCNN, images: torch.Tensor, cfg: DetectorConfig):
    """images [B, H, W, 3] -> fusion-ready detections (see decode_heatmaps)."""
    return decode_heatmaps(model(images), cfg)


def heatmap_loss(model: KeypointCNN, images: torch.Tensor,
                 target_heatmaps: torch.Tensor) -> torch.Tensor:
    """MSE heatmap training loss (standard heatmap-regression objective)."""
    return torch.mean((model(images) - target_heatmaps) ** 2)


def gaussian_targets(
    kp2d: torch.Tensor,
    valid: torch.Tensor,
    cfg: DetectorConfig,
    sigma: float = 2.0,
) -> torch.Tensor:
    """Render ground-truth keypoints into training heatmaps.

    Args:
      kp2d: [B, D, J, 2] pixel keypoints.
      valid: [B, D, J] bool.

    Returns:
      [B, Hh, Wh, J] max-combined Gaussians.
    """
    h, w = cfg.image_size
    s = cfg.heatmap_stride
    hh, wh = h // s, w // s
    yy = torch.arange(hh, dtype=kp2d.dtype, device=kp2d.device)[:, None]
    xx = torch.arange(wh, dtype=kp2d.dtype, device=kp2d.device)[None, :]
    cy = (kp2d[..., 1] - (s - 1) / 2.0) / s
    cx = (kp2d[..., 0] - (s - 1) / 2.0) / s
    d2 = (yy - cy[..., None, None]) ** 2 + (xx - cx[..., None, None]) ** 2  # [B, D, J, Hh, Wh]
    g = torch.exp(-d2 / (2.0 * sigma ** 2))
    g = torch.where(valid[..., None, None], g, 0.0)
    return g.amax(dim=1).permute(0, 2, 3, 1)
