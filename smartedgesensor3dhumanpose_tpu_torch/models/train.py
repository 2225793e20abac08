"""Training for the keypoint detector on synthetic hall scenes.

The reference never trains anything in-repo (its 2D CNNs live on the edge
sensors); this module makes the end-to-end variant (models/end_to_end.py)
demonstrably functional: it renders synthetic camera images from the
ground-truth scene generator (io/synthetic), trains the heatmap CNN on them
(MSE on rendered Gaussian targets, optax's Adam; `make_train_step` is the
JAX package's jitted step_fn, replayed as a CUDA graph on the card), and
returns a detector good enough that pixels -> detector -> fusion -> 3D
lands within centimeters of the scene ground truth
(tests/test_torch_models.py, chip_smoke.py phase 11).

Joints are color-coded in the synthetic renderer — each joint id maps to a
fixed RGB color — so a small backbone can learn the joint identities from
local appearance, which is the property the real edge-sensor CNNs provide.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch import graphs
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




# ------------------------------------------------------------ the step --

# optax.adam's defaults (its eps_root is 0: sqrt(nu_hat + 0) = sqrt(nu_hat)).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# optax.safe_increment's ceiling of an int32 count.
_COUNT_MAX = 2 ** 31 - 1


class AdamState(NamedTuple):
    """optax.ScaleByAdamState of the port: the step count (a 0-d int32
    tensor on the parameters' device) and the first and second moments,
    tuples in the parameters' order (`param_names`)."""

    count: torch.Tensor
    mu: tuple
    nu: tuple


def param_names(model: keypoint_cnn.KeypointCNN) -> tuple:
    """The order of a training step's `params`: the model's state_dict."""
    return tuple(name for name, _ in model.named_parameters())


def initial_params(model: keypoint_cnn.KeypointCNN) -> tuple:
    """Copies of the model's parameters, in `param_names` order."""
    return tuple(p.detach().clone() for p in model.parameters())


def adam_init(params) -> AdamState:
    """optax.adam's init: count 0, zero moments."""
    return AdamState(torch.zeros((), dtype=torch.int32, device=params[0].device),
                     tuple(torch.zeros_like(p) for p in params),
                     tuple(torch.zeros_like(p) for p in params))


def adam_update(grads, state: AdamState, lr: float):
    """optax.adam(lr).update: (updates, new state), element by element in
    optax's float order. The bias corrections 1 - b**count are computed on
    the device from the incremented count (a captured graph replays them
    anew each step) in float64, as optax computes them where JAX enables
    x64 (the Python float promotes the int32 count), then cast to the
    moments' dtype, the parameters'."""
    b1, b2 = ADAM_B1, ADAM_B2
    count = torch.where(state.count < _COUNT_MAX, state.count + 1, state.count)
    t = count.to(torch.float64)
    bc1, bc2 = ((1 - b ** t).to(state.mu[0].dtype) for b in (b1, b2))
    mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu, strict=True))
    nu = tuple((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu, strict=True))
    updates = tuple(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)) for m, v in zip(mu, nu))
    return updates, AdamState(count, mu, nu)


def make_value_and_grad(model: keypoint_cnn.KeypointCNN):
    """jax.value_and_grad of heatmap_loss: a function (params, images,
    targets) -> (loss, grads) of `params`, a tuple in `param_names` order.
    `model` gives only the architecture: it is called with `params` in
    place of its own (torch.func.functional_call), differentiated with
    respect to detached aliases of them made inside the call, so nothing
    but the outputs is written (no `.grad`, no module parameter)."""
    names = param_names(model)

    def value_and_grad(params, images, targets):
        with torch.enable_grad():
            leaves = tuple(p.detach().requires_grad_() for p in params)
            weights = dict(zip(names, leaves, strict=True))
            loss = keypoint_cnn.heatmap_loss(
                lambda x: torch.func.functional_call(model, weights, (x,)), images, targets)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    return value_and_grad


def make_train_step(model: keypoint_cnn.KeypointCNN, lr: float):
    """The JAX package's jitted `step_fn` (its models/train.py): a pure
    function step(params, adam_state, images, targets) -> (params,
    adam_state, loss) that takes the gradients of heatmap_loss
    (`make_value_and_grad`), applies optax.adam(lr)'s update
    (`adam_update`) and adds it to `params`, as optax.apply_updates does.
    `loss` is the batch's before the update. The step writes nothing but
    its outputs, so a captured graph of it (graphs.CapturedFunction)
    replays one step, its warm-up included."""
    if any(p.is_cuda for p in model.parameters()):
        linalg.require_ieee_fp32()
    value_and_grad = make_value_and_grad(model)

    def step(params, adam_state: AdamState, images, targets):
        loss, grads = value_and_grad(params, images, targets)
        updates, adam_state = adam_update(grads, adam_state, lr)
        return tuple(p + u for p, u in zip(params, updates, strict=True)), adam_state, loss

    return step


def training_draws(num_frames: int, num_cams: int, steps: int, batch_cams: int,
                   seed: int) -> np.ndarray:
    """[steps, batch_cams] rows t * num_cams + camera of each step's batch:
    the frame t and the cameras the JAX package's training loop draws from
    numpy's generator at `seed`, in its order."""
    np_rng = np.random.default_rng(seed)
    draws = np.empty((steps, batch_cams), np.int64)
    for it in range(steps):
        t = int(np_rng.integers(0, num_frames))
        draws[it] = t * num_cams + np_rng.choice(num_cams, size=batch_cams, replace=False)
    return draws


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
    """Train the detector on rendered synthetic frames, on `device`, as the
    JAX package's train_detector does: each step renders its batch, then
    runs the training step (`make_train_step`, optax.adam(lr)); on CUDA
    the step replays a CUDA graph (graphs.CapturedFunction), as JAX jits
    its step_fn, and the batch stays outside it, as JAX's
    make_training_batch stays outside the jit.

    The frame and camera draws come from numpy's generator at `seed`, in
    the JAX package's order (`training_draws`); the initial weights (a CPU
    generator) and the pixel noise (a generator on `device`) from torch
    generators at `seed`. The scene's keypoints and every step's draw go
    to the device once, so no step waits for the one before it (only
    `log_every` reads the loss back).

    Returns (model, final loss): the model holds the trained parameters;
    the loss is the last batch's before its update.
    """
    device = torch.device(device)
    if device.type == "cuda":
        linalg.require_ieee_fp32()
    model = keypoint_cnn.init_detector(det_cfg, torch.Generator().manual_seed(seed), device)
    noise = torch.Generator(device=device).manual_seed(seed)
    step = make_train_step(model, lr)
    if device.type == "cuda":
        step = graphs.CapturedFunction(step, "train_step")

    num_frames, num_cams = scene_frames_np["kp2d"].shape[:2]
    draws = torch.as_tensor(training_draws(num_frames, num_cams, steps, batch_cams, seed),
                            device=device)
    kp_all = torch.as_tensor(scene_frames_np["kp2d"], device=device).flatten(0, 1)
    valid_all = torch.as_tensor(scene_frames_np["det_valid"], device=device).flatten(0, 1)

    params = initial_params(model)
    adam_state = adam_init(params)
    loss = torch.tensor(float("nan"))
    for it in range(steps):
        images, targets = _batch(kp_all.index_select(0, draws[it]),
                                 valid_all.index_select(0, draws[it]), det_cfg, noise)
        params, adam_state, loss = step(params, adam_state, images, targets)
        if log_every and (it % log_every == 0):
            print(f"step {it}: loss {float(loss):.6f}")
    model.load_state_dict(dict(zip(param_names(model), params, strict=True)))
    return model, float(loss)
