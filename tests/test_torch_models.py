"""The port's keypoint detector, its decoder, its training and the
end-to-end pixels -> 3D step against the JAX package's models/.

Inputs are made with numpy from a seed and fed to both sides; the flax
parameters cross into the port through `convert.detector_params_from_flax`.
JAX runs on the CPU with x64 as conftest sets it up, the port on CPU tensors
(the kernels' plain versions). Small sizes: 96x128 images, width 32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import config as jax_config
from smartedgesensor3dhumanpose_tpu.models import end_to_end as jax_e2e
from smartedgesensor3dhumanpose_tpu.models import keypoint_cnn as jax_kcnn
from smartedgesensor3dhumanpose_tpu.models import train as jax_train
from smartedgesensor3dhumanpose_tpu_torch import cameras, config, convert, skeleton
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.models import end_to_end, keypoint_cnn, train
from test_fusion import match_to_gt

pytestmark = pytest.mark.torch_port

SMALL = dict(image_size=(96, 128), width=32, max_detections=3, nms_radius=6)
# The detector of the trained test (tests/test_models.py): hip-seeded,
# stride 4, a 7-cell soft-argmax window.
HIPS = dict(image_size=(96, 128), heatmap_stride=4, width=32, max_detections=3,
            nms_radius=4, joint_radius=9, window=7, min_peak_score=0.15,
            seed_joints=(11, 12))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# Heatmaps of the same parameters on the same images. float32: the same
# products summed in another order by XLA's and oneDNN's convolutions, then
# four GroupNorms (measured <= 1.5e-6). bfloat16: each stage's output is
# rounded to 8 bits of mantissa on both sides, so one rounding that lands
# the other way moves an activation by 2^-8 relative and the difference
# grows through the stages (measured ~2.6e-3 at stride 4).
FORWARD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Decoded positions: soft-argmax means over the same patch, summed in
# another order (measured <= 8e-6 px). Covariances are second moments
# scaled by stride^2 (px^2; measured <= 6.1e-5 at stride 8).
POS_TOL_PX = 1e-4
COV_RTOL, COV_ATOL = 1e-5, 1e-4
# Joints of the float32 end-to-end step against JAX's: the parity budget of
# the JAX parity harness (parity.py), 1 mm.
JOINT_TOL_M = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: pytest-xdist runs a
    worker per core or so, and torch's default of one OpenMP thread per
    core then oversubscribes the machine; the spinning threads slowed the
    bfloat16 training tenfold in one such run."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _cfgs(compute="float32", **kw):
    jd, td = DTYPES[compute]
    return (jax_kcnn.DetectorConfig(compute_dtype=jd, **kw),
            keypoint_cnn.DetectorConfig(compute_dtype=td, **kw))


def _flax_and_port(jcfg, tcfg, seed=0):
    """A flax detector's (model, params) and the port's model holding the
    same parameters."""
    model, params = jax_kcnn.init_detector(jcfg, jax.random.PRNGKey(seed))
    port = keypoint_cnn.init_detector(tcfg, device="cpu")
    port.load_state_dict(convert.detector_params_from_flax(jax.device_get(params)))
    return model, params, port


def _np(tree):
    return [np.asarray(x) for x in tree]


# ---------------------------------------------------------------- detector --

def test_detector_config_defaults_equal_jax():
    jcfg, tcfg = jax_kcnn.DetectorConfig(), keypoint_cnn.DetectorConfig()
    for f in dataclasses.fields(jax_kcnn.DetectorConfig):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name.endswith("_dtype"):
            assert str(got).removeprefix("torch.") == jnp.dtype(want).name, f.name
        else:
            assert got == want, f.name
    assert [f.name for f in dataclasses.fields(keypoint_cnn.DetectorConfig)] == [
        f.name for f in dataclasses.fields(jax_kcnn.DetectorConfig)]
    # The full-width detector: 1.49 M parameters on both sides.
    shapes = jax.eval_shape(jax_kcnn.KeypointCNN(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *jcfg.image_size, 3), jnp.float32))
    n_flax = sum(x.size for x in jax.tree_util.tree_leaves(shapes))
    n_port = sum(p.numel() for p in keypoint_cnn.init_detector(tcfg, device="cpu").parameters())
    assert n_port == n_flax and 1.48e6 < n_port < 1.50e6, (n_port, n_flax)


def test_detector_params_round_trip():
    """flax tree -> state_dict -> flax tree is the identity, the state_dict
    has exactly the port module's keys and shapes, and a port module's
    state_dict survives the other way round."""
    jcfg, tcfg = _cfgs(**SMALL)
    _, params, port = _flax_and_port(jcfg, tcfg)
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    state = convert.detector_params_from_flax(jax.device_get(params))
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    back = convert.detector_params_to_flax(state)
    back_flat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in back_flat] == [p for p, _ in flat]
    for (path, a), (_, b) in zip(flat, back_flat):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    again = convert.detector_params_from_flax(convert.detector_params_to_flax(port.state_dict()))
    for k, v in port.state_dict().items():
        assert torch.equal(again[k], v), k
    # Initialised from flax's distributions: lecun_normal kernels (variance
    # 1 / fan_in, truncated at two standard deviations), zero biases, unit
    # GroupNorm scales.
    fresh = keypoint_cnn.init_detector(tcfg, torch.Generator().manual_seed(0), device="cpu")
    w = fresh.conv2.weight.detach()
    fan_in = w[0].numel()
    std = float(w.std()) * np.sqrt(fan_in)
    assert 0.95 < std < 1.05, std  # 147k draws: the std within ~0.3%
    assert float(w.abs().max()) * np.sqrt(fan_in) <= 2.0 / 0.87962566103423978 + 1e-6
    assert float(fresh.conv2.bias.detach().abs().max()) == 0
    assert float(fresh.gn2.weight.detach().min()) == 1


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [8, 4])
def test_forward_matches_flax(compute, stride):
    """The port's KeypointCNN with the flax parameters against flax's
    forward on the same images: SAME padding (0, 1) at stride 2,
    GroupNorm(8) with flax's statistics, bias added in the compute dtype."""
    jcfg, tcfg = _cfgs(compute, **{**SMALL, "heatmap_stride": stride})
    model, params, port = _flax_and_port(jcfg, tcfg)
    imgs = np.random.default_rng(stride).uniform(size=(2, 96, 128, 3)).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(imgs)))
    with torch.no_grad():
        got = port(torch.tensor(imgs)).numpy()
    assert got.shape == want.shape == (2, 96 // stride, 128 // stride, 17)
    assert got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= FORWARD_TOL[compute], f"max |port - flax| = {err:.3e}"


def test_same_padding_rule():
    # XLA's SAME: stride 2 on an even size pads (0, 1), on an odd size (1, 1).
    assert keypoint_cnn.same_padding(96, 3, 2) == (0, 1)
    assert keypoint_cnn.same_padding(95, 3, 2) == (1, 1)
    assert keypoint_cnn.same_padding(12, 3, 1) == (1, 1)
    assert keypoint_cnn.same_padding(12, 1, 1) == (0, 0)
    # An odd image size runs through the whole backbone as flax's does.
    jcfg, tcfg = _cfgs(**{**SMALL, "image_size": (37, 51)})
    model, params, port = _flax_and_port(jcfg, tcfg)
    imgs = np.random.default_rng(1).uniform(size=(1, 37, 51, 3)).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(imgs)))
    with torch.no_grad():
        got = port(torch.tensor(imgs)).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= FORWARD_TOL["float32"]


# ----------------------------------------------------------------- decoder --

def _jax_cells(heatmaps, jcfg):
    """JAX's integer decisions, read through its public decoder: with a
    1-cell window a joint's pixel is its claimed cell * stride + (stride -
    1) / 2, and with joint_radius 0 every joint's claimed cell is its
    person's seed."""
    s = jcfg.heatmap_stride

    def cells(cfg):
        kp = np.asarray(jax_kcnn.decode_heatmaps(jnp.asarray(heatmaps), cfg)[0])
        yx = (kp[..., 1::-1] - (s - 1) / 2.0) / s
        assert np.array_equal(yx, np.round(yx))
        return yx.astype(np.int64)

    joint = cells(dataclasses.replace(jcfg, window=1))
    seed = cells(dataclasses.replace(jcfg, window=1, joint_radius=0))
    assert (seed == seed[..., :1, :]).all()
    return seed[..., 0, :], joint


def _assert_decode_equal(heatmaps, jcfg, tcfg):
    peaks = keypoint_cnn.find_peaks(torch.tensor(heatmaps), tcfg)
    seed, joint = _jax_cells(heatmaps, jcfg)
    np.testing.assert_array_equal(torch.stack([peaks.seed_y, peaks.seed_x], -1).numpy(), seed)
    np.testing.assert_array_equal(torch.stack([peaks.joint_y, peaks.joint_x], -1).numpy(), joint)
    want = _np(jax_kcnn.decode_heatmaps(jnp.asarray(heatmaps), jcfg))
    got = [x.numpy() for x in keypoint_cnn.decode_heatmaps(torch.tensor(heatmaps), tcfg)]
    kp, cov, det_score, det_valid = got
    np.testing.assert_array_equal(det_valid, want[3])
    # Scores are heatmap values read at the same cells: bit-equal.
    np.testing.assert_array_equal(det_score, want[2])
    np.testing.assert_array_equal(kp[..., 2], want[0][..., 2])
    np.testing.assert_allclose(kp[..., :2], want[0][..., :2], rtol=0, atol=POS_TOL_PX)
    np.testing.assert_allclose(cov, want[1], rtol=COV_RTOL, atol=COV_ATOL)
    return got


@pytest.mark.parametrize("kw", [SMALL, HIPS], ids=["small", "hips"])
def test_decode_matches_jax_on_targets(kw):
    """Clean Gaussian peaks (tests/test_models.py's planted people, plus a
    third): seeds and claimed cells exactly equal, positions within 1e-4 px."""
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(3)
    gt = np.zeros((2, 3, 17, 2), np.float32)
    for b in range(2):
        for d, (cx, cy) in enumerate([(30, 40), (90, 60), (60 + 20 * b, 20)]):
            for j in range(17):
                gt[b, d, j] = (cx + 3 * (j % 5) + rng.uniform(-1, 1),
                               cy + 3 * (j // 5) + rng.uniform(-1, 1))
    valid = np.ones((2, 3, 17), bool)
    valid[1, 2] = False  # one image with two people
    heat = np.asarray(jax_kcnn.gaussian_targets(jnp.asarray(gt), jnp.asarray(valid), jcfg,
                                                sigma=1.0))
    kp, _, _, det_valid = _assert_decode_equal(heat, jcfg, tcfg)
    assert det_valid[0].sum() >= 2 and det_valid[1].sum() >= 2


@pytest.mark.parametrize("kw", [SMALL, HIPS], ids=["small", "hips"])
def test_decode_matches_jax_on_cnn_output(kw):
    """The heatmaps of a bfloat16 flax CNN (sigmoids of bf16 logits: many
    exactly equal values, so argmax ties are common): seeds and claimed
    cells exactly equal, the first index of a tie taken on both sides."""
    jcfg, tcfg = _cfgs("bfloat16", **kw)
    model, params = jax_kcnn.init_detector(jcfg, jax.random.PRNGKey(4))
    imgs = np.random.default_rng(4).uniform(size=(3, 96, 128, 3)).astype(np.float32)
    heat = np.asarray(model.apply(params, jnp.asarray(imgs)))
    flat = heat.reshape(3, -1, 17)
    assert any(len(np.unique(flat[b, :, j])) < flat.shape[1]
               for b in range(3) for j in range(17)), "no tied values to test"
    _assert_decode_equal(heat, jcfg, tcfg)


def test_gaussian_targets_match_jax():
    jcfg, tcfg = _cfgs(**SMALL)
    rng = np.random.default_rng(5)
    kp = rng.uniform(-5, 130, size=(2, 3, 17, 2)).astype(np.float32)
    valid = rng.uniform(size=(2, 3, 17)) > 0.3
    for sigma in (1.0, 2.0):
        want = np.asarray(jax_kcnn.gaussian_targets(jnp.asarray(kp), jnp.asarray(valid), jcfg,
                                                    sigma=sigma))
        got = keypoint_cnn.gaussian_targets(torch.tensor(kp), torch.tensor(valid), tcfg,
                                            sigma=sigma).numpy()
        exact = keypoint_cnn.gaussian_targets(torch.tensor(kp, dtype=torch.float64),
                                              torch.tensor(valid), tcfg, sigma=sigma).numpy()
        # exp of the same float32 argument: each within an ulp or two of
        # the float64 value (<= 1), so within 1e-6 of each other.
        msg = (f"sigma {sigma}: port {np.abs(got - exact).max():.2e} and JAX "
               f"{np.abs(want - exact).max():.2e} from float64")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=msg)


def test_heatmap_loss_equal():
    jcfg, tcfg = _cfgs(**SMALL)
    model, params, port = _flax_and_port(jcfg, tcfg)
    rng = np.random.default_rng(6)
    imgs = rng.uniform(size=(2, 96, 128, 3)).astype(np.float32)
    targets = rng.uniform(size=(2, 12, 16, 17)).astype(np.float32)
    want = float(jax_kcnn.heatmap_loss(model, params, jnp.asarray(imgs), jnp.asarray(targets)))
    got = float(keypoint_cnn.heatmap_loss(port, torch.tensor(imgs),
                                          torch.tensor(targets)).detach())
    # A mean of 6528 squared differences of heatmaps within 1.5e-6.
    assert abs(got - want) <= 1e-6, (got, want)


# ---------------------------------------------------------------- training --

def test_joint_colors_bit_equal():
    for j in (1, 17, 21):
        got, want = train.joint_colors(j), jax_train.joint_colors(j)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_render_images_match_jax():
    rng = np.random.default_rng(7)
    kp = rng.uniform(-5, 130, size=(3, 2, 17, 2)).astype(np.float32)
    ok = rng.uniform(size=(3, 2, 17)) > 0.2
    want = np.asarray(jax_train.render_images(jnp.asarray(kp), jnp.asarray(ok), (96, 128)))
    got = train.render_images(torch.tensor(kp), torch.tensor(ok), (96, 128)).numpy()
    # exp and a 17-term color sum in another order: a few ulps of <= 1.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Chunked over cameras: one camera per chunk gives the same images.
    saved = train._RENDER_CHUNK_ELEMENTS
    try:
        train._RENDER_CHUNK_ELEMENTS = 1
        chunked = train.render_images(torch.tensor(kp), torch.tensor(ok), (96, 128))
    finally:
        train._RENDER_CHUNK_ELEMENTS = saved
    assert torch.equal(chunked, torch.tensor(got))
    # Seeded noise: reproducible, clipped to [0, 1], ~0.02 where unclipped.
    noisy = [train.render_images(torch.tensor(kp), torch.tensor(ok), (96, 128),
                                 generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(noisy[0], noisy[1])
    assert float(noisy[0].min()) >= 0 and float(noisy[0].max()) <= 1
    mid = (got > 0.1) & (got < 0.9)
    assert 0.018 < float((noisy[0].numpy() - got)[mid].std()) < 0.022


def test_training_batch_and_step_reduce_loss():
    """make_training_batch renders the JAX batch (noise aside), and Adam
    steps on a fixed batch reduce the loss (tests/test_models.py's check);
    bf16 compute sends gradients to every float32 parameter."""
    jcfg, tcfg = _cfgs("bfloat16", **SMALL)
    rng = np.random.default_rng(8)
    data = {"kp2d": np.concatenate([rng.uniform(10, 80, size=(2, 4, 3, 17, 2)),
                                    rng.uniform(size=(2, 4, 3, 17, 1))], -1).astype(np.float32),
            "det_valid": rng.uniform(size=(2, 4, 3)) > 0.2}
    sel = np.array([3, 0])
    want = _np(jax_train.make_training_batch(data, 1, sel, jcfg, None))
    images, targets = train.make_training_batch(data, 1, sel, tcfg, None, device="cpu")
    np.testing.assert_allclose(images.numpy(), want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(targets.numpy(), want[1], rtol=0, atol=1e-6)

    port = keypoint_cnn.init_detector(tcfg, torch.Generator().manual_seed(1), device="cpu")
    opt = torch.optim.Adam(port.parameters(), lr=1e-3)
    losses = []
    for _ in range(8):
        loss = keypoint_cnn.heatmap_loss(port, images, targets)
        opt.zero_grad()
        loss.backward()
        assert all(p.grad is not None and p.grad.dtype == torch.float32
                   for p in port.parameters())
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.9, losses


@pytest.fixture(scope="module")
def trained():
    """tests/test_models.py's trained detector, trained by the port:
    HIPS at bf16 compute on the steep overhead 6-camera ring (2 people,
    seed 19), 300 Adam steps on rendered frames. Returns (model, loss,
    scene, frames, ring extrinsics P and intrinsics K, people)."""
    cams, people = 6, 2
    P = cameras.ring_extrinsics(cams, radius=2.2, heights=(3.4, 4.0, 4.6), look_at_z=0.8)
    K = np.tile(np.asarray((100.0, 100.0, 64.0, 48.0)), (cams, 1))
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(num_cameras=cams, num_people=people, num_frames=10,
                              pixel_noise=0.0, keypoint_dropout=0.0, detection_dropout=0.0,
                              area=(3.4, 3.4), seed=19),
        rig=cameras.build_rig(P, K, (128, 96), dtype=torch.float64, device="cpu"),
    )
    data = synthetic.frames_from_scene(scene)
    model, loss = train.train_detector(keypoint_cnn.DetectorConfig(**HIPS), data, steps=300,
                                       batch_cams=3, lr=2e-3, seed=0, device="cpu")
    return model, loss, scene, data, P, K, people


def _ring_images(data, t, image_size):
    kp2d = torch.tensor(data["kp2d"][t])
    ok = torch.tensor(data["det_valid"][t])[..., None] & (kp2d[..., 2] > 0)
    return train.render_images(kp2d[..., :2], ok, image_size)


def _ring_config(module, cams):
    return module.PipelineConfig(
        fusion=module.FusionConfig(num_cameras=cams, max_dets_per_cam=3, max_hypotheses=6),
        tracker=module.TrackerConfig(max_tracks=6),
    )


def test_trained_pixels_to_3d(trained):
    """train_detector (bf16 compute), then the end-to-end step over 4
    frames: every person recovered, mean joint error < 5 cm and max < 8 cm
    (tests/test_models.py's thresholds)."""
    model, loss, scene, data, P, K, people = trained
    assert loss < 5e-3, loss  # heatmaps actually learned
    det_cfg = keypoint_cnn.DetectorConfig(**HIPS)
    step, model2, state = end_to_end.make_end_to_end(
        cameras.build_rig(P, K, (128, 96), device="cpu"), _ring_config(config, P.shape[0]),
        det_cfg, device="cpu")
    model2.load_state_dict(model.state_dict())
    to_fusion = np.asarray(skeleton.SIMPLE_MODEL.to_fusion)
    errs_all = []
    for t in range(4):
        stamps = torch.as_tensor(data["cam_stamp"][t], dtype=torch.float32)
        state, out = step(state, _ring_images(data, t, det_cfg.image_size), stamps)
        errs, _ = match_to_gt(out.persons_raw.xyz.numpy(), out.persons_raw.score.numpy(),
                              out.persons_raw.valid.numpy(), scene["gt_xyz"][t], to_fusion)
        errs_all.append(errs)
    errs_all = np.concatenate(errs_all)
    assert np.isfinite(errs_all).all(), errs_all
    assert errs_all.shape[0] == 4 * people
    assert errs_all.mean() < 0.05, errs_all
    assert errs_all.max() < 0.08, errs_all


# -------------------------------------------------------------- end to end --

def _random_hall4(request):
    """tests/test_models.py's fused step: 4 hall cameras, random weights,
    uniform-noise images, 2 frames (the detector finds no person)."""
    jcfg, tcfg = _cfgs("float32", **SMALL)
    kw_f = dict(num_cameras=4, max_dets_per_cam=3, max_hypotheses=6)
    jpc = jax_config.PipelineConfig(fusion=jax_config.FusionConfig(**kw_f),
                                    tracker=jax_config.TrackerConfig(max_tracks=6))
    tpc = config.PipelineConfig(fusion=config.FusionConfig(**kw_f),
                                tracker=config.TrackerConfig(max_tracks=6))
    jstep, _, params, jstate = jax_e2e.make_end_to_end(
        jax_cameras.hall_rig(4, image_size=(128, 96)), jpc, jcfg, jax.random.PRNGKey(2))
    step, model, state = end_to_end.make_end_to_end(
        cameras.hall_rig(4, image_size=(128, 96), device="cpu"), tpc, tcfg, device="cpu")
    model.load_state_dict(convert.detector_params_from_flax(jax.device_get(params)))
    imgs = np.random.default_rng(0).uniform(size=(4, 96, 128, 3)).astype(np.float32)
    frames = [(imgs, np.full((4,), 1.0 + t / 30, np.float32)) for t in range(2)]
    return (jstep, params, jstate), (step, state), frames, 0


def _trained_ring6(request):
    """The port-trained detector's weights, carried into flax, on both
    sides with float32 compute: the trained test's ring and 4 frames, every
    person found."""
    model, _, _, data, P, K, people = request.getfixturevalue("trained")
    jcfg, tcfg = _cfgs("float32", **HIPS)
    cams = P.shape[0]
    params = jax.tree_util.tree_map(jnp.asarray, convert.detector_params_to_flax(model.state_dict()))
    jstep, _, _, jstate = jax_e2e.make_end_to_end(
        jax_cameras.build_rig(P, K, (128, 96)), _ring_config(jax_config, cams), jcfg,
        jax.random.PRNGKey(0))
    step, port, state = end_to_end.make_end_to_end(
        cameras.build_rig(P, K, (128, 96), device="cpu"), _ring_config(config, cams), tcfg,
        device="cpu")
    port.load_state_dict(model.state_dict())
    frames = [(_ring_images(data, t, tcfg.image_size).numpy(),
               np.asarray(data["cam_stamp"][t], np.float32)) for t in range(4)]
    return (jstep, params, jstate), (step, state), frames, people


@pytest.mark.parametrize("case", [_random_hall4, _trained_ring6],
                         ids=["random_hall4", "trained_ring6"])
def test_end_to_end_step_matches_jax(case, request):
    """JAX's end_to_end_step and the port's on the same weights, images and
    stamps, float32 compute on both sides: every integer decision equal,
    joints within 1 mm."""
    (jstep, params, jstate), (step, state), frames, people = case(request)
    for t, (imgs, stamps) in enumerate(frames):
        jstate, want = jax.device_get(jstep(jstate, jnp.asarray(imgs), jnp.asarray(stamps),
                                            params))
        state, got = step(state, torch.tensor(imgs), torch.tensor(stamps))
        assert int(want.persons_raw.valid.sum()) >= people, t
        for name in ("persons_raw", "fused", "fused_pred"):
            g, w = getattr(got, name), getattr(want, name)
            msg = f"t{t} {name}"
            np.testing.assert_array_equal(g.valid.numpy(), w.valid, err_msg=msg)
            np.testing.assert_array_equal(g.person_id.numpy(), w.person_id, err_msg=msg)
            np.testing.assert_array_equal(g.score.numpy() > 0, w.score > 0, err_msg=msg)
            ok = w.valid[:, None] & (w.score > 0)
            np.testing.assert_allclose(g.xyz.numpy()[ok], w.xyz[ok], rtol=0, atol=JOINT_TOL_M,
                                       err_msg=msg)
            assert np.isfinite(g.xyz.numpy()).all(), msg
        np.testing.assert_array_equal(got.feedback.kp_valid.numpy(), want.feedback.kp_valid)
        assert np.isfinite(got.feedback.kp2d.numpy()).all()
        for name in ("n_dropped_hypotheses", "n_dropped_track_spawns"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name))
        np.testing.assert_array_equal(got.fb_delay_per_cam_raw.numpy(), np.full(len(stamps), -1.0))
    for name, g in zip(state._fields, state):
        if not g.dtype.is_floating_point:
            np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(jstate, name)), err_msg=name)


def test_make_end_to_end_checks_its_arguments():
    rig = cameras.hall_rig(4, image_size=(128, 96), device="cpu")
    tpc = _ring_config(config, 4)
    bad = keypoint_cnn.DetectorConfig(**{**SMALL, "max_detections": 4})
    with pytest.raises(ValueError, match="max_dets_per_cam"):
        end_to_end.make_end_to_end(rig, tpc, bad, device="cpu")
    step, model, state = end_to_end.make_end_to_end(
        rig, tpc, keypoint_cnn.DetectorConfig(**SMALL), torch.Generator().manual_seed(0),
        device="cpu")
    again = end_to_end.make_end_to_end(
        rig, tpc, keypoint_cnn.DetectorConfig(**SMALL), torch.Generator().manual_seed(0),
        device="cpu")[1]
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k  # one seed, one detector
    # The step leaves its input state alone, as pipeline.step does.
    before = [t.clone() for t in state]
    imgs = torch.rand(4, 96, 128, 3, generator=torch.Generator().manual_seed(1))
    new_state, out = step(state, imgs, torch.ones(4))
    assert all(torch.equal(a, b) for a, b in zip(before, state))
    assert float(new_state.t_prev_global) == 1.0 and out.fused.xyz.shape == (6, 21, 3)


# ----------------------------------------------------------------- cameras --

def test_project_to_pixels_matches_jax():
    rng = np.random.default_rng(9)
    K = np.asarray([600.0, 610.0, 320.0, 240.0])
    pts = np.concatenate([rng.uniform(-2, 2, size=(5, 7, 2)), rng.uniform(0.5, 9, size=(5, 7, 1))],
                         -1)
    for dt, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        want = np.asarray(jax_cameras.project_to_pixels(jnp.asarray(pts, dt), jnp.asarray(K, dt)))
        got = cameras.project_to_pixels(torch.as_tensor(pts, dtype=tdt),
                                        torch.as_tensor(K, dtype=tdt)).numpy()
        assert got.dtype == want.dtype and got.shape == (5, 7, 2)
        np.testing.assert_array_equal(got, want)
    got = cameras.project_to_pixels(torch.tensor([0.1, -0.2, 2.0]),
                                    torch.tensor([600.0, 610.0, 320.0, 240.0]))
    np.testing.assert_allclose(got.numpy(), [600 * 0.05 + 320, 610 * -0.1 + 240])
