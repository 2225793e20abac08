"""The port's detector training step (models/train.py: `make_train_step`,
optax's Adam written out) against the JAX package's jitted `step_fn`.

`step_fn` is written here as the JAX package's train_detector writes it:
jax.value_and_grad of heatmap_loss, optax.adam(lr).update and
optax.apply_updates, jitted. Both sides start from one flax init carried
across by `convert.detector_params_from_flax` (and, mid-training, from
JAX's state after a few steps, its optimizer state carried by
`convert.adam_state_from_optax`) and train on the same noise-free batches
(make_training_batch without a key / generator). Small sizes: 96x128
images, width 32, float32 compute; torch runs on the CPU.

The pieces are held apart because Adam's normalisation magnifies float32
gradient noise where a gradient is near eps: the loss, the gradients from
identical parameters, the Adam update from identical gradients, and then
the parameters after a few chained steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smartedgesensor3dhumanpose_tpu.models import keypoint_cnn as jax_kcnn
from smartedgesensor3dhumanpose_tpu.models import train as jax_train
from smartedgesensor3dhumanpose_tpu_torch import convert
from smartedgesensor3dhumanpose_tpu_torch.models import keypoint_cnn, train
from smartedgesensor3dhumanpose_tpu_torch.ops import linalg
from test_torch_models import SMALL, _cfgs, _flax_and_port

pytestmark = pytest.mark.torch_port

LR = 2e-3
# Chained steps compared, and the JAX steps taken before the mid-training
# start.
CHAINED_STEPS = 3
MID_STEPS = 5
# Loss of the same parameters on the same batch: test_heatmap_loss_equal's
# bound (a mean of squared differences of heatmaps within 1.5e-6; measured
# <= 5.5e-7 here).
LOSS_TOL = 1e-6
# Gradients from identical parameters, per tensor, relative to the tensor's
# largest gradient: the same products summed in another order by XLA's and
# oneDNN's convolutions and their transposes (measured <= 2.9e-5).
GRAD_RTOL = 1e-4
# The Adam update from identical gradients: each of params, mu and nu
# within this many float32 ulps of the tensor's largest magnitude. XLA's CPU
# compiler contracts optax's (1 - b) * g + b * m into a fused multiply-add
# (a numpy emulation of the fused form equals it bit for bit); the port
# rounds the product first, as separate float32 operations on the card do,
# so an element can move by an ulp per step. Measured <= 4 ulps over 50
# steps (mid-training parameters; 1 from unit-scale ones).
ADAM_ULPS = 8
ADAM_STEPS = 50
# Parameters after CHAINED_STEPS chained steps. Adam moves an element by
# about lr per step whatever its gradient's size, so where a gradient lies
# near eps (1e-8) float32 noise in it (GRAD_RTOL above) changes that step by
# up to ~lr. Measured here 3.0e-5 (fresh) and 5.4e-7 (mid); 7.8e-4 (0.39 lr)
# in an earlier trial of this comparison on other batches. The budget is
# half an Adam step.
CHAINED_PARAM_TOL = 0.5 * LR


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs (see
    test_torch_models.py: torch's default oversubscribes xdist workers)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _jax_step_fn(model, tx):
    """The JAX package's step_fn (its models/train.py), jitted."""

    @jax.jit
    def step_fn(params, opt_state, images, targets):
        loss, grads = jax.value_and_grad(
            lambda p: jax_kcnn.heatmap_loss(model, p, images, targets)
        )(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    return step_fn


def _scene_data(seed=8, frames=4, cams=4, dets=3):
    """Random pixel keypoints inside a 96x128 image, made with numpy."""
    rng = np.random.default_rng(seed)
    kp = np.concatenate([rng.uniform(10, 80, size=(frames, cams, dets, 17, 2)),
                         rng.uniform(size=(frames, cams, dets, 17, 1))], -1)
    return {"kp2d": kp.astype(np.float32),
            "det_valid": rng.uniform(size=(frames, cams, dets)) > 0.2}


def _batches(data, jcfg, tcfg, n, seed):
    """n noise-free batches of 2 cameras: (JAX's, the port's)."""
    rng = np.random.default_rng(seed)
    frames, cams = data["kp2d"].shape[:2]
    out = []
    for _ in range(n):
        t, sel = int(rng.integers(0, frames)), rng.choice(cams, size=2, replace=False)
        out.append((jax_train.make_training_batch(data, t, sel, jcfg, None),
                    train.make_training_batch(data, t, sel, tcfg, None, device="cpu")))
    return out


@pytest.fixture(scope="module")
def setup():
    """The flax model and optax.adam, the port's model and step, the
    batches, and the two start states: fresh (the flax init, tx.init) and
    mid-training (after MID_STEPS JAX steps), each as (JAX params, JAX
    opt_state)."""
    jcfg, tcfg = _cfgs(**SMALL)
    model, params, port = _flax_and_port(jcfg, tcfg)
    tx = optax.adam(LR)
    step_fn = _jax_step_fn(model, tx)
    data = _scene_data()
    warm = _batches(data, jcfg, tcfg, MID_STEPS, seed=1)
    batches = _batches(data, jcfg, tcfg, CHAINED_STEPS, seed=2)
    starts = {"fresh": (params, tx.init(params))}
    p, s = starts["fresh"]
    for (images, targets), _ in warm:
        p, s, _ = step_fn(p, s, images, targets)
    starts["mid"] = (p, s)
    return dict(model=model, tx=tx, step_fn=step_fn, port=port, batches=batches,
                starts=starts, names=train.param_names(port))


def _port_state(setup, start):
    """The start as the port's (params, AdamState), carried across."""
    params, opt_state = setup["starts"][start]
    state = convert.detector_params_from_flax(jax.device_get(params))
    port_params = tuple(state[n] for n in setup["names"])
    return port_params, convert.adam_state_from_optax(jax.device_get(opt_state),
                                                      setup["names"], device="cpu")


def _as_port(tree, names):
    """A flax-shaped tree (params, grads or moments) as a tuple in the
    port's order."""
    state = convert.detector_params_from_flax(jax.device_get(tree))
    return tuple(state[n] for n in names)


START = pytest.mark.parametrize("start", ["fresh", "mid"])


@START
def test_gradients_match_jax(setup, start):
    """jax.value_and_grad of heatmap_loss and the port's make_value_and_grad
    from identical parameters on each batch: the loss within LOSS_TOL, each
    gradient tensor within GRAD_RTOL of its largest element."""
    params, _ = setup["starts"][start]
    port_params, _ = _port_state(setup, start)
    value_and_grad = train.make_value_and_grad(setup["port"])
    worst_loss = worst_grad = 0.0
    for (j_images, j_targets), (images, targets) in setup["batches"]:
        want_loss, want = jax.value_and_grad(
            lambda p: jax_kcnn.heatmap_loss(setup["model"], p, j_images, j_targets))(params)
        loss, grads = value_and_grad(port_params, images, targets)
        worst_loss = max(worst_loss, abs(float(loss) - float(want_loss)))
        for name, g, w in zip(setup["names"], grads, _as_port(want, setup["names"])):
            rel = float((g - w).abs().max() / w.abs().max())
            assert rel <= GRAD_RTOL, (name, rel)
            worst_grad = max(worst_grad, rel)
    print(f"{start}: loss worst {worst_loss:.2e} (tol {LOSS_TOL:.0e}), "
          f"gradients worst {worst_grad:.2e} of the largest (tol {GRAD_RTOL:.0e})")
    assert worst_loss <= LOSS_TOL, worst_loss


@START
def test_adam_update_matches_optax(setup, start):
    """optax.adam(lr).update + apply_updates and the port's adam_update + add
    from the same state on the same gradients, ADAM_STEPS steps: params, mu
    and nu within ADAM_ULPS float32 ulps of each tensor's largest magnitude,
    count exact. Fresh: unit-scale random parameters; mid: the detector's
    mid-training parameters and optimizer state. The gradients span 1e-12
    to 1 with random signs."""
    tx, names = setup["tx"], setup["names"]
    rng = np.random.default_rng(11)
    if start == "fresh":
        params = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
            setup["starts"]["fresh"][0])
        opt_state = tx.init(params)
    else:
        params, opt_state = setup["starts"]["mid"]
    port_params = _as_port(params, names)
    state = convert.adam_state_from_optax(jax.device_get(opt_state), names, device="cpu")

    @jax.jit
    def jax_update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state

    worst = {"params": 0.0, "mu": 0.0, "nu": 0.0}
    for _ in range(ADAM_STEPS):
        grads = jax.tree.map(
            lambda x: jnp.asarray((rng.choice([-1.0, 1.0], size=x.shape)
                                   * 10.0 ** rng.uniform(-12, 0, size=x.shape))
                                  .astype(np.float32)), params)
        params, opt_state = jax_update(params, opt_state, grads)
        updates, state = train.adam_update(_as_port(grads, names), state, LR)
        port_params = tuple(p + u for p, u in zip(port_params, updates))
        for key, got, want in (("params", port_params, _as_port(params, names)),
                               ("mu", state.mu, _as_port(opt_state[0].mu, names)),
                               ("nu", state.nu, _as_port(opt_state[0].nu, names))):
            for name, g, w in zip(names, got, want):
                ulps = float((g - w).abs().max() / np.spacing(np.float32(w.abs().max())))
                assert ulps <= ADAM_ULPS, (key, name, ulps)
                worst[key] = max(worst[key], ulps)
        assert state.count.dtype == torch.int32
        assert int(state.count) == int(opt_state[0].count)
    print(f"{start}: worst ulps of the largest magnitude {worst} (tol {ADAM_ULPS})")


@START
def test_chained_steps_match_jax(setup, start):
    """CHAINED_STEPS steps of JAX's jitted step_fn and of the port's step,
    each side on its own batches and state: the loss of every step within
    LOSS_TOL, count exact, and the parameters at the end within
    CHAINED_PARAM_TOL."""
    params, opt_state = setup["starts"][start]
    port_params, state = _port_state(setup, start)
    step = train.make_train_step(setup["port"], LR)
    worst_loss = 0.0
    for (j_images, j_targets), (images, targets) in setup["batches"]:
        params, opt_state, want_loss = setup["step_fn"](params, opt_state, j_images, j_targets)
        port_params, state, loss = step(port_params, state, images, targets)
        worst_loss = max(worst_loss, abs(float(loss) - float(want_loss)))
    assert int(state.count) == int(opt_state[0].count)
    worst = max(float((g - w).abs().max())
                for g, w in zip(port_params, _as_port(params, setup["names"])))
    print(f"{start}: loss worst {worst_loss:.2e} (tol {LOSS_TOL:.0e}), parameters after "
          f"{CHAINED_STEPS} steps worst {worst:.2e} (tol {CHAINED_PARAM_TOL:.1e})")
    assert worst_loss <= LOSS_TOL, worst_loss
    assert worst <= CHAINED_PARAM_TOL, worst


def test_adam_state_round_trip(setup):
    """optax's mid-training state -> AdamState -> optax is bit-equal, leaf by
    leaf at the same tree paths, and optax's update takes the result as
    its state with the same outcome."""
    names, tx = setup["names"], setup["tx"]
    params, opt_state = setup["starts"]["mid"]
    opt_state = jax.device_get(opt_state)
    state = convert.adam_state_from_optax(opt_state, names, device="cpu")
    assert state.count.dtype == torch.int32 and state.count.shape == ()
    assert int(state.count) == MID_STEPS
    assert [tuple(m.shape) for m in state.mu] == [
        tuple(p.shape) for p in setup["port"].parameters()]
    back = convert.adam_state_to_optax(state, names)
    want = jax.tree_util.tree_flatten_with_path(opt_state)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [
        jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), jax.tree_util.keystr(path)
    grads = jax.tree.map(jnp.ones_like, params)
    for a, b in zip(jax.tree.leaves(tx.update(grads, opt_state)),
                    jax.tree.leaves(tx.update(grads, back))):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_step_is_functional(setup):
    """The step writes nothing but its outputs: the input params and Adam
    state, the module's own parameters and their .grad are unchanged (a
    captured graph's warm-up must not train an extra step)."""
    port = setup["port"]
    params, state = _port_state(setup, "mid")
    before = [t.clone() for t in (*params, state.count, *state.mu, *state.nu)]
    module_before = [p.detach().clone() for p in port.parameters()]
    _, (images, targets) = setup["batches"][0]
    new_params, new_state, _ = train.make_train_step(port, LR)(params, state, images, targets)
    after = (*params, state.count, *state.mu, *state.nu)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert all(torch.equal(p, b) and p.grad is None
               for p, b in zip(port.parameters(), module_before))
    assert int(new_state.count) == int(state.count) + 1
    assert not any(torch.equal(a, b) for a, b in zip(new_params, params))


def test_count_saturates():
    """optax.safe_increment: the int32 count stops at its largest value."""
    p = (torch.ones(3),)
    top = train.AdamState(torch.tensor(2 ** 31 - 1, dtype=torch.int32), (torch.zeros(3),),
                          (torch.zeros(3),))
    _, state = train.adam_update((torch.ones(3),), top, LR)
    assert int(state.count) == 2 ** 31 - 1
    _, state = train.adam_update((torch.ones(3),), train.adam_init(p), LR)
    assert int(state.count) == 1 and state.count.dtype == torch.int32


def test_bf16_step_reduces_loss():
    """With bfloat16 compute every float32 parameter gets a gradient and
    moves, and steps on a fixed batch reduce the loss
    (tests/test_models.py's check, through the port's step)."""
    _, tcfg = _cfgs("bfloat16", **SMALL)
    port = keypoint_cnn.init_detector(tcfg, torch.Generator().manual_seed(1), device="cpu")
    images, targets = train.make_training_batch(_scene_data(), 1, np.array([3, 0]), tcfg,
                                                None, device="cpu")
    params0 = params = train.initial_params(port)
    state = train.adam_init(params)
    step = train.make_train_step(port, 1e-3)
    losses = []
    for _ in range(8):
        params, state, loss = step(params, state, images, targets)
        losses.append(float(loss))
    assert all(p.dtype == torch.float32 and not torch.equal(p, q)
               for p, q in zip(params, params0))
    assert losses[-1] < losses[0] * 0.9, losses


# A detector small enough that JAX's jit of its train_detector's step_fn
# compiles in a second or two.
TINY = dict(image_size=(16, 16), heatmap_stride=4, width=8, depth=2, max_detections=2,
            nms_radius=2)


def test_train_detector_draws_match_jax(monkeypatch):
    """train_detector's batches are the (frame, cameras) rows that the JAX
    package's training loop draws for the same seed, in its order; and it
    trains a detector whose parameters moved and whose loss is finite."""
    data = _scene_data(seed=3, frames=5, cams=4, dets=2)
    data["kp2d"][..., :2] *= 0.2
    steps, batch_cams, seed = 6, 3, 4
    drawn, rendered = [], []
    make_batch = jax_train.make_training_batch

    def record_jax(scene, t, cam_sel, det_cfg, rng_key):
        drawn.append((t, np.array(cam_sel)))
        return make_batch(scene, t, cam_sel, det_cfg, rng_key)

    monkeypatch.setattr(jax_train, "make_training_batch", record_jax)
    jax_train.train_detector(jax_kcnn.DetectorConfig(**TINY), data, steps=steps,
                             batch_cams=batch_cams, seed=seed)
    port_batch = train._batch

    def record_port(kp2d, det_valid, det_cfg, generator):
        rendered.append((kp2d, det_valid))
        return port_batch(kp2d, det_valid, det_cfg, generator)

    monkeypatch.setattr(train, "_batch", record_port)
    tcfg = keypoint_cnn.DetectorConfig(**TINY)
    model, loss = train.train_detector(tcfg, data, steps=steps, batch_cams=batch_cams,
                                       seed=seed, device="cpu")
    assert len(drawn) == len(rendered) == steps
    for (t, sel), (kp2d, valid) in zip(drawn, rendered):
        assert np.array_equal(kp2d.numpy(), data["kp2d"][t][sel])
        assert np.array_equal(valid.numpy(), data["det_valid"][t][sel])
    rows = train.training_draws(5, 4, steps, batch_cams, seed)
    assert np.array_equal(rows, [t * 4 + sel for t, sel in drawn])
    init = keypoint_cnn.init_detector(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    assert np.isfinite(loss)
    assert all(not torch.equal(p, q) for p, q in zip(model.parameters(), init.parameters()))


class _Reached(Exception):
    pass


def test_training_on_cuda_requires_ieee_fp32(monkeypatch):
    """train_detector and make_train_step on CUDA call
    linalg.require_ieee_fp32 (float32 convolutions must not run in TF32),
    train_detector before it touches the device; on the CPU neither does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def reached():
        raise _Reached

    monkeypatch.setattr(linalg, "require_ieee_fp32", reached)
    with pytest.raises(_Reached):
        train.train_detector(keypoint_cnn.DetectorConfig(**TINY), _scene_data(), steps=1,
                             device="cuda")
    cpu_model = keypoint_cnn.init_detector(keypoint_cnn.DetectorConfig(**TINY), device="cpu")
    train.make_train_step(cpu_model, LR)
    with FakeTensorMode():
        cuda_model = torch.nn.Module()
        cuda_model.weight = torch.nn.Parameter(torch.empty(3, device="cuda"))
        with pytest.raises(_Reached):
            train.make_train_step(cuda_model, LR)
