"""The port's online and offline slices against the JAX package: the
framework-free pieces bit for bit, fusion, the per-frame pipeline and the
offline replay in float64, resumes from a JAX TrackerState, and the float32
golden files the card is held to.

Inputs are made once with numpy from a seed and fed to both sides; JAX runs
on the CPU with x64 as conftest sets it up, the port on CPU tensors (its
kernels' plain versions).
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import config as jax_config
from smartedgesensor3dhumanpose_tpu import pipeline as jax_pipeline
from smartedgesensor3dhumanpose_tpu import skeleton as jax_skeleton
from smartedgesensor3dhumanpose_tpu.io import synthetic as jax_synthetic
from smartedgesensor3dhumanpose_tpu.types import Frame as JaxFrame
from smartedgesensor3dhumanpose_tpu_torch import (
    cameras,
    checkpoint,
    config,
    convert,
    demo,
    fusion,
    online,
    pipeline,
    profiling,
    skeleton,
)
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.models import end_to_end, keypoint_cnn, train
from smartedgesensor3dhumanpose_tpu_torch.ops import linalg, tracker
from smartedgesensor3dhumanpose_tpu_torch.parallel import sharding
from smartedgesensor3dhumanpose_tpu_torch.types import Frame, TrackerState

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_golden_demo16.npz")
GOLDEN_OFFLINE = os.path.join(_REPO, "tests", "data", "torch_golden_offline16.npz")
CAMS, PEOPLE, FRAMES, SEED = 8, 3, 14, 5  # past min_num_obs = 10
RESUME_AT = 8
# float64 on both sides: the two differ only in summation order and in
# where the LM stops inside its 1e-5 error tolerance; measured ~1e-14 m.
F64_TOL_M = 1e-6


def _config_pair():
    kw_f = dict(num_cameras=CAMS, max_dets_per_cam=PEOPLE, max_hypotheses=2 * PEOPLE)
    kw_t = dict(max_tracks=2 * PEOPLE)
    return (
        jax_config.PipelineConfig(
            fusion=jax_config.FusionConfig(**kw_f),
            tracker=jax_config.TrackerConfig(**kw_t),
        ),
        config.PipelineConfig(
            fusion=config.FusionConfig(**kw_f), tracker=config.TrackerConfig(**kw_t)
        ),
    )


def _frames64():
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=CAMS, num_people=PEOPLE, num_frames=FRAMES, seed=SEED
    ))
    data = synthetic.frames_from_scene(scene, np.float64)
    return [{k: v[t] for k, v in data.items()} for t in range(FRAMES)]


@pytest.fixture(scope="module")
def jax_run():
    """JAX Pipeline.step over the scene in float64: per-frame outputs and
    the state after RESUME_AT frames."""
    jcfg, _ = _config_pair()
    pipe = jax_pipeline.Pipeline(jax_cameras.hall_rig(CAMS, dtype=jnp.float64), jcfg)
    state = pipe.init_state(dtype=jnp.float64)
    outs, resume_state = [], None
    for t, arrays in enumerate(_frames64()):
        if t == RESUME_AT:
            resume_state = jax.device_get(state)
        state, out = pipe.step(state, JaxFrame.from_arrays(arrays))
        outs.append(jax.device_get(out))
    return outs, resume_state


def _assert_step_equal(got, want, msg):
    for name in ("persons_raw", "fused", "fused_pred"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g.valid.numpy(), w.valid, err_msg=f"{msg} {name}")
        np.testing.assert_array_equal(g.person_id.numpy(), w.person_id, err_msg=f"{msg} {name}")
        np.testing.assert_array_equal(g.score.numpy() > 0, w.score > 0, err_msg=f"{msg} {name}")
        np.testing.assert_allclose(g.xyz.numpy(), w.xyz, rtol=0, atol=F64_TOL_M, err_msg=msg)
        np.testing.assert_allclose(g.cov.numpy(), w.cov, rtol=1e-6, atol=1e-12, err_msg=msg)
    np.testing.assert_array_equal(got.feedback.kp_valid.numpy(), want.feedback.kp_valid)
    np.testing.assert_allclose(got.feedback.kp2d.numpy(), want.feedback.kp2d, atol=1e-6)
    for name in ("n_dropped_hypotheses", "n_dropped_track_spawns"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=f"{msg} {name}")
    np.testing.assert_allclose(got.pred_delta_t.numpy(), want.pred_delta_t, atol=1e-12)
    np.testing.assert_allclose(got.bbox3d_center.numpy(), want.bbox3d_center, atol=F64_TOL_M)
    np.testing.assert_allclose(got.bbox3d_size.numpy(), want.bbox3d_size, atol=F64_TOL_M)


def _assert_state_equal(got: TrackerState, want, msg):
    """Integers and masks exact, floats within F64_TOL_M (float64 both)."""
    for name, g in zip(TrackerState._fields, got):
        w = np.asarray(getattr(want, name))
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=F64_TOL_M,
                                       err_msg=f"{msg} {name}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{msg} {name}")


# ---------------------------------------------------- framework-free pieces --

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hall_rig_identical(dtype):
    want = jax_cameras.hall_rig(16, dtype=getattr(jnp, dtype))
    got = cameras.hall_rig(16, dtype=getattr(torch, dtype), device="cpu")
    for field in ("K", "P", "F", "image_size"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))


@pytest.mark.parametrize("knobs", [
    {},
    dict(num_ghost_slots=2, ghost_rate=0.5, identity_swap_rate=0.15, occlusion_events=2),
    dict(pose_method="h36m", shuffle_detections=False),
])
def test_generate_scene_identical(knobs):
    kw = dict(num_cameras=6, num_people=3, num_frames=12, seed=3, **knobs)
    want = jax_synthetic.generate_scene(jax_synthetic.SceneConfig(**kw))
    got = synthetic.generate_scene(synthetic.SceneConfig(**kw))
    for k in ("gt_xyz", "kp2d", "cov2d", "det_valid", "det_score", "cam_stamp", "fb_delay"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype


def test_epoch_stamps_collapse_alike():
    """ROADMAP C4: both packages cast cam_stamp to float32 with no origin
    rebase. At unix-epoch stamps (~1.7e9 s) the float32 step is 128 s, so
    a scene's frame and camera offsets (under a second here) all collapse
    onto one grid value, on both sides alike. This pins that the port
    mirrors the reference's hazard bit for bit; a fix (an origin rebase)
    belongs to both packages at once."""
    frames = _frames64()
    arrays = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    arrays["cam_stamp"] = arrays["cam_stamp"] + 1.7e9 + 0.25
    assert len(np.unique(arrays["cam_stamp"])) > 1
    got = Frame.from_arrays(arrays, "cpu").cam_stamp.numpy()
    want = np.asarray(JaxFrame.from_arrays(arrays).cam_stamp)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.all(np.mod(got.astype(np.float64), 128.0) == 0.0)
    np.testing.assert_array_equal(np.unique(got), np.float32([1.7e9]))


def test_skeleton_tables_identical():
    for name in dir(jax_skeleton):
        val = getattr(jax_skeleton, name)
        if isinstance(val, (np.ndarray, int, float, tuple)) and not name.startswith("__"):
            np.testing.assert_array_equal(np.asarray(getattr(skeleton, name)), np.asarray(val))
    for method in ("simple", "h36m"):
        a, b = jax_skeleton.input_model(method), skeleton.input_model(method)
        for field in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(b, field.name), getattr(a, field.name))
    for norm in (False, True):
        for x, y in zip(skeleton.bone_tables(norm, 1.5), jax_skeleton.bone_tables(norm, 1.5)):
            np.testing.assert_array_equal(x, y)


def test_config_defaults_identical():
    """Every knob equal, assignment_impl and solver included; a name the
    port does not know is refused."""
    pairs = [
        (jax_config.PipelineConfig.demo_16cam(), config.PipelineConfig.demo_16cam()),
        (jax_config.PipelineConfig.scaled_64cam(), config.PipelineConfig.scaled_64cam()),
    ]
    for want, got in pairs:
        for section in ("fusion", "prior", "tracker"):
            w = dataclasses.asdict(getattr(want, section))
            g = dataclasses.asdict(getattr(got, section))
            assert g == w, section
        assert got.dtype == want.dtype
    with pytest.raises(ValueError):
        config.PipelineConfig(fusion=config.FusionConfig(assignment_impl="hungarian"))
    with pytest.raises(ValueError):
        config.PipelineConfig(prior=config.PriorConfig(solver="cholesky"))


# ------------------------------------------------------------ fusion + step --

def test_fuse_frame_matches_jax_f64(jax_run):
    """fusion.fuse_frame against the persons_raw of JAX Pipeline.step (the
    same fuse_frame after the stale-camera mask)."""
    outs, _ = jax_run
    _, tcfg = _config_pair()
    trig = cameras.hall_rig(CAMS, dtype=torch.float64, device="cpu")
    for t, arrays in enumerate(_frames64()[:4]):
        frame, _ = pipeline.mask_stale_cameras(
            Frame.from_arrays(arrays, "cpu"), tcfg.fusion.max_sync_diff
        )
        got, got_drop = fusion.fuse_frame(frame, trig, tcfg.fusion, with_stats=True)
        want = outs[t].persons_raw
        np.testing.assert_array_equal(got.valid.numpy(), want.valid)
        assert want.valid.sum() == PEOPLE
        np.testing.assert_array_equal(got.score.numpy() > 0, want.score > 0)
        # Same float64 algebra in another summation order.
        np.testing.assert_allclose(got.xyz.numpy(), want.xyz, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got.score.numpy(), want.score, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got.cov.numpy(), want.cov, rtol=1e-6, atol=1e-14)
        assert int(got_drop) == int(outs[t].n_dropped_hypotheses)


def test_pipeline_steps_match_jax_f64(jax_run):
    outs, _ = jax_run
    _, tcfg = _config_pair()
    pipe = pipeline.Pipeline(cameras.hall_rig(CAMS, dtype=torch.float64, device="cpu"), tcfg,
                             device="cpu")
    state = pipe.init_state(dtype=torch.float64)
    for t, arrays in enumerate(_frames64()):
        state, out = pipe.step(state, Frame.from_arrays(arrays, "cpu"))
        _assert_step_equal(out, outs[t], f"t{t}")
    assert outs[-1].fused.valid.sum() == PEOPLE  # the publish gate was crossed


def test_resume_from_jax_state(jax_run):
    """A JAX TrackerState taken mid-sequence continues identically in the
    port through convert.tracker_state_from_numpy."""
    outs, resume_state = jax_run
    _, tcfg = _config_pair()
    pipe = pipeline.Pipeline(cameras.hall_rig(CAMS, dtype=torch.float64, device="cpu"), tcfg,
                             device="cpu")
    state = convert.tracker_state_from_numpy(resume_state._asdict(), device="cpu")
    assert state.track_id.dtype == torch.int32 and state.alive.dtype == torch.bool
    for t, arrays in enumerate(_frames64()[RESUME_AT:], start=RESUME_AT):
        state, out = pipe.step(state, Frame.from_arrays(arrays, "cpu"))
        _assert_step_equal(out, outs[t], f"resumed t{t}")
    back = convert.tracker_state_to_numpy(state)
    assert set(back) == set(TrackerState._fields)


def test_golden_benign_first_16_frames():
    """The float32 plain path against the JAX float32 golden the card is
    held to; the stored input digest catches a stale file."""
    golden = np.load(GOLDEN)
    cfg = config.PipelineConfig.demo_16cam()
    kw = json.loads(str(golden["benign/scene"]))
    data = synthetic.pad_detections(
        synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw)), np.float32),
        cfg.fusion.max_dets_per_cam,
    )
    assert synthetic.frames_digest(data) == str(golden["benign/input_sha256"])
    pipe = pipeline.Pipeline(cameras.hall_rig(16, device="cpu"), cfg, device="cpu")
    state = pipe.init_state()
    published = 0
    for f in range(16):
        state, out = pipe.step(state, Frame.from_arrays({k: v[f] for k, v in data.items()}, "cpu"))

        def g(k):
            return golden[f"benign/{k}"][f]

        for name, got in (
            ("raw_valid", out.persons_raw.valid), ("fused_valid", out.fused.valid),
            ("pred_valid", out.fused_pred.valid), ("fb_kp_valid", out.feedback.kp_valid),
            ("n_dropped_hyp", out.n_dropped_hypotheses),
            ("n_dropped_spawns", out.n_dropped_track_spawns),
        ):
            np.testing.assert_array_equal(got.numpy(), g(name), err_msg=f"{name} f{f}")
        fv = g("fused_valid")
        np.testing.assert_array_equal(out.fused.person_id.numpy()[fv], g("fused_id")[fv])
        # A mean of three float32 delays on both sides.
        assert abs(float(out.pred_delta_t) - float(g("pred_delta_t"))) < 1e-6
        on = fv[:, None] & g("fused_joint_on") & ~g("first_published")[:, None]
        # Both sides float32 on the CPU: summation order and the LM's stop
        # inside its 1e-5 error tolerance; measured ~0.003 mm here, so
        # 0.1 mm leaves room without hiding a real fault (1 mm on the card).
        for mine, key in ((out.fused.xyz, "fused_xyz"), (out.fused_pred.xyz, "pred_xyz")):
            np.testing.assert_allclose(mine.numpy()[on], g(key)[on], rtol=0, atol=1e-4)
        published += int(fv.sum())
    assert published > 0


# --------------------------------------------------------------- contracts --

def test_tf32_flags_stay_ieee():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        linalg.require_ieee_fp32()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        a = torch.rand(3, 4, 5)
        linalg.heinsum("bij,bjk->bik", a, a.transpose(1, 2))
        _, tcfg = _config_pair()
        pipe = pipeline.Pipeline(cameras.hall_rig(CAMS, device="cpu"), tcfg, device="cpu")
        pipe.step(pipe.init_state(), Frame.from_arrays(_frames64()[0], "cpu"))
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError):
            linalg.require_ieee_fp32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def test_step_leaves_its_input_state_unchanged():
    _, tcfg = _config_pair()
    pipe = pipeline.Pipeline(cameras.hall_rig(CAMS, device="cpu"), tcfg, device="cpu")
    frames = _frames64()
    state = pipe.init_state()
    for arrays in frames[:3]:
        state, _ = pipe.step(state, Frame.from_arrays(arrays, "cpu"))
    before = [t.clone() for t in state]
    new_state, _ = pipe.step(state, Frame.from_arrays(frames[3], "cpu"))
    for name, a, b in zip(TrackerState._fields, before, state):
        assert torch.equal(a, b), name
    assert not torch.equal(new_state.t_prev_global, state.t_prev_global)


def _stacked(frame_arrays, device="cpu"):
    return Frame(*(
        torch.stack([getattr(Frame.from_arrays(a, device), f) for a in frame_arrays])
        for f in Frame._fields
    ))


def test_chain_and_offline_entry_points():
    _, tcfg = _config_pair()
    pipe = pipeline.Pipeline(cameras.hall_rig(CAMS, device="cpu"), tcfg, device="cpu",
                             fusion_batch=2)
    frames = _frames64()[:3]
    stacked = _stacked(frames)
    end, chain = pipe.run_per_frame_chain(pipe.init_state(), stacked)
    # One StepOutput with a leading time axis, as JAX's lax.scan returns.
    assert isinstance(chain, pipeline.StepOutput)
    outs = [tracker._frame(chain, f) for f in range(len(frames))]
    state = pipe.init_state()
    for arrays, chained in zip(frames, outs):
        state, out = pipe.step(state, Frame.from_arrays(arrays, "cpu"))
        assert torch.equal(out.persons_raw.xyz, chained.persons_raw.xyz)
    assert all(torch.equal(a, b) for a, b in zip(end, state))
    # The offline replay runs (two fusion chunks) and fuses the same persons
    # as the online step: fusion is frame-independent.
    state0 = pipe.init_state()
    before = [t.clone() for t in state0]
    off_end, off = pipe.run_offline(state0, stacked)
    assert off.persons_raw.xyz.shape[0] == len(frames)
    for f, chained in enumerate(outs):
        assert torch.equal(off.persons_raw.valid[f], chained.persons_raw.valid)
        torch.testing.assert_close(off.persons_raw.xyz[f], chained.persons_raw.xyz,
                                   rtol=0, atol=1e-5)
    assert int(off_end.frame_nr) == len(frames)
    for name, a, b in zip(TrackerState._fields, before, state0):
        assert torch.equal(a, b), f"run_offline wrote its input state: {name}"
    with pytest.raises(ValueError, match="fusion_batch"):
        pipeline.Pipeline(cameras.hall_rig(CAMS, device="cpu"), tcfg, device="cpu",
                          fusion_batch=0)


def test_entry_points_default_to_the_card():
    """Every entry point places its tensors on the card unless the caller
    asks for the CPU; without a card (as here) the defaults raise instead
    of running on the CPU."""
    import inspect

    for fn, name in (
        (pipeline.Pipeline.__init__, "device"), (cameras.hall_rig, "device"),
        (cameras.build_rig, "device"), (TrackerState.initial, "device"),
        (convert.rig_from_numpy, "device"), (convert.frame_from_arrays, "device"),
        (convert.tracker_state_from_numpy, "device"), (cameras.load_rig, "device"),
        (checkpoint.load_tracker_state, "device"), (demo.build_demo, "device"),
        (online.default_frame_builder, "device"), (keypoint_cnn.init_detector, "device"),
        (end_to_end.make_end_to_end, "device"), (train.train_detector, "device"),
        (train.make_training_batch, "device"),
    ):
        assert inspect.signature(fn).parameters[name].default == "cuda", fn.__qualname__
    # The CLIs' --device flag defaults to the card too.
    for mod in (demo, profiling):
        assert re.search(r'"--device", default="cuda"', inspect.getsource(mod.main)), mod.__name__
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the defaults run there")
    _, tcfg = _config_pair()
    with pytest.raises((RuntimeError, AssertionError)):
        cameras.hall_rig(CAMS)
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline.Pipeline(cameras.hall_rig(CAMS, device="cpu"), tcfg)
    with pytest.raises((RuntimeError, AssertionError)):
        TrackerState.initial(4)
    with pytest.raises((RuntimeError, AssertionError)):
        demo.build_demo(4, 2, 2, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        keypoint_cnn.init_detector(keypoint_cnn.DetectorConfig(width=8, depth=1))
    # The mesh defaults to every visible card; with none it raises rather
    # than build a mesh of CPU entries, and so does the dry run on it.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.dryrun()


# ---------------------------------------------------------- offline replay --

HALF = FRAMES // 2


@pytest.fixture(scope="module")
def jax_offline():
    """JAX run_offline (float64, fusion_batch=4) over the scene in two
    halves: frames 0..HALF-1 from the initial state, then the rest from the
    JAX TrackerState the first half ended in (one compiled shape). The
    tracker is causal and fusion and smoothing are frame-independent, so
    the two halves are the whole scene's run."""
    jcfg, _ = _config_pair()
    pipe = jax_pipeline.Pipeline(jax_cameras.hall_rig(CAMS, dtype=jnp.float64), jcfg,
                                 fusion_batch=4)
    frames = _frames64()

    def stacked(arrays):
        return JaxFrame.from_arrays({k: np.stack([a[k] for a in arrays]) for k in arrays[0]})

    mid_state, first = jax.device_get(pipe.run_offline(pipe.init_state(dtype=jnp.float64),
                                                       stacked(frames[:HALF])))
    end_state, second = jax.device_get(pipe.run_offline(
        jax.tree_util.tree_map(jnp.asarray, mid_state), stacked(frames[HALF:])
    ))
    return mid_state, (first, second), end_state


def _offline_port(state_fn, frames):
    _, tcfg = _config_pair()
    pipe = pipeline.Pipeline(cameras.hall_rig(CAMS, dtype=torch.float64, device="cpu"), tcfg,
                             device="cpu", fusion_batch=4)
    return pipe.run_offline(state_fn(pipe), _stacked(frames))


def _time_slice(out, lo, hi):
    """Frames lo..hi-1 of a port StepOutput with a leading time axis."""
    if isinstance(out, torch.Tensor):
        return out[lo:hi]
    return type(out)(*(_time_slice(x, lo, hi) for x in out))


def test_run_offline_matches_jax_f64(jax_offline):
    """run_offline on CPU tensors (plain fold, plain tracker scan) over the
    whole scene in one call against JAX run_offline, float64 both, with
    fusion_batch=4 so the 14 frames fuse and smooth in four chunks."""
    _, (first, second), end_state = jax_offline
    state, got = _offline_port(lambda p: p.init_state(dtype=torch.float64), _frames64())
    for (lo, hi), want in (((0, HALF), first), ((HALF, FRAMES), second)):
        part = _time_slice(got, lo, hi)
        _assert_step_equal(part, want, f"offline frames {lo}-{hi}")
        np.testing.assert_allclose(part.pivot_stamp.numpy(), want.pivot_stamp, atol=1e-12)
        np.testing.assert_allclose(part.fb_delay_per_cam.numpy(), want.fb_delay_per_cam,
                                   atol=1e-12)
    _assert_state_equal(state, end_state, "offline final state")
    assert second.fused.valid[-1].sum() == PEOPLE  # the publish gate was crossed


def test_run_offline_resumed_from_jax_state(jax_offline):
    """A JAX TrackerState taken mid-sequence continues identically in the
    port's offline replay through convert.tracker_state_from_numpy."""
    mid_state, (_, want), end_state = jax_offline
    state, got = _offline_port(
        lambda p: convert.tracker_state_from_numpy(mid_state._asdict(), device="cpu"),
        _frames64()[HALF:],
    )
    _assert_step_equal(got, want, "resumed offline")
    _assert_state_equal(state, end_state, "resumed offline final state")
    assert want.fused.valid.sum() > 0


@pytest.mark.parametrize("scene", ["benign", "adversarial"])
def test_offline_golden_tracker_stage(scene):
    """The port's plain tracker scan and reprojection on the offline
    golden's own tracker inputs (the JAX fusion and cold-start LM outputs)
    against the golden's tracker stage, all 64 frames: every decision
    exact, fused joints passed through unchanged, predictions within the
    tolerance test_tracker_pallas holds the TPU kernel to (1e-4 m)."""
    import chip_smoke

    golden = np.load(GOLDEN_OFFLINE)
    cfg = config.PipelineConfig.demo_16cam()
    kw = json.loads(str(golden[f"{scene}/scene"]))
    data = synthetic.pad_detections(
        synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw)), np.float32),
        cfg.fusion.max_dets_per_cam,
    )
    frames = Frame.from_arrays(data, "cpu")
    rig = cameras.hall_rig(16, device="cpu")
    persons, pivots, n_drop, pre = chip_smoke.golden_stage(golden, scene, "cpu")
    _, track = tracker.tracker_scan(TrackerState.initial(cfg.tracker.max_tracks, device="cpu"),
                                    persons, pivots, frames.fb_delay, pre, cfg.prior, cfg.tracker)
    out = pipeline.offline_outputs(frames, persons, pivots, n_drop, track, rig, cfg)
    for f in range(data["kp2d"].shape[0]):
        bad, d_fused, d_pred, dt_err, finite = chip_smoke.step_mismatch(
            chip_smoke.at_frame(out, f), golden, f"{scene}/stage", f
        )
        assert not bad and finite, f"frame {f}: {bad}"
        assert d_fused == 0.0 and d_pred <= 1e-4 and dt_err <= 1e-6, (f, d_fused, d_pred, dt_err)
    assert golden[f"{scene}/stage/fused_valid"].sum() > 0


def test_offline_golden_benign_first_16_frames():
    """The float32 plain run_offline against the JAX float32 offline golden
    (run_offline, fusion_batch=32, whole scene); the tracker is causal and
    fusion and smoothing are frame-independent, so the first 16 frames of
    the golden are those of a 16-frame run."""
    golden = np.load(GOLDEN_OFFLINE)
    cfg = config.PipelineConfig.demo_16cam()
    kw = json.loads(str(golden["benign/scene"]))
    data = synthetic.pad_detections(
        synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw)), np.float32),
        cfg.fusion.max_dets_per_cam,
    )
    assert synthetic.frames_digest(data) == str(golden["benign/input_sha256"])
    pipe = pipeline.Pipeline(cameras.hall_rig(16, device="cpu"), cfg, device="cpu",
                             fusion_batch=8)
    _, out = pipe.run_offline(pipe.init_state(),
                              Frame.from_arrays({k: v[:16] for k, v in data.items()}, "cpu"))

    def g(k):
        return golden[f"benign/{k}"][:16]

    for name, got in (
        ("raw_valid", out.persons_raw.valid), ("fused_valid", out.fused.valid),
        ("pred_valid", out.fused_pred.valid), ("fb_kp_valid", out.feedback.kp_valid),
        ("n_dropped_hyp", out.n_dropped_hypotheses),
        ("n_dropped_spawns", out.n_dropped_track_spawns),
    ):
        np.testing.assert_array_equal(got.numpy(), g(name), err_msg=name)
    fv = g("fused_valid")
    np.testing.assert_array_equal(out.fused.person_id.numpy()[fv], g("fused_id")[fv])
    # A mean of three float32 delays on both sides.
    np.testing.assert_allclose(out.pred_delta_t.numpy(), g("pred_delta_t"), rtol=0, atol=1e-6)
    on = fv[..., None] & g("fused_joint_on") & ~g("first_published")[..., None]
    # Both float32 on the CPU: summation order and the LM's stop inside its
    # 1e-5 error tolerance; 0.1 mm, as for the online golden (1 mm on the card).
    for mine, key in ((out.fused.xyz, "fused_xyz"), (out.fused_pred.xyz, "pred_xyz")):
        np.testing.assert_allclose(mine.numpy()[on], g(key)[on], rtol=0, atol=1e-4)
    assert fv.sum() > 0


def test_convert_rig_and_state_round_trip():
    rig = convert.rig_from_numpy(
        np.tile([420.0, 420.0, 320.0, 240.0], (16, 1)), cameras.hall_extrinsics(16),
        device="cpu",
    )
    want = cameras.hall_rig(16, device="cpu")
    for a, b in zip(rig, want):
        assert torch.equal(a, b)
    state = TrackerState.initial(5, dtype=torch.float64, device="cpu")
    back = convert.tracker_state_from_numpy(convert.tracker_state_to_numpy(state), device="cpu")
    for name, a, b in zip(TrackerState._fields, state, back):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_port_imports_no_jax():
    """The port and chip_smoke.py import torch and numpy, never jax or the
    JAX package (the card's machine has no JAX), and name no path into the
    JAX package's directory (to build or load anything there, such as its
    native runtime): a path string through it, or its bare name quoted as
    a path component. chip_smoke.py may name the TPU kernels' files in its
    report (`replaces`), and nothing else there."""
    pattern = re.compile(r"^\s*(import|from) (jax|smartedgesensor3dhumanpose_tpu)\b")
    jax_dir = re.compile(
        r"smartedgesensor3dhumanpose_tpu[/\\]|[\"']smartedgesensor3dhumanpose_tpu[\"']"
    )
    report_label = 'tpu = "smartedgesensor3dhumanpose_tpu/ops"'
    files = [os.path.join(_REPO, "chip_smoke.py")]
    pkg = os.path.join(_REPO, "smartedgesensor3dhumanpose_tpu_torch")
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    for path in files:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                assert not pattern.match(line), f"{path}:{i}: {line.strip()}"
                if path.endswith("chip_smoke.py") and line.strip() == report_label:
                    continue
                assert not jax_dir.search(line), f"{path}:{i}: {line.strip()}"
    # The pattern catches the ways a path into the package is spelt.
    for spelt in ('os.path.join(root, "smartedgesensor3dhumanpose_tpu", "native")',
                  "Path('smartedgesensor3dhumanpose_tpu') / 'native'",
                  '"../smartedgesensor3dhumanpose_tpu/native/libses3d_runtime.so"'):
        assert jax_dir.search(spelt), spelt
    assert not jax_dir.search("smartedgesensor3dhumanpose_tpu_torch/native/runtime.cpp")
