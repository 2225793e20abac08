"""The port's camera-scan association (ops/association.py::associate_scan)
and the routes a Pipeline takes by shape, against the JAX package.

The scan is the port of JAX's fusion._associate_camera and the scan branch
of its associate, the route JAX takes for "cond_while", "pallas" and
"unrolled", for "auto" off the TPU and beyond its fold kernel's domain. It
is held to JAX's associate(assignment_impl="cond_while") on frames of the
two golden demo scenes, on a random frame with 128 hypothesis slots
(past the JV kernel's warp width) and on a frame of the 480-camera dome
(the route its configuration takes: K2's fold does not fit), with ghosts
and 4 hypothesis slots, in float64 and float32: which detection
each hypothesis observes per camera and the live and dropped counts are
integers and must be exactly equal (the gathered observation data agree to
the ulp). Then the configurations that only the new routes run, against
JAX's Pipeline in float64: the online step with 128 track slots and the
offline replay with fewer track slots than hypotheses.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import config as jax_config
from smartedgesensor3dhumanpose_tpu import fusion as jax_fusion
from smartedgesensor3dhumanpose_tpu import pipeline as jax_pipeline
from smartedgesensor3dhumanpose_tpu.types import Frame as JaxFrame
from smartedgesensor3dhumanpose_tpu_torch import cameras, config, fusion, pipeline
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import association, tracker
from smartedgesensor3dhumanpose_tpu_torch.types import Frame

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_golden_demo16.npz")
GOLDEN_FRAMES = (8, 40, 52, 61)
IMPLS = ("auto", "cond_while", "pallas_scan", "pallas", "unrolled")


def _golden_frames(scene):
    kw = json.loads(str(np.load(GOLDEN)[f"{scene}/scene"]))
    data = synthetic.pad_detections(
        synthetic.frames_from_scene(synthetic.generate_scene(synthetic.SceneConfig(**kw))),
        config.FusionConfig().max_dets_per_cam,
    )
    return [{k: v[t] for k, v in data.items()} for t in GOLDEN_FRAMES]


def _random_frame():
    """One frame of 6 cameras with ghosts, for 128 hypothesis slots."""
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=6, num_people=5, num_frames=1, seed=3, pixel_noise=2.0,
        keypoint_dropout=0.08, detection_dropout=0.05, num_ghost_slots=2, ghost_rate=0.6,
    ))
    data = synthetic.frames_from_scene(scene)
    return [{k: v[0] for k, v in data.items()}]


def _dome_frame():
    """One frame of the 480-camera hall, 2 persons and a ghost slot."""
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=480, num_people=2, num_frames=1, seed=11, num_ghost_slots=1,
        ghost_rate=0.5, identity_swap_rate=0.2,
    ))
    data = synthetic.frames_from_scene(scene)
    return [{k: v[0] for k, v in data.items()}]


def _jax_associate(jcfg, jrig):
    @jax.jit
    def run(kp2d, cov2d, det_score, det_valid):
        kp_n, cov_n, kp_ok = jax_cameras.normalize_keypoints(
            kp2d, cov2d, jrig.K, jcfg.min_kp_score
        )
        det_ok = det_valid & (jnp.sum(kp_ok, axis=-1) > jcfg.num_input_joints // 2)
        return jax_fusion.associate(kp_n, cov_n, det_score, det_ok, jrig, jcfg)

    return run


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["benign", "adversarial", "random128", "dome480"])
def test_scan_matches_jax_cond_while(case, dtype):
    frames = {"random128": _random_frame, "dome480": _dome_frame}.get(
        case, lambda: _golden_frames(case))()
    cams, d = frames[0]["kp2d"].shape[:2]
    h = {"random128": 128, "dome480": 4}.get(case, 16)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    kw = dict(num_cameras=cams, max_dets_per_cam=d, max_hypotheses=h,
              max_epipolar_error=0.045, assignment_impl="cond_while")
    jrig = jax_cameras.hall_rig(cams, dtype=jdt)
    trig = cameras.hall_rig(cams, dtype=tdt, device="cpu")
    tcfg = config.FusionConfig(**kw)
    assert fusion.association_route(tcfg, cams, d) == "scan"
    run = _jax_associate(jax_config.FusionConfig(**kw), jrig)
    spawns = 0
    for t, arrays in enumerate(frames):
        arrays = dict(arrays)
        for k in ("kp2d", "cov2d", "det_score"):
            arrays[k] = arrays[k].astype(dtype)
        want = jax.device_get(run(arrays["kp2d"], arrays["cov2d"], arrays["det_score"],
                                  arrays["det_valid"]))
        frame = Frame.from_arrays(arrays, "cpu")
        kp_n, cov_n, det_ok = fusion.normalize_frame(frame, trig, tcfg)
        got = fusion.associate(kp_n, cov_n, frame.det_score, det_ok, trig, tcfg)
        msg = f"{case} {dtype.__name__} t{t}"
        np.testing.assert_array_equal(got.cam_mask.numpy(), want.cam_mask, err_msg=msg)
        np.testing.assert_array_equal(got.obs_score.numpy(), want.obs_score, err_msg=msg)
        # The same detections normalized by two compilers: one ulp apart.
        ulp = np.finfo(dtype).eps
        np.testing.assert_allclose(got.kp.numpy(), want.kp, rtol=2 * ulp, atol=0, err_msg=msg)
        assert int(got.n_hyp) == int(want.n_hyp), msg
        assert int(got.n_dropped) == int(want.n_dropped), msg
        spawns += int(got.n_hyp)
    assert spawns > 0


def _single_person_frame():
    """One frame of 6 cameras seeing one person, no ghosts: no camera has a
    detection or hypothesis with two feasible pairings, so no step needs a
    solve."""
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=6, num_people=1, num_frames=1, seed=4, keypoint_dropout=0.0,
        detection_dropout=0.0,
    ))
    data = synthetic.pad_detections(synthetic.frames_from_scene(scene),
                                    config.FusionConfig().max_dets_per_cam)
    return {k: v[0] for k, v in data.items()}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["random128", "no_need"])
def test_scan_camera_matches_jax_associate_camera(monkeypatch, case, dtype):
    """Each camera step of the port's scan (_scan_camera, whose discarded
    solves turn all their rows off) against the JAX package's
    _associate_camera on the same fold inputs, camera by camera with 128
    hypothesis slots: det_slot, n_hyp and n_dropped exactly equal. On the
    random frame some steps need the solve (every row on) and the rest turn
    all rows off; on the one-person frame no step needs it."""
    arrays = _random_frame()[0] if case == "random128" else _single_person_frame()
    cams, d = arrays["kp2d"].shape[:2]
    h = 128
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    kw = dict(num_cameras=cams, max_dets_per_cam=d, max_hypotheses=h,
              max_epipolar_error=0.045, assignment_impl="cond_while")
    tcfg = config.FusionConfig(**kw)
    jcfg = jax_config.FusionConfig(**kw)
    rig = cameras.hall_rig(cams, dtype=tdt, device="cpu")
    arrays = {k: v.astype(dtype) if k in ("kp2d", "cov2d", "det_score") else v
              for k, v in arrays.items()}
    frame = Frame.from_arrays(arrays, "cpu")
    kp_n, _, det_ok = fusion.normalize_frame(frame, rig, tcfg)
    ctab, conf = fusion.fold_inputs(kp_n, frame.det_score, rig, tcfg)

    masks = []
    solve = association.hungarian.linear_sum_assignment_batched

    def recorded(cost, row_active=None):
        masks.append(row_active.clone())
        return solve(cost, row_active)

    monkeypatch.setattr(association.hungarian, "linear_sum_assignment_batched", recorded)
    step = jax.jit(lambda carry, ci, ctab_c, conf_obs, dok: jax_fusion._associate_camera(
        carry, ci, ctab_c, conf_obs, dok, jcfg))
    carry = jax_fusion._AssocCarry(
        det_slot=jnp.full((h, cams), -1, jnp.int32), cam_mask=jnp.zeros((h, cams), bool),
        n_hyp=jnp.zeros((), jnp.int32), n_dropped=jnp.zeros((), jnp.int32))
    det_slot = torch.full((1, h, cams), -1, dtype=torch.int64)
    n_hyp = torch.zeros(1, dtype=torch.int64)
    n_dropped = torch.zeros(1, dtype=torch.int64)
    for c in range(cams):
        det_slot, n_hyp, n_dropped = association._scan_camera(
            det_slot, n_hyp, n_dropped, ctab[None, c], conf[None], det_ok[None, c], c,
            tcfg.max_epipolar_error, tcfg.max_cost)
        carry = step(carry, jnp.int32(c), ctab[c].numpy(), conf.numpy(), det_ok[c].numpy())
        msg = f"{case} {dtype.__name__} camera {c}"
        np.testing.assert_array_equal(det_slot[0].numpy(), np.asarray(carry.det_slot), err_msg=msg)
        assert int(n_hyp[0]) == int(carry.n_hyp), msg
        assert int(n_dropped[0]) == int(carry.n_dropped), msg
    # Each step's mask is all on or all off; which of them needed a solve.
    assert len(masks) == cams and all(m.shape == (1, h) for m in masks)
    need = [bool(m.all()) for m in masks]
    assert all(bool(m.all()) or not bool(m.any()) for m in masks)
    if case == "random128":
        assert any(need) and not all(need)
    else:
        assert not any(need)
    assert int(n_hyp[0]) > 0


@pytest.mark.parametrize("scene", ["benign", "adversarial"])
def test_scan_equals_fold_on_the_demo(scene):
    """The two routes give the same association on the golden demo frames
    (float32, the card's dtype): det_slot, n_hyp and n_dropped."""
    rig = cameras.hall_rig(16, device="cpu")
    base = config.PipelineConfig.demo_16cam().fusion
    for arrays in _golden_frames(scene):
        frame = Frame.from_arrays(arrays, "cpu")
        kp_n, _, det_ok = fusion.normalize_frame(frame, rig, base)
        ctab, conf = fusion.fold_inputs(kp_n, frame.det_score, rig, base)
        args = (ctab[None], conf[None], det_ok[None], base.max_hypotheses,
                base.max_epipolar_error, base.max_cost)
        fold = association.associate_fold_batched(*args)
        scan = association.associate_scan(*args)
        for a, b in zip(fold, scan):
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b)


ROUTES = {
    # config -> (association route per name in IMPLS, offline tracker on CUDA)
    "demo": (config.PipelineConfig.demo_16cam(),
             ("fold", "scan", "fold", "scan", "scan"), "kernel"),
    "h_cap128": (dataclasses.replace(config.PipelineConfig.demo_16cam(), fusion=dataclasses.replace(
        config.PipelineConfig.demo_16cam().fusion, max_hypotheses=128)),
        ("scan", "scan", None, "scan", "scan"), "steps"),
    "p_gt_t": (config.PipelineConfig.demo_16cam(tracker=config.TrackerConfig(max_tracks=12)),
               ("fold", "scan", "fold", "scan", "scan"), "steps"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_routes_by_shape(name):
    """The route of each assignment_impl name, and the offline tracker's,
    from the config and device alone; "pallas_scan" outside K2's domain is
    refused when the Pipeline is built, not in its first call."""
    cfg, expected, tracker_route = ROUTES[name]
    f = cfg.fusion
    rig = cameras.hall_rig(f.num_cameras, device="cpu")
    for impl, want in zip(IMPLS, expected):
        c = dataclasses.replace(cfg, fusion=dataclasses.replace(f, assignment_impl=impl))
        if want is None:
            with pytest.raises(ValueError, match="pallas_scan"):
                pipeline.Pipeline(rig, c, device="cpu")
            with pytest.raises(ValueError, match="120"):
                fusion.association_route(c.fusion, f.num_cameras, f.max_dets_per_cam)
            continue
        assert fusion.association_route(c.fusion, f.num_cameras, f.max_dets_per_cam) == want
        assert pipeline.Pipeline(rig, c, device="cpu").routes == (want, "plain")
        assert pipeline.routes(c, torch.device("cuda")) == (want, tracker_route)
    assert tracker.kernel_takes(f.max_hypotheses, cfg.tracker.max_tracks, 21) == (
        tracker_route == "kernel")


def test_widths_past_the_kernel_are_refused_at_construction():
    """On the card a JV wider than kernel K1 takes is refused when the
    Pipeline is built, naming the limit (the plain version on the CPU has
    none, as JAX's XLA JV has none)."""
    cfg = config.PipelineConfig(tracker=config.TrackerConfig(max_tracks=9000))
    with pytest.raises(ValueError, match="8192"):
        pipeline.routes(cfg, torch.device("cuda"))
    assert pipeline.routes(cfg, torch.device("cpu")) == ("fold", "plain")


CAMS, PEOPLE, FRAMES, SEED = 6, 4, 8, 5


def _small_frames():
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=CAMS, num_people=PEOPLE, num_frames=FRAMES, seed=SEED,
        num_ghost_slots=1, ghost_rate=0.4,
    ))
    data = synthetic.frames_from_scene(scene, np.float64)
    return {k: v for k, v in data.items()}


def _pair(max_hypotheses, max_tracks):
    kw_f = dict(num_cameras=CAMS, max_dets_per_cam=PEOPLE + 1, max_hypotheses=max_hypotheses)
    kw_t = dict(max_tracks=max_tracks)
    return (
        jax_config.PipelineConfig(fusion=jax_config.FusionConfig(**kw_f),
                                  tracker=jax_config.TrackerConfig(**kw_t)),
        config.PipelineConfig(fusion=config.FusionConfig(**kw_f),
                              tracker=config.TrackerConfig(**kw_t)),
    )


def _assert_outputs_equal(got, want, msg):
    """Decisions exact, joints within 1e-6 m (float64 on both sides)."""
    for name in ("persons_raw", "fused", "fused_pred"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g.valid.numpy(), w.valid, err_msg=f"{msg} {name}")
        np.testing.assert_array_equal(g.person_id.numpy(), w.person_id, err_msg=f"{msg} {name}")
        np.testing.assert_array_equal(g.score.numpy() > 0, w.score > 0, err_msg=f"{msg} {name}")
        np.testing.assert_allclose(g.xyz.numpy(), w.xyz, rtol=0, atol=1e-6, err_msg=msg)
    for name in ("n_dropped_hypotheses", "n_dropped_track_spawns"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=f"{msg} {name}")


def test_step_with_128_track_slots_matches_jax():
    """Pipeline.step with max_tracks=128: each frame's track assignment is
    16 x 128, past the warp kernel (the wide routine on the card)."""
    jcfg, tcfg = _pair(2 * PEOPLE, 128)
    data = _small_frames()
    jpipe = jax_pipeline.Pipeline(jax_cameras.hall_rig(CAMS, dtype=jnp.float64), jcfg)
    tpipe = pipeline.Pipeline(cameras.hall_rig(CAMS, dtype=torch.float64, device="cpu"), tcfg,
                              device="cpu")
    jstate, tstate = jpipe.init_state(dtype=jnp.float64), tpipe.init_state(dtype=torch.float64)
    for t in range(FRAMES):
        arrays = {k: v[t] for k, v in data.items()}
        jstate, want = jpipe.step(jstate, JaxFrame.from_arrays(arrays))
        tstate, got = tpipe.step(tstate, Frame.from_arrays(arrays, "cpu"))
        _assert_outputs_equal(got, jax.device_get(want), f"t{t}")
    np.testing.assert_array_equal(tstate.track_id.numpy(), np.asarray(jstate.track_id))


def test_run_offline_with_fewer_track_slots_than_hypotheses_matches_jax():
    """run_offline with max_tracks=12 under 16 hypothesis slots: JAX's
    lax.scan of tracking.step (its tracker kernel needs P <= T), the port's
    per-frame loop (kernel K1 per frame on the card)."""
    jcfg, tcfg = _pair(16, 12)
    data = _small_frames()
    jpipe = jax_pipeline.Pipeline(jax_cameras.hall_rig(CAMS, dtype=jnp.float64), jcfg,
                                  fusion_batch=4)
    tpipe = pipeline.Pipeline(cameras.hall_rig(CAMS, dtype=torch.float64, device="cpu"), tcfg,
                              device="cpu", fusion_batch=4)
    assert pipeline.routes(tcfg, torch.device("cuda")).tracker == "steps"
    jstate, want = jpipe.run_offline(jpipe.init_state(dtype=jnp.float64),
                                     JaxFrame.from_arrays(data))
    tstate, got = tpipe.run_offline(tpipe.init_state(dtype=torch.float64),
                                    Frame.from_arrays(data, "cpu"))
    _assert_outputs_equal(got, jax.device_get(want), "offline")
    np.testing.assert_array_equal(tstate.track_id.numpy(), np.asarray(jstate.track_id))
    assert int(got.fused.valid.sum()) > 0 or int(got.persons_raw.valid.sum()) > 0
