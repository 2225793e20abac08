"""The port's demo CLI, stage profiler, evaluation, monitoring, timing,
sigma statistics and calibration files against the JAX package.

The demo runs on CPU tensors (`--device cpu`, the kernels' plain versions)
at a small size; the JAX demo runs once for the module on the same
arguments (JAX on the CPU as conftest sets it up). Arrays for the
framework-free modules are made with numpy from a seed and fed to both.
"""

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import demo as jax_demo
from smartedgesensor3dhumanpose_tpu import metrics as jax_metrics
from smartedgesensor3dhumanpose_tpu import monitor as jax_monitor
from smartedgesensor3dhumanpose_tpu import timing as jax_timing
from smartedgesensor3dhumanpose_tpu import viz as jax_viz
from smartedgesensor3dhumanpose_tpu_torch import (
    cameras,
    demo,
    metrics,
    monitor,
    profiling,
    timing,
    viz,
)
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.types import Frame

pytestmark = pytest.mark.torch_port

CAMS, PEOPLE, FRAMES = 6, 2, 12
SMALL = ["--cameras", str(CAMS), "--people", str(PEOPLE), "--frames", str(FRAMES)]
# Fused joints of the port's float32 demo against JAX's float32 demo: the
# parity budget of the JAX parity harness (parity.py), 1 mm.
JOINT_TOL_M = 1.0e-3


@pytest.fixture(scope="module")
def jax_demo_run(tmp_path_factory):
    """The JAX demo's offline replay on SMALL: its saved outputs and its
    recording."""
    d = tmp_path_factory.mktemp("jax_demo")
    out, rec = str(d / "out.npz"), str(d / "rec.jsonl")
    jax_demo.main(SMALL + ["--save", out, "--eval", "--record-jsonl", rec])
    with np.load(out) as z:
        return {k: z[k] for k in z.files}, rec


@pytest.fixture(scope="module")
def port_demo_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_demo")
    paths = {k: str(d / name) for k, name in (
        ("save", "out.npz"), ("rec", "rec.jsonl"), ("ckpt", "state.npz"),
        ("viz", "dash.png"), ("save_jsonl", "replayed.npz"))}
    run = demo.main(SMALL + [
        "--device", "cpu", "--save", paths["save"], "--eval", "--vis-cov",
        "--record-jsonl", paths["rec"], "--checkpoint", paths["ckpt"], "--viz", paths["viz"],
    ])
    return run, paths


def test_demo_offline_matches_jax(jax_demo_run, port_demo_run):
    """`--device cpu --save --eval`: the saved ids and publish masks equal
    the JAX demo's on the same arguments, joints within 1 mm."""
    want, _ = jax_demo_run
    run, paths = port_demo_run
    with np.load(paths["save"]) as z:
        got = {k: z[k] for k in z.files}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["person_id"], want["person_id"])
    np.testing.assert_array_equal(got["fused_valid"], want["fused_valid"])
    on = want["fused_valid"][..., None] & (want["fused_score"] > 0)
    np.testing.assert_array_equal(got["fused_score"] > 0, want["fused_score"] > 0)
    assert on.sum() > 0
    np.testing.assert_allclose(got["fused_xyz"][on], want["fused_xyz"][on], rtol=0,
                               atol=JOINT_TOL_M)
    assert want["fused_valid"][-1].sum() == PEOPLE
    assert run.seconds > 0 and run.mpjpe_m < 0.05 and run.pck_015 == 1.0
    assert os.path.getsize(paths["viz"]) > 0
    assert run.final_state.next_id.device.type == "cpu"


def test_demo_recording_equals_jax(jax_demo_run, port_demo_run):
    _, rec = jax_demo_run
    _, paths = port_demo_run
    with open(rec, "rb") as a, open(paths["rec"], "rb") as b:
        assert a.read() == b.read()


def test_demo_jsonl_replay(port_demo_run, capsys):
    """`--jsonl` replays the recording through the native synchronizer; a
    missing recording is an argparse error."""
    _, paths = port_demo_run
    run = demo.main(SMALL + ["--device", "cpu", "--jsonl", paths["rec"],
                             "--save", paths["save_jsonl"]])
    printed = capsys.readouterr().out
    assert "replayed" in printed and "fused frames/s" in printed
    with np.load(paths["save_jsonl"]) as z:
        n = z["fused_xyz"].shape[0]
        assert FRAMES - 3 <= n <= FRAMES and z["fused_valid"][-1].sum() == PEOPLE
    assert run.frames.kp2d.shape[0] == n
    with pytest.raises(SystemExit):
        demo.main(["--device", "cpu", "--jsonl", paths["rec"] + ".missing"])


def test_demo_online_modes(port_demo_run, capsys):
    """`--online`, `--online --jsonl` and `--closed-loop` run their loops and
    keep their accounting."""
    _, paths = port_demo_run
    run = demo.main(SMALL + ["--device", "cpu", "--online", "--feed-hz", "60"])
    r = run.report
    assert r.dropped + len(r.processed_handles) == r.produced == FRAMES
    assert r.processed_handles[-1] == FRAMES - 1
    run = demo.main(SMALL + ["--device", "cpu", "--online", "--jsonl", paths["rec"],
                             "--feed-hz", "60"])
    r = run.report
    assert r.processed_frames + r.slot_dropped == r.frames_synced > 0
    assert r.produced_messages == FRAMES * CAMS
    run = demo.main(SMALL + ["--device", "cpu", "--closed-loop"])
    r = run.report
    assert r.n_feedback_received == FRAMES and r.fb_delay_measured[0, 0] == -1.0
    assert (r.fb_delay_measured[-1] >= 0.08 - 1e-9).all()
    printed = capsys.readouterr().out
    assert "online:" in printed and "online+sync:" in printed and "closed loop:" in printed


def test_live_dashboard_renders(tmp_path):
    """`--live` writes the scrubbable HTML dashboard of the offline replay
    (tensor outputs read on the host)."""
    path = str(tmp_path / "live.html")
    demo.main(["--cameras", "4", "--people", "1", "--frames", "3", "--device", "cpu",
               "--live", path])
    with open(path) as fh:
        assert "<img" in fh.read()


def test_viz_without_matplotlib_names_it(monkeypatch, tmp_path):
    """Where matplotlib is missing (the card's machine), --viz fails with an
    ImportError that names it, before anything runs."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.require_matplotlib()
    with pytest.raises(ImportError, match="matplotlib"):
        demo.main(SMALL + ["--device", "cpu", "--viz", str(tmp_path / "x.png")])


def test_profile_stages_returns_every_stage():
    scene = synthetic.generate_scene(synthetic.SceneConfig(
        num_cameras=4, num_people=2, num_frames=4, seed=5))
    frames = Frame.from_arrays(synthetic.frames_from_scene(scene), "cpu")
    from smartedgesensor3dhumanpose_tpu_torch import config, pipeline

    cfg = config.PipelineConfig(
        fusion=config.FusionConfig(num_cameras=4, max_dets_per_cam=2, max_hypotheses=6),
        tracker=config.TrackerConfig(max_tracks=6),
    )
    pipe = pipeline.Pipeline(cameras.hall_rig(4, device="cpu"), cfg, device="cpu",
                             fusion_batch=2)
    stages = profiling.profile_stages(pipe, frames, reps=1)
    assert set(stages) == {"fuse", "smooth_cold", "tracker", "reproj", "full"}
    assert all(v > 0.0 for v in stages.values())


# -------------------------------------------------- framework-free modules --

def _eval_arrays(rng):
    t, p, k, g = 6, 4, 21, 3
    xyz = rng.normal(size=(t, p, k, 3))
    gt = xyz[:, :g, :17] + rng.normal(scale=0.05, size=(t, g, 17, 3))
    score = (rng.uniform(size=(t, p, k)) > 0.2).astype(np.float64)
    valid = rng.uniform(size=(t, p)) > 0.2
    gt_valid = rng.uniform(size=(t, g)) > 0.1
    return xyz, score, valid, gt, gt_valid


def test_metrics_equal_jax(rng):
    xyz, score, valid, gt, gt_valid = _eval_arrays(rng)
    sel = np.arange(17)
    for kw in (dict(), dict(gt_valid=gt_valid, start=2), dict(max_match_dist=0.1)):
        want = jax_metrics.evaluate_sequence(xyz, score, valid, gt, to_fusion=sel, **kw)
        got = metrics.evaluate_sequence(torch.from_numpy(xyz), torch.from_numpy(score),
                                        torch.from_numpy(valid), gt, to_fusion=sel, **kw)
        np.testing.assert_array_equal(got.joint_errors, want.joint_errors)
        assert (got.n_gt, got.n_matched) == (want.n_gt, want.n_matched)
        np.testing.assert_equal(got.coverage, want.coverage)
        np.testing.assert_equal(got.miss_rate, want.miss_rate)
        e = want.joint_errors
        assert metrics.mpjpe(e) == jax_metrics.mpjpe(e)
        assert metrics.pck(e, 0.15) == jax_metrics.pck(e, 0.15)
    got = metrics.frame_matches(xyz[0, :, :17], score[0, :, :17], valid[0], gt[0])
    want = jax_metrics.frame_matches(xyz[0, :, :17], score[0, :, :17], valid[0], gt[0])
    assert [(m.gt_index, m.pred_index, m.coverage) for m in got] == \
        [(m.gt_index, m.pred_index, m.coverage) for m in want]


def _outputs(valid, ids, n_hyp, n_trk, as_tensor):
    f = torch.as_tensor if as_tensor else np.asarray
    return types.SimpleNamespace(
        fused=types.SimpleNamespace(valid=f(valid), person_id=f(ids)),
        n_dropped_hypotheses=f(n_hyp), n_dropped_track_spawns=f(n_trk),
    )


def test_monitor_events_equal_jax():
    stamps = np.array([[0.0, 0.01, 0.0], [0.033, 0.034, 0.2], [0.02, 0.02, 0.02],
                       [0.4, 0.39, 0.31], [0.43, 0.43, 0.43]])
    outs = [([True, False, True], [3, -1, 5], 0, 0), ([True, True, True], [3, 7, 5], 2, 0),
            ([False, True, True], [-1, 7, 9], 0, 1)]
    logs = []
    for mod, as_tensor in ((jax_monitor, False), (monitor, True)):
        m = mod.PipelineMonitor(emit_log=False)
        verdicts = [m.check_frame(torch.as_tensor(s) if as_tensor else s) for s in stamps]
        for o in outs:
            m.check_output(_outputs(*o, as_tensor=as_tensor))
        logs.append((verdicts, [(e.kind, e.message, e.data) for e in m.events], m.summary()))
    assert logs[0] == logs[1]
    assert logs[0][0] == [True, True, False, True, True]


def test_timing_buckets_equal_jax():
    reports = []
    for mod in (jax_timing, timing):
        b = mod.TimingBuckets("Pipeline", max_buckets=5)
        for sec, n in ((0.010, 1), (0.020, 2), (0.030, 2), (0.005, 0), (0.5, 7)):
            b.add(sec, n)
        fixed = (b.report(), b.as_dict())
        with mod.StageTimer(b, 3):  # a measured lap: only its count is fixed
            pass
        reports.append(fixed + (b.counts, sorted(b.as_dict())))
    assert reports[0] == reports[1]
    assert reports[0][2] == [6, 1, 2, 1, 0]


def test_sigma_stats_equal_jax(rng):
    stats = [jax_viz.SigmaStats(), viz.SigmaStats()]
    for _ in range(5):
        a = rng.normal(size=(4, 21, 3, 3))
        cov = a @ np.swapaxes(a, -1, -2) * 1e-4
        score = (rng.uniform(size=(4, 21)) > 0.3).astype(np.float64)
        stats[0].update(cov, score)
        stats[1].update(torch.from_numpy(cov), torch.from_numpy(score))
    np.testing.assert_array_equal(stats[1].min_eig, stats[0].min_eig)
    np.testing.assert_array_equal(stats[1].max_eig, stats[0].max_eig)
    assert stats[1].report() == stats[0].report()
    assert viz.SigmaStats().report() == jax_viz.SigmaStats().report()


def test_rig_files_cross_packages(tmp_path):
    """A rig file written by either package loads in the other (F
    recomputed in float64), and both write the same bytes."""
    P, K = cameras.hall_extrinsics(CAMS), np.tile([420.0, 420.0, 320.0, 240.0], (CAMS, 1))
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    cameras.save_rig(cameras.build_rig(P, K, dtype=torch.float64, device="cpu"), mine, P=P, K=K)
    jax_cameras.save_rig(jax_cameras.build_rig(P, K, dtype=jnp.float64), theirs, P=P, K=K)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got = cameras.load_rig(theirs, dtype=torch.float64, device="cpu")
    want = jax_cameras.load_rig(mine, dtype=jnp.float64)
    for name in ("K", "P", "F", "image_size"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.P.numpy(), P)
    quantized = str(tmp_path / "f32.json")
    cameras.save_rig(cameras.build_rig(P, K, device="cpu"), quantized)
    back = jax_cameras.load_rig(quantized)
    np.testing.assert_array_equal(np.asarray(back.P), P.astype(np.float32))
    assert cameras.load_rig(quantized, device="cpu").F.dtype == torch.float32
