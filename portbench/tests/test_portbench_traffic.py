"""The traffic: the frozen scene generator against the port's, the live
schedule and the messages it yields, and the reference's synchronizer and
packing against the port's live path, at a tiny size."""

import time

import numpy as np
import torch

from portbench.drivers import live
from portbench.lib import scene
from portbench.reference import replay as ref_replay
from portbench.reference import sync as ref_sync
from portbench.tests import tiny
from portbench.traffic import synthetic
from smartedgesensor3dhumanpose_tpu_torch import cameras
from smartedgesensor3dhumanpose_tpu_torch.io import replay as port_replay
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic as port_synthetic


def test_generator_is_the_ports_draw_for_draw():
    cfg = dict(num_cameras=4, num_people=2, num_frames=6, seed=2**31 + 11)
    ours = synthetic.generate_scene(synthetic.SceneConfig(**cfg))
    theirs = port_synthetic.generate_scene(port_synthetic.SceneConfig(**cfg))
    for k in ("gt_xyz", "kp2d", "cov2d", "det_valid", "det_score", "cam_stamp", "fb_delay"):
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_rig_is_the_ports_hall():
    for n in (4, 16, 64):
        ours = scene.rig_arrays({"rig": {"cameras": n}})
        theirs = cameras.hall_rig(n, device="cpu")
        for a, b in zip(ours, theirs):
            assert torch.equal(a, b)


def test_same_seed_same_scene_other_seed_other():
    cell = tiny.cell("live")
    a = scene.scene(cell.config, cell.mix, 5, 123456789012)
    b = scene.scene(cell.config, cell.mix, 5, 123456789012)
    c = scene.scene(cell.config, cell.mix, 5, 123456789013)
    assert all(np.array_equal(a[k], b[k]) for k in ("kp2d", "cam_stamp"))
    assert not np.array_equal(a["kp2d"], c["kp2d"])
    assert a["kp2d"].shape == (5, tiny.CAMERAS, 8, 17, 3) and a["det_count"] == tiny.PEOPLE


def test_schedule_order_due_times_and_messages():
    cell = tiny.cell("live")
    data = scene.scene(cell.config, cell.mix, 6, 5)
    sched = live.Schedule(data, 2, 5, lead_s=0.01)
    assert len(sched) == 3 * tiny.CAMERAS
    assert np.all(np.diff(sched.stamp) >= 0)
    t0 = sched.start()
    np.testing.assert_allclose(sched.due - t0, sched.stamp - sched.stamp[0])
    msgs = list(sched)
    assert time.perf_counter() >= sched.due[-1]
    assert np.all(sched.late >= 0)
    for i, (cam, stamp, fb, (kp, cov, score)) in enumerate(msgs):
        f = sched.frame[i]
        assert 2 <= f < 5 and cam == sched.camera[i]
        assert stamp == data["cam_stamp"][f, cam]
        assert fb == np.float32(data["fb_delay"][f, cam])
        np.testing.assert_array_equal(kp, data["kp2d"][f, cam, :tiny.PEOPLE])
        np.testing.assert_array_equal(score, data["det_score"][f, cam, :tiny.PEOPLE])


def test_reference_sync_and_packing_match_the_ports_native_replay():
    cell = tiny.cell("live")
    data = scene.scene(cell.config, cell.mix, 8, 9)
    sched = live.Schedule(data, 0, 8, lead_s=0.0)
    sched.start()
    port = port_replay.SynchronizedReplay(tiny.CAMERAS, 8)
    ours = ref_sync.synchronizer(tiny.CAMERAS)
    port_sets, our_sets = [], []
    for i, (cam, stamp, fb, persons) in enumerate(sched):
        assert port.push(cam, stamp, fb, persons) == i + 1
        port_sets += list(port.pop_frames())
        ours.push(cam, int(round(stamp * 1e9)), i + 1)
        while (got := ours.pop()) is not None:
            our_sets.append(got)
    assert len(port_sets) == len(our_sets) >= 6
    for fd, (stamps, handles) in zip(port_sets, our_sets):
        assert list(fd["handles"]) == list(handles)
        payloads = [sched.payload(h - 1) for h in handles]
        packed = ref_replay.pack_set(payloads, stamps, 8)
        for k in ("kp2d", "cov2d", "det_score", "det_valid", "cam_stamp", "fb_delay"):
            np.testing.assert_array_equal(packed[k], fd[k])
