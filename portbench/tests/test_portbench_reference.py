"""The plain reference against the port's CPU run on a tiny scene: the
reference is a frozen copy of the port's plain path, so in float32 the
two agree bit for bit; in float64 (how the reference judges) within
float32's rounding."""

import dataclasses

import pytest
import torch

from portbench.lib import scene
from portbench.reference import pipeline as ref_pipeline
from portbench.reference import types as ref_types
from portbench.tests import tiny
from smartedgesensor3dhumanpose_tpu_torch import config, pipeline
from smartedgesensor3dhumanpose_tpu_torch.types import CameraRig, Frame


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    cell = tiny.cell("offline")
    data = scene.scene(cell.config, cell.mix, 14, 4242)
    rig = scene.rig_arrays(cell.config)
    return cell, data, rig


def leaves(tree):
    return torch.utils._pytree.tree_leaves(tuple(tree))


def test_step_and_offline_equal_the_ports_in_float32(setup):
    cell, data, rig = setup
    cfg = scene.make_config(config, cell.config)
    pipe = pipeline.Pipeline(CameraRig(*rig), cfg, device="cpu", fusion_batch=4)
    rcfg = scene.ref_pipeline_config(cell.config)
    rrig = ref_types.CameraRig(*rig)
    frames = Frame.from_arrays(data, "cpu")
    state, rstate = pipe.init_state(), ref_types.TrackerState(*pipe.init_state())
    for i in range(12):
        frame = Frame(*(x[i] for x in frames))
        state, out = pipe.step(state, frame)
        rstate, rout = ref_pipeline.step(rstate, ref_types.Frame(*frame), rrig, rcfg)
        assert all(torch.equal(a, b) for a, b in zip(leaves(out), leaves(rout)))
        assert all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(rstate)))
    assert bool(out.fused.valid.any())
    _, out = pipe.run_offline(pipe.init_state(), frames)
    _, rout = ref_pipeline.run_offline(ref_types.TrackerState(*pipe.init_state()),
                                       ref_types.Frame(*frames), rrig, rcfg, 4)
    assert all(torch.equal(a, b) for a, b in zip(leaves(out), leaves(rout)))


def test_float64_reference_agrees_on_decisions(setup):
    from portbench.lib import judge
    from portbench.reference import replay

    cell, data, rig = setup
    cfg = scene.make_config(config, cell.config)
    pipe = pipeline.Pipeline(CameraRig(*rig), cfg, device="cpu", fusion_batch=4)
    _, out = pipe.run_offline(pipe.init_state(), Frame.from_arrays(data, "cpu"))
    rcfg = scene.ref_pipeline_config(cell.config)
    _, rout = ref_pipeline.run_offline(judge.ref_state0(rcfg), replay.frame(data),
                                       scene.ref_rig(rig), rcfg, 4)
    tally = judge.Tally()
    out = judge.host(out)
    tally.fused(out.persons_raw, rout.persons_raw, out.n_dropped_hypotheses,
                rout.n_dropped_hypotheses)
    # gate_px 0: every feedback keypoint's validity is compared.
    tally.tracked(out, rout, judge.gate_margin(rout.fused_pred, scene.ref_rig(rig), rcfg), 0.0)
    assert tally.v["decisions_wrong"] == 0
    assert 0 < tally.v["raw_mm"] < 0.05 and tally.v["reproj_px"] < 0.05
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("margin,counted", [(0.4, 0), (2.5, 2)])
def test_feedback_validity_at_the_gate_is_not_a_decision(margin, counted):
    """A feedback keypoint whose validity differs counts (with its person)
    only where the reference's keypoint lies gate_px or more from the
    image border."""
    from portbench.lib import judge
    from portbench.reference.types import Reprojection2D

    def feedback(kp_valid):
        c, p, j = kp_valid.shape
        return Reprojection2D(kp2d=torch.zeros(c, p, j, 3), cov2d=torch.zeros(c, p, j, 3),
                              kp_valid=kp_valid, bbox=torch.zeros(c, p, 4),
                              valid=kp_valid.any(dim=-1), fb_delay=torch.zeros(c),
                              orig_stamp=torch.zeros(c))
    prog = torch.zeros(2, 1, 3, dtype=torch.bool)
    ref = prog.clone()
    ref[1, 0, 2] = True
    margins = torch.full((2, 1, 3), 50.0)
    margins[1, 0, 2] = margin
    tally = judge.Tally()
    tally.feedback(feedback(prog), feedback(ref), margins, 1.0)
    assert tally.v["decisions_wrong"] == counted
    assert tally.at_gate == (1 - counted // 2)
