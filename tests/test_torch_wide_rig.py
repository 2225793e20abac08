"""The CMU Panoptic Studio's 480-camera VGA dome (the benchmark's
portbench/configs/panoptic480.json) on the port's offline path, on the CPU
at small size: 2 persons, 2 detection slots a camera and 4 hypothesis and
track slots, 8 frames of the cell's 25 Hz mix. `Pipeline.run_offline`
routes the association to the camera scan (480 camera steps a chunk: K2's
fold does not fit) and, on the card, the triangulation to F1's wide
variant, whose host build stands in for it here; the run is held to the
benchmark's plain reference (portbench/reference, float64 on the host):
every decision exact, the compared floats within the cell's limits. A
traced call counts the scan's steps and the wide variant's hypotheses per
chunk."""

import copy
import json
import os
import types

import pytest
import torch

from portbench.lib import judge
from portbench.lib import scene as scene_lib
from portbench.reference import pipeline as ref_pipeline
from portbench.reference import replay
from smartedgesensor3dhumanpose_tpu_torch import cameras, config, fusion, pipeline
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import association
from smartedgesensor3dhumanpose_tpu_torch.ops import triangulation_kernel as tk
from smartedgesensor3dhumanpose_tpu_torch.types import CameraRig, Frame

pytestmark = pytest.mark.torch_port

_BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "portbench")
FRAMES, SEED = 8, 2_147_483_659


def _json(*parts):
    with open(os.path.join(_BENCH, *parts)) as f:
        return json.load(f)


# (cameras, persons, hypothesis slots, frames, seed, ghost slots): the
# demo's hall, a rig with dropped spawns every frame (5 slots), a wider one
# with ghosts, and the dome's 480 cameras.
SCAN_CASES = ((16, 6, 16, 3, 7, 0), (16, 6, 5, 3, 9, 2), (40, 7, 24, 2, 5, 1),
              (480, 2, 4, 1, 13, 0))


def scan_inputs(cams, people, h, frames, seed, ghosts, device="cpu"):
    """The fold inputs of a seeded hall scene with identity swaps, as
    `fusion.associate` hands them to the scan: (ctab, conf_obs, det_ok,
    h, gate, max_cost)."""
    sc = synthetic.SceneConfig(num_cameras=cams, num_people=people, num_frames=frames,
                               seed=seed, num_ghost_slots=ghosts,
                               ghost_rate=0.5 if ghosts else 0.0, identity_swap_rate=0.2)
    data = synthetic.pad_detections(synthetic.frames_from_scene(synthetic.generate_scene(sc)), 8)
    cfg = config.FusionConfig(num_cameras=cams, max_dets_per_cam=8, max_hypotheses=h,
                              assignment_impl="cond_while")
    rig = cameras.hall_rig(cams, device=device)
    frame = Frame.from_arrays(data, device)
    kp_n, _, det_ok = fusion.normalize_frame(frame, rig, cfg)
    ctab, conf = fusion.fold_inputs(kp_n, frame.det_score, rig, cfg)
    return ctab, conf, det_ok, h, cfg.max_epipolar_error, cfg.max_cost


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_kernels_host_build_matches_the_scan(case):
    """Kernels S1 and S2 (each camera step's costs and extend-or-spawn,
    csrc/scan_step.cu) through their host build, with the plain JV between
    them, against the PyTorch camera scan (`_scan_camera`), bit for bit:
    det_slot, n_hyp and n_dropped, dropped spawns among them."""
    args = scan_inputs(*case)
    want = association.associate_scan(*args)
    got = association.associate_scan_kernels(*args, host=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[1].sum()) > 0
    if case[2] == 5:
        assert int(want[2].sum()) > 0


def small_dome() -> dict:
    """The configuration file at small size (module docstring); tracks
    publish after 3 observations, so that 8 frames publish some."""
    c = copy.deepcopy(_json("configs", "panoptic480.json"))
    c["scene"]["num_people"] = 2
    c["pipeline"]["fusion"].update(max_dets_per_cam=2, max_hypotheses=4)
    c["pipeline"]["tracker"].update(max_tracks=4, min_num_obs=3)
    c["fusion_batch"] = FRAMES
    return c


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(2, saved))
    yield
    torch.set_num_threads(saved)


def _dome_call(monkeypatch, fault=None):
    """run_offline of the small dome's 8 frames, traced, with `fault`
    (a wrapper of fusion.associate) planted: (config file, data, out,
    state, counters)."""
    c = small_dome()
    cfg = scene_lib.make_config(config, c)
    data = scene_lib.scene(c, _json("mixes", "offline_25hz.json"), FRAMES, SEED)
    rig = scene_lib.rig_arrays(c)
    # The card's triangulation: F1's wide variant, its host build here.
    monkeypatch.setattr(fusion, "triangulation_route", lambda cams, dev, dtype: "wide")
    monkeypatch.setattr(tk, "triangulate", tk.triangulate_host)
    if fault is not None:
        monkeypatch.setattr(fusion, "associate", fault(fusion.associate))
    pipe = pipeline.Pipeline(CameraRig(*rig), cfg, device="cpu", fusion_batch=FRAMES, trace=True)
    with pipe.tracer:
        state, out = pipe.run_offline(pipe.init_state(),
                                      Frame.from_arrays({k: v for k, v in data.items()
                                                         if k != "det_count"}, "cpu"))
    counters = pipe.tracer.drain().counters
    got = {str(n): int(v) for n, v in zip(counters["name"], counters["value"])}
    return c, data, out, state, got


def _dome_check(c, data, out, state, sample):
    """The cell's check (portbench/lib/judge.py) on this call: the reference
    fuses the `sample` frames, and smooths, tracks and reprojects every
    frame from the port's fusion. Its numbers and whether they are within
    the cell's limits."""
    cell = types.SimpleNamespace(config=c, check=_json(
        "cells", "panoptic480_offline_replay.json")["check"])
    case = judge.OfflineCase(types.SimpleNamespace(cell=cell), data, out, state, sample)
    numbers, _ = case.check()
    limits = _json("cells", "panoptic480_offline_replay.json")["numbers"]
    return numbers, all(numbers[k] <= v["limit"] for k, v in limits.items())


def test_dome_offline_through_the_scan_matches_the_reference(monkeypatch):
    c = small_dome()
    cfg = scene_lib.make_config(config, c)
    assert cfg.fusion.num_cameras == c["rig"]["cameras"] == 480
    assert fusion.association_route(cfg.fusion, 480, 2) == "scan"
    assert fusion.triangulation_route(480, torch.device("cuda"), torch.float32) == "wide"
    c, data, out, state, got = _dome_call(monkeypatch)
    assert got["fusion.association.scan_steps"] == 480
    assert got["fusion.triangulation.f1w"] == FRAMES * 4
    assert got["fusion.triangulation.f1"] == 0
    assert int(out.persons_raw.valid.sum()) > 0 and int(out.fused.valid.sum()) > 0
    assert int(out.feedback.kp_valid.sum()) > 0
    numbers, within = _dome_check(c, data, out, state, [0, 3, 7])
    assert numbers["decisions_wrong"] == 0
    assert within, numbers


def _later_frames_lost(associate):
    """The association of a chunk's later half of frames left out: their
    hypotheses dropped."""
    def run(kp_n, *args):
        hyps = associate(kp_n, *args)
        if kp_n.dim() == 4:
            return hyps
        late = torch.arange(kp_n.shape[0]) >= kp_n.shape[0] // 2
        return hyps._replace(n_hyp=torch.where(late, 0, hyps.n_hyp))
    return run


def test_dome_check_catches_a_fault_in_a_chunks_later_frames(monkeypatch):
    """The check reads not correct where the fusion of the chunk's later
    frames is broken and a sampled frame lies among them (the reference
    fuses only the sampled frames; the rest is smoothed, tracked and
    reprojected from the port's own fusion)."""
    c, data, out, state, _ = _dome_call(monkeypatch, _later_frames_lost)
    assert not bool(out.persons_raw.valid[FRAMES // 2:].any())
    numbers, within = _dome_check(c, data, out, state, [0, 3, 7])
    assert numbers["decisions_wrong"] > 0 and not within, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cameras_, frames", [(16, 1), (16, 2), (480, 2)])
def test_pair_terms_kernel_matches_plain_on_card(cameras_, frames):
    """Kernel E1 (the pair costs' per-joint terms in one pass) against the
    plain terms on the card, bit for bit, on a frame of the dome's scene
    at 16 cameras and at its 480: the terms, the confident flags and the
    packed fold inputs they give (one frame: the live step's chunk).
    The sums over the joints are PyTorch's on both sides: E1 writes its
    terms in the plain kernels' layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel E1 is a CUDA kernel")
    from smartedgesensor3dhumanpose_tpu_torch.ops import epipolar

    dev = torch.device("cuda", 0)
    c = copy.deepcopy(_json("configs", "panoptic480.json"))
    c["rig"]["cameras"] = c["pipeline"]["fusion"]["num_cameras"] = cameras_
    cfg = scene_lib.make_config(config, c).fusion
    data = scene_lib.scene(c, _json("mixes", "offline_25hz.json"), frames, SEED)
    frames = Frame.from_arrays({k: v for k, v in data.items() if k != "det_count"}, dev)
    rig = CameraRig(*(t.to(dev) for t in scene_lib.rig_arrays(c)))
    kp_n, _, _ = fusion.normalize_frame(frames, rig, cfg)
    got = fusion.fold_inputs(kp_n, frames.det_score, rig, cfg)
    sides = []
    monkey = pytest.MonkeyPatch()

    def plain(*args):
        sides.append(args)
        return epipolar.pair_terms_plain(*args)

    monkey.setattr(epipolar, "pair_terms", plain)
    try:
        want = fusion.fold_inputs(kp_n, frames.det_score, rig, cfg)
    finally:
        monkey.undo()
    for args in sides:
        mine, plain_ = epipolar.pair_terms(*args), epipolar.pair_terms_plain(*args)
        for a, b in zip(mine, plain_):
            mismatch = a != b
            assert not bool(mismatch.any()), (int(mismatch.sum()), a[mismatch][:4].tolist(),
                                              b[mismatch][:4].tolist())
        sums = [torch.sum(t[0], dim=-3) for t in (mine, plain_)]
        assert torch.equal(*sums), (
            "sums of equal terms differ", int((sums[0] != sums[1]).sum()),
            [(tuple(t[0].stride()), t[0].data_ptr() % 64, t[0].is_contiguous())
             for t in (mine, plain_)])
    for a, b in zip(got, want):
        assert torch.equal(a, b), (int((a != b).sum()), float((a - b).abs().max()),
                                   int(torch.isnan(a).sum()), int(torch.isnan(b).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_kernels_on_card_match_their_host_build(case):
    """Kernels S1 and S2 with K1 between them on the card against their
    host build with the plain JV on the same fold inputs (the card's),
    bit for bit; `fusion.associate` takes them on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernels S1 and S2 are CUDA kernels")
    dev = torch.device("cuda", 0)
    ctab, conf, det_ok, *rest = scan_inputs(*case, device=dev)
    before = association.SCAN_LAUNCHES
    got = association.associate_scan(ctab, conf, det_ok, *rest)
    assert association.SCAN_LAUNCHES == before + 2 * ctab.shape[1]
    want = association.associate_scan_kernels(ctab.cpu(), conf.cpu(), det_ok.cpu(), *rest,
                                              host=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
