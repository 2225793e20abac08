"""The CMU Panoptic Studio's 480-camera VGA dome (the benchmark's
portbench/configs/panoptic480.json) on the port's offline path, on the CPU
at small size: 2 persons, 2 detection slots a camera and 4 hypothesis and
track slots, 8 frames of the cell's 25 Hz mix. `Pipeline.run_offline`
routes the association to the camera scan (480 camera steps a chunk: K2's
fold does not fit) and, on the card, the pair costs to kernel E1 and the
triangulation to F1's wide variant, whose host builds stand in for them
here; the run is held to the benchmark's plain reference
(portbench/reference, float64 on the host): every decision exact, the
compared floats within the cell's limits. A traced call counts the scan's
steps, E1's frames and the wide variant's hypotheses per chunk. E1's host
build is also held to the plain terms summed in its order, bit for bit,
and on the card E1 to its plain twin."""

import copy
import functools
import json
import os
import types

import pytest
import torch

from portbench.lib import judge
from portbench.lib import scene as scene_lib
from portbench.reference import pipeline as ref_pipeline
from portbench.reference import replay
from smartedgesensor3dhumanpose_tpu_torch import _kernels, cameras, config, fusion, pipeline, tracing
from smartedgesensor3dhumanpose_tpu_torch.io import synthetic
from smartedgesensor3dhumanpose_tpu_torch.ops import association, epipolar
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
    # The card's triangulation: F1's wide variant, its host build here; and
    # the card's pair costs: kernel E1, its host build here.
    monkeypatch.setattr(fusion, "triangulation_route", lambda cams, dev, dtype: "wide")
    monkeypatch.setattr(tk, "triangulate", functools.partial(tk.triangulate, host=True))
    monkeypatch.setattr(fusion, "pair_costs_route", lambda device, dtype: "kernel")
    monkeypatch.setattr(epipolar, "pair_costs", functools.partial(epipolar.pair_costs, host=True))
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
    assert got["fusion.association.pair_costs_e1"] == FRAMES
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


def dome_fold_inputs(cameras_, frames, device):
    """A chunk of the dome's scene at `cameras_` cameras on `device`: (kp_n,
    det_score, rig, fusion config)."""
    c = copy.deepcopy(_json("configs", "panoptic480.json"))
    c["rig"]["cameras"] = c["pipeline"]["fusion"]["num_cameras"] = cameras_
    cfg = scene_lib.make_config(config, c).fusion
    data = scene_lib.scene(c, _json("mixes", "offline_25hz.json"), frames, SEED)
    chunk = Frame.from_arrays({k: v for k, v in data.items() if k != "det_count"}, device)
    rig = CameraRig(*(t.to(device) for t in scene_lib.rig_arrays(c)))
    kp_n, _, _ = fusion.normalize_frame(chunk, rig, cfg)
    return kp_n, chunk.det_score, rig, cfg


def first_mismatches(got, want, n=6) -> list:
    """The first n entries where two tables differ: (index, got, want)."""
    where = torch.nonzero(got != want)[:n]
    return [(tuple(i.tolist()), float(got[tuple(i)]), float(want[tuple(i)])) for i in where]


# (cameras, persons, frames, seed, detection slots): the demo's hall, a
# wide rig of 96 cameras, 5 slots (D not a multiple of 4: the kernel's
# scalar stores and padded slots) and 12 (two chunks of slots, the kernel
# with D at run time).
PAIR_COST_CASES = ((16, 6, 2, 7, 8), (96, 3, 1, 5, 8), (20, 4, 2, 9, 5), (20, 9, 1, 3, 12))


def hall_fold_inputs(cams, people, frames, seed, dets):
    """A seeded hall scene with ghosts, normalized: (kp_n, det_score,
    det_ok, rig, fusion config)."""
    sc = synthetic.SceneConfig(num_cameras=cams, num_people=people, num_frames=frames,
                               seed=seed, num_ghost_slots=1, ghost_rate=0.5)
    data = synthetic.pad_detections(synthetic.frames_from_scene(synthetic.generate_scene(sc)),
                                    dets)
    cfg = config.FusionConfig(num_cameras=cams, max_dets_per_cam=dets, max_hypotheses=16,
                              assignment_impl="cond_while")
    rig = cameras.hall_rig(cams, device="cpu")
    frame = Frame.from_arrays(data, "cpu")
    kp_n, _, det_ok = fusion.normalize_frame(frame, rig, cfg)
    return kp_n, frame.det_score, det_ok, rig, cfg


def kernel_order_costs(kp_n, F, min_kp_score):
    """The plain per-joint terms summed over the joints in kernel E1's
    order, PyTorch's CUDA reduction's (lane i of W, the largest power of
    two <= J, holds t_i + t_{i+W}; shuffles at offsets W/2 .. 1 combine the
    lanes), scattered into the table [..., C, C*D, D]."""
    terms, both, iu, ju = epipolar.packed_pair_terms(kp_n, F, min_kp_score)
    t = terms.movedim(-3, -1)
    joints, w = t.shape[-1], 1
    while 2 * w <= joints:
        w *= 2
    v = t[..., :w].clone()
    v[..., :joints - w] = v[..., :joints - w] + t[..., w:]
    while v.shape[-1] > 1:
        v = v[..., :v.shape[-1] // 2] + v[..., v.shape[-1] // 2:]
    n = torch.sum(both, dim=-3)
    cost = v[..., 0] / torch.where(n > 0, n, 1)
    c, d = kp_n.shape[-4], kp_n.shape[-3]
    ctab = torch.full(kp_n.shape[:-4] + (c, c, d, d), -1.0)
    ctab[..., ju, iu, :, :] = torch.where(n > 0, cost, -1.0)
    return ctab.reshape(kp_n.shape[:-4] + (c, c * d, d))


def _correctly_rounded_rsqrt(monkeypatch):
    """torch.rsqrt of float32 CPU tensors rounded correctly, 1 / sqrt, as
    E1's host build takes it (PyTorch's vectorized CPU rsqrt is a last bit
    off in some values)."""
    sqrt = torch.sqrt

    def exact(x):
        return (1.0 / sqrt(x.double()).float().double()).float()

    monkeypatch.setattr(torch, "rsqrt", exact)


@pytest.mark.parametrize("case", PAIR_COST_CASES)
def test_pair_costs_host_build_matches_plain_terms_in_kernel_order(case, monkeypatch):
    """Kernel E1 through its host build against the plain per-joint terms
    summed in the kernel's order (`kernel_order_costs`), bit for bit, the
    inverse norms rounded correctly on both sides."""
    kp_n, _, _, rig, cfg = hall_fold_inputs(*case)
    _correctly_rounded_rsqrt(monkeypatch)
    got = epipolar.pair_costs(kp_n, rig.F, cfg.min_kp_score, host=True)
    want = kernel_order_costs(kp_n, rig.F, cfg.min_kp_score)
    assert int((want >= 0).sum()) > 0 and int((want == -1).sum()) > 0
    assert torch.equal(got, want), (int((got != want).sum()), first_mismatches(got, want))


@pytest.mark.parametrize("joints", [1, 5, 13, 32])
def test_pair_costs_host_build_at_other_joint_counts(joints, monkeypatch):
    """E1 at joint counts other than the skeleton's 17 (the count known at
    run time, each reduction width W of 1 to 32): its host build against
    the plain terms summed in its order, bit for bit."""
    kp_n, _, _, rig, cfg = hall_fold_inputs(16, 6, 1, 7, 8)
    kp_n = torch.cat([kp_n, kp_n], dim=-2)[..., :joints, :].contiguous()
    _correctly_rounded_rsqrt(monkeypatch)
    got = epipolar.pair_costs(kp_n, rig.F, cfg.min_kp_score, host=True)
    want = kernel_order_costs(kp_n, rig.F, cfg.min_kp_score)
    assert int((want >= 0).sum()) > 0
    assert torch.equal(got, want), (int((got != want).sum()), first_mismatches(got, want))


@pytest.mark.parametrize("case", PAIR_COST_CASES)
def test_pair_costs_host_build_keeps_the_cpu_routes_decisions(case):
    """E1's host build against fold_inputs' CPU route (the plain terms in
    PyTorch's CPU order): the same -1 pattern, the costs within float32
    rounding, and the same decisions of the plain fold and of the camera
    scan (det_slot, n_hyp, n_dropped)."""
    kp_n, score, det_ok, rig, cfg = hall_fold_inputs(*case)
    want, conf = fusion.fold_inputs(kp_n, score, rig, cfg)
    got = epipolar.pair_costs(kp_n, rig.F, cfg.min_kp_score, host=True)
    assert torch.equal(got == -1, want == -1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    args = (conf, det_ok, cfg.max_hypotheses, cfg.max_epipolar_error, cfg.max_cost)
    for fold in (association.associate_fold_batched_reference, association.associate_scan):
        for a, b in zip(fold(got, *args), fold(want, *args)):
            assert torch.equal(a, b), fold.__name__


def _noted_by_fold_inputs(kp_n, score, rig, cfg) -> dict:
    """fold_inputs in the stage "fusion" of a traced call: the counters it
    notes."""
    marks = tracing.StageMarks("fold", kp_n.device, tracing.Tracer())
    with marks.call():
        tracing.stage("fusion")
        fusion.fold_inputs(kp_n, score, rig, cfg)
        noted = dict(marks._notes)
    return noted


@pytest.mark.parametrize("route", ["plain", "kernel", pytest.param("card", marks=pytest.mark.cuda)])
def test_pair_costs_counter(route, monkeypatch):
    """`fusion.association.pair_costs_e1`, the frames whose table kernel E1
    wrote: 0 on the CPU's plain route, the chunk's frames on the kernel
    route (its host build standing in for it here; on the card, E1)."""
    kp_n, score, _, rig, cfg = hall_fold_inputs(16, 6, 3, 7, 8)
    if route == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card: kernel E1 is a CUDA kernel")
        dev = torch.device("cuda", 0)
        kp_n, score, rig = kp_n.to(dev), score.to(dev), CameraRig(*(t.to(dev) for t in rig))
    if route == "kernel":
        monkeypatch.setattr(fusion, "pair_costs_route", lambda device, dtype: "kernel")
        monkeypatch.setattr(epipolar, "pair_costs", functools.partial(epipolar.pair_costs,
                                                                      host=True))
    got = _noted_by_fold_inputs(kp_n, score, rig, cfg)
    assert got["fusion.association.pair_costs_e1"] == (0 if route == "plain" else 3)


def test_pair_costs_route_and_domain():
    """E1 takes float32 CUDA tensors (the route is a function of device and
    dtype alone) and refuses what it does not take."""
    assert fusion.pair_costs_route(torch.device("cuda", 1), torch.float32) == "kernel"
    assert fusion.pair_costs_route(torch.device("cuda", 0), torch.float64) == "plain"
    assert fusion.pair_costs_route(torch.device("cpu"), torch.float32) == "plain"
    kp = torch.zeros(1, 3, 2, 17, 3)
    F = torch.zeros(3, 3, 3, 3)
    assert torch.equal(epipolar.pair_costs(kp, F, 0.1, host=True), torch.full((1, 3, 6, 2), -1.0))
    for bad_kp, bad_F in ((kp.double(), F), (kp, F.double()), (torch.zeros(1, 3, 2, 33, 3), F),
                          (kp, torch.zeros(2, 2, 3, 3))):
        with pytest.raises(ValueError):
            epipolar.pair_costs(bad_kp, bad_F, 0.1, host=True)
    with pytest.raises(ValueError):
        epipolar.pair_costs(kp, F, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("cameras_, frames", [(16, 1), (16, 32), (96, 8), (480, 2)])
def test_pair_terms_kernel_matches_plain_on_card(cameras_, frames):
    """Kernel E1 (the pair costs' table in one launch) against its plain
    twin on the card, bit for bit, on a chunk of the dome's scene at 16
    cameras (the live step's one frame and the demo's chunk), at 96 and at
    the dome's 480: fold_inputs' table against `pair_terms_plain`'s terms
    summed by torch.sum and scattered (`fusion.pair_costs_plain`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel E1 is a CUDA kernel")
    kp_n, score, rig, cfg = dome_fold_inputs(cameras_, frames, torch.device("cuda", 0))
    assert fusion.pair_costs_route(kp_n.device, kp_n.dtype) == "kernel"
    before = _kernels.LAUNCHES["pair_costs"]
    got, conf = fusion.fold_inputs(kp_n, score, rig, cfg)
    assert _kernels.LAUNCHES["pair_costs"] == before + 1
    want = fusion.pair_costs_plain(kp_n, rig.F, cfg.min_kp_score)
    assert int((want >= 0).sum()) > 0
    assert torch.equal(got, want), (int((got != want).sum()), first_mismatches(got, want))


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
    before = {name: _kernels.LAUNCHES[name] for name in ("scan_costs", "scan_extend")}
    got = association.associate_scan(ctab, conf, det_ok, *rest)
    for name, count in before.items():
        assert _kernels.LAUNCHES[name] == count + ctab.shape[1], name
    want = association.associate_scan_kernels(ctab.cpu(), conf.cpu(), det_ok.cpu(), *rest,
                                              host=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
