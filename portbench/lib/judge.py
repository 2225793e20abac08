"""The comparison that decides a run's `correct`: what the timed path
produced against the plain reference (portbench/reference, float64 on the
host), after the window has closed.

Live cells. The reference runs its own synchronizer over every message
of the warm-up and of the window and must emit the sets the port emitted,
with every set the port stepped among them, in order. It packs each set
it steps from the raw messages itself. It then follows the port's first
`start_steps` steps from the initial state on its own state (the start),
and, for the window steps the seed samples, steps from the port's state
before the step (the stage it cannot follow alone at the window's length:
a plain step takes ~0.2 s on the host). Each step's outputs and new state
are compared; the feedback from the port's predictions of the step.

Offline cells. For one call of the window, drawn from the seed, the
reference fuses a seeded sample of its frames (fusion is frame by frame);
from the port's fused persons of every frame it smooths and tracks the
whole sequence (the tracker is sequential, and the reference follows it
from the port's fusion output); and from the port's predictions of every
frame it reprojects the feedback. Each stage is checked by itself.

Numbers, each compared against a limit of its cell where
portbench/cells/<workload>.json gives one:
  sync_sets_wrong   sets emitted or stepped that the reference's
                    synchronizer does not emit (live)
  decisions_wrong   integer decisions that differ: hypothesis and person
                    validity and ids, publish masks, feedback masks, the
                    dropped-hypothesis and dropped-spawn counters, the
                    tracker state's alive slots, ids and counts
  raw_mm            widest gap of a fused hypothesis joint (triangulation)
  fused_mm          widest gap of a published, smoothed joint
  pred_mm           widest gap of a predicted joint
  reproj_px         widest gap of a reprojected feedback keypoint
  <float>_p50       the median gap of each of the four above, over every
                    compared value
Floats are compared where both sides hold the person or keypoint valid; a
validity that differs is a decision. A feedback keypoint's validity (the
in-image gate) is compared where the reference's keypoint lies at least
the cell's `gate_px` from the image border: nearer, the rounding of
float32 against float64 may put it on either side.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from portbench.lib import scene as scene_lib
from portbench.reference import pipeline as ref_pipeline
from portbench.reference import prior as ref_prior
from portbench.reference import replay as ref_replay
from portbench.reference import skeleton as ref_skeleton
from portbench.reference import sync as ref_sync
from portbench.reference import tracking as ref_tracking
from portbench.reference.ops import covariance as ref_covariance
from portbench.reference.ops import tracker as ref_tracker
from portbench.reference.types import Frame, Persons3D, Reprojection2D, TrackerState

F64 = scene_lib.REF_DTYPE
NUMBERS = ("sync_sets_wrong", "decisions_wrong", "raw_mm", "fused_mm", "pred_mm", "reproj_px")


def host(tree):
    """A tuple tree of tensors on the host, floats widened to float64."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.to(F64) if t.is_floating_point() else t
    values = [host(x) for x in tree]
    return type(tree)(*values) if hasattr(tree, "_fields") else tuple(values)


class Tally:
    """The compared numbers, accumulated over every compared step."""

    def __init__(self, numbers=NUMBERS):
        self.v = {n: 0 if n.endswith("_wrong") else 0.0 for n in numbers}
        # Where the decisions differ: field -> count, for the run's log.
        self.fields = collections.Counter()
        self.at = {}  # float number -> index of its widest gap
        self.gaps = collections.defaultdict(list)  # float number -> every gap
        self.at_gate = 0  # feedback keypoints within gate_px whose validity differs

    def count(self, name, a, b, where=None, field=""):
        diff = a != b
        if where is not None:
            diff = diff & where
        n = int(diff.sum())
        self.v[name] += n
        if n:
            self.fields[field] += n

    def gap(self, name, a, b, where, scale):
        if where.any():
            d = (a - b).abs()
            self.gaps[name].append(d[where] * scale)
            worst = float(d[where].max()) * scale
            if worst > self.v[name]:
                self.v[name] = worst
                self.at[name] = torch.nonzero(where & (d * scale == worst))[0].tolist()

    def medians(self) -> dict:
        """The median gap of each float number, over every compared value
        (printed beside the widest, for the limits' readings)."""
        return {f"{n}_p50": float(torch.cat(self.gaps[n]).median()) if self.gaps[n] else 0.0
                for n in self.v if not n.endswith("_wrong")}

    def log(self):
        from portbench.lib.harness import note

        for name, value in sorted(self.medians().items()):
            note(f"judge: {name} {value!r}")
        for field, n in sorted(self.fields.items()):
            note(f"judge: decisions differ: {field}: {n}")
        for name, at in sorted(self.at.items()):
            note(f"judge: {name} widest at {at}")
        if self.at_gate:
            note(f"judge: feedback keypoints at the in-image gate whose validity differs "
                 f"(not counted): {self.at_gate}")

    def persons(self, prog: Persons3D, ref: Persons3D, number: str):
        both = prog.valid & ref.valid
        self.count("decisions_wrong", prog.valid, ref.valid, field=f"{number}: valid")
        self.count("decisions_wrong", prog.person_id, ref.person_id, both, f"{number}: id")
        joints = both[..., None] & (prog.score > 0) & (ref.score > 0)
        self.count("decisions_wrong", prog.score > 0, ref.score > 0, both[..., None],
                   f"{number}: joint valid")
        self.gap(number, prog.xyz, ref.xyz, joints[..., None].expand_as(prog.xyz), 1e3)

    def feedback(self, prog: Reprojection2D, ref: Reprojection2D, margin, gate_px: float):
        """`margin`: how far each of the reference's keypoints lies inside
        the image (gate_margin)."""
        clear = margin.abs() >= gate_px
        differ = prog.kp_valid != ref.kp_valid
        self.count("decisions_wrong", prog.kp_valid, ref.kp_valid, clear, "feedback kp_valid")
        self.count("decisions_wrong", prog.valid, ref.valid,
                   (differ & clear).any(dim=-1) | ~differ.any(dim=-1), "feedback valid")
        self.at_gate += int((differ & ~clear).sum())
        ok = prog.kp_valid & ref.kp_valid
        self.gap("reproj_px", prog.kp2d[..., :2], ref.kp2d[..., :2],
                 ok[..., None].expand_as(prog.kp2d[..., :2]), 1.0)

    def state(self, prog: TrackerState, ref: TrackerState):
        for name in ("alive", "track_id", "num_obs", "next_id", "frame_nr"):
            self.count("decisions_wrong", getattr(prog, name), getattr(ref, name),
                       field=f"state {name}")
        alive = prog.alive & ref.alive
        self.count("decisions_wrong", prog.est_exists, ref.est_exists, alive[..., None],
                   "state est_exists")

    def tracked(self, prog, ref, margin, gate_px: float):
        """The tracker's part of a StepOutput (any leading time axis)."""
        self.persons(prog.fused, ref.fused, "fused_mm")
        self.persons(prog.fused_pred, ref.fused_pred, "pred_mm")
        self.feedback(prog.feedback, ref.feedback, margin, gate_px)
        self.count("decisions_wrong", prog.n_dropped_track_spawns, ref.n_dropped_track_spawns,
                   field="dropped spawns")

    def fused(self, prog_raw, ref_raw, prog_drop, ref_drop):
        self.persons(prog_raw, ref_raw, "raw_mm")
        self.count("decisions_wrong", prog_drop, ref_drop, field="dropped hypotheses")


def gate_margin(persons: Persons3D, rig, cfg) -> torch.Tensor:
    """How far (px) each keypoint that the reference reprojects from
    `persons` lies inside the image, negative outside: [..., C, P, J]."""
    to_fusion = torch.as_tensor(ref_skeleton.input_model(cfg.prior.pose_method).to_fusion)
    dtype = persons.xyz.dtype
    mean_px, _ = ref_covariance.project_with_covariance(
        persons.xyz[..., to_fusion, :], persons.cov[..., to_fusion, :, :], rig.P.to(dtype),
        rig.K.to(dtype), kappa=cfg.fusion.ut_kappa)
    size = rig.image_size.to(dtype)
    margin = torch.minimum(torch.minimum(mean_px[..., 0], size[:, 0] - mean_px[..., 0]),
                           torch.minimum(mean_px[..., 1], size[:, 1] - mean_px[..., 1]))
    return margin.movedim(-1, -3)


def ref_state0(cfg) -> TrackerState:
    t = cfg.tracker
    return TrackerState.initial(t.max_tracks, t.n_mov_avg, t.avg_delay, dtype=F64, device="cpu")


def sync_check(schedule, steps, emitted: int, num_cameras: int) -> int:
    """Sets the port emitted or stepped that the reference synchronizer,
    fed the same messages in the same order, does not emit."""
    sync = ref_sync.synchronizer(num_cameras)
    sets = []
    for i in range(len(schedule)):
        sync.push(int(schedule.camera[i]), int(round(float(schedule.stamp[i]) * 1e9)), i + 1)
        while (got := sync.pop()) is not None:
            sets.append((tuple(got[1]), tuple(got[0])))
    wrong = abs(emitted - len(sets))
    pos = 0
    for s in steps:
        at = pos
        while at < len(sets) and sets[at][0] != s.handles:
            at += 1
        if at == len(sets) or sets[at][1] != s.stamps_ns:
            wrong += 1
        else:
            pos = at + 1
    return wrong


def ref_frame(schedule, handles, max_dets: int) -> Frame:
    """The reference's packing of a set from its messages."""
    payloads = [schedule.payload(h - 1) for h in handles]
    stamps = [int(round(float(schedule.stamp[h - 1]) * 1e9)) for h in handles]
    return ref_replay.frame(ref_replay.pack_set(payloads, stamps, max_dets))


class LiveCase:
    """What a live run hands the reference, moved to the host."""

    def __init__(self, run, data, warm, win):
        self.cell = run.cell
        self.rig = scene_lib.ref_rig(scene_lib.rig_arrays(run.cell.config))
        self.cfg = scene_lib.ref_pipeline_config(run.cell.config)
        n = int(run.cell.check["start_steps"])
        self.gate_px = float(run.cell.check["gate_px"])
        self.start = [(s.handles, host(s.record[1]), host(s.record[2]))
                      for s in warm.consumer.steps[:n]]
        self.samples = [(s.handles, host(s.record[0]), host(s.record[1]), host(s.record[2]))
                        for s in win.consumer.steps if s.record]
        # The sets alone: the device tensors of the records are not kept.
        self.warm, self.win = ((p.schedule, [s._replace(record=()) for s in p.consumer.steps],
                                p.report.frames_synced) for p in (warm, win))
        self.num_cameras = self.cfg.fusion.num_cameras
        self.max_dets = self.cfg.fusion.max_dets_per_cam

    def check(self):
        tally = Tally()
        tally.v["sync_sets_wrong"] = sum(
            sync_check(sched, steps, emitted, self.num_cameras)
            for sched, steps, emitted in (self.warm, self.win))
        state = ref_state0(self.cfg)
        for handles, out, after in self.start:
            frame = ref_frame(self.warm[0], handles, self.max_dets)
            state, ref_out = ref_pipeline.step(state, frame, self.rig, self.cfg)
            self.compare(tally, out, ref_out, after, state)
        del ref_tracking.ASSIGNMENTS[:], ref_prior.LM_RUNS[:]
        for handles, before, out, after in self.samples:
            frame = ref_frame(self.win[0], handles, self.max_dets)
            ref_after, ref_out = ref_pipeline.step(TrackerState(*before), frame, self.rig, self.cfg)
            self.compare(tally, out, ref_out, after, ref_after)
        work = {"assignments": list(ref_tracking.ASSIGNMENTS), "lm_runs": list(ref_prior.LM_RUNS),
                "samples": len(self.samples)}
        tally.log()
        return dict(tally.v, **tally.medians()), work

    def compare(self, tally, out, ref_out, after, ref_after):
        tally.fused(out.persons_raw, ref_out.persons_raw, out.n_dropped_hypotheses,
                    ref_out.n_dropped_hypotheses)
        # The feedback is checked by itself, from the port's predictions
        # (which pred_mm checks): a keypoint at the in-image gate would
        # otherwise flip with the predictions' rounding.
        feedback = ref_pipeline.offline_feedback(out.fused_pred, out.pred_delta_t,
                                                 ref_out.ts_per_cam, self.rig, self.cfg)
        tally.tracked(out, ref_out._replace(feedback=feedback),
                      gate_margin(out.fused_pred, self.rig, self.cfg), self.gate_px)
        tally.state(TrackerState(*after), ref_after)


class OfflineCase:
    """What an offline run hands the reference: one call's sequence and
    outputs, and the port's final state of that call."""

    def __init__(self, run, frames: dict, out, state, sample_frames):
        self.cfg = scene_lib.ref_pipeline_config(run.cell.config)
        self.rig = scene_lib.ref_rig(scene_lib.rig_arrays(run.cell.config))
        self.frames = frames
        self.out = host(out)
        self.state = host(state)
        self.sample = np.asarray(sorted(sample_frames))
        self.fusion_batch = int(run.cell.config["fusion_batch"])
        self.gate_px = float(run.cell.check["gate_px"])

    def check(self):
        numbers = tuple(n for n in NUMBERS if n != "sync_sets_wrong")
        tally = Tally(numbers)
        frames = ref_replay.frame(self.frames)
        out = self.out
        # Fusion, frame by frame, on the sampled frames.
        idx = torch.as_tensor(self.sample)
        sub = Frame(*(x[idx] for x in frames))
        persons, _, n_drop = ref_pipeline.fuse_offline(sub, self.rig, self.cfg, len(self.sample))
        tally.fused(Persons3D(*(x[idx] for x in out.persons_raw)), persons,
                    out.n_dropped_hypotheses[idx], n_drop)
        # Smoothing, tracking and reprojection of every frame, from the
        # port's fusion output.
        del ref_prior.LM_RUNS[:]
        _, pivots = ref_pipeline.mask_stale_cameras(frames, self.cfg.fusion.max_sync_diff)
        raw = out.persons_raw
        pre = ref_pipeline.smooth_offline(raw, self.cfg, self.fusion_batch)
        lm_runs = list(ref_prior.LM_RUNS)
        state, track = ref_tracker.tracker_scan(
            ref_state0(self.cfg), raw, pivots.to(F64), frames.fb_delay, pre,
            self.cfg.prior, self.cfg.tracker)
        tally.persons(out.fused, track.fused, "fused_mm")
        tally.persons(out.fused_pred, track.fused_pred, "pred_mm")
        tally.count("decisions_wrong", out.n_dropped_track_spawns, track.n_dropped_spawns,
                    field="dropped spawns")
        # Reprojection of every frame, from the port's predictions.
        feedback = ref_pipeline.offline_feedback(out.fused_pred, out.pred_delta_t,
                                                 frames.cam_stamp, self.rig, self.cfg)
        tally.feedback(out.feedback, feedback, gate_margin(out.fused_pred, self.rig, self.cfg),
                       self.gate_px)
        tally.state(TrackerState(*self.state), state)
        valid = raw.valid
        work = {"lm_runs": lm_runs, "frames": int(valid.shape[0]),
                "valid_persons": int(valid.sum()),
                "detection_frames": int(valid.any(dim=1).sum())}
        tally.log()
        return dict(tally.v, **tally.medians()), work
