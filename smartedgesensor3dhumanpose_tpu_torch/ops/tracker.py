"""The offline tracker scan: kernel K3 and its plain PyTorch version.

The tracker is sequential across frames: association costs, spawns, the
velocity ring buffers and the merge sweep all read the previous frame's
track state. Offline, after the LM smoothing has been hoisted out of the
loop (tracking.smooth_cold), what is left is the whole scan of
`tracking.step(..., precomputed=...)` over a sequence. This module is the
port of the JAX package's ops/tracker_pallas.py:

* `frame_local_chain`: the per-frame quantities that depend only on the
  frame's inputs and counters (the feedback-delay ring and prediction
  horizon, the velocity-ring slot, the inter-frame delta), computed for the
  whole sequence in vectorized torch ops outside the kernel;
* `tracker_scan_reference`: the plain version, a loop over frames of
  `tracking.step(..., precomputed=pre_t)` with the plain JV;
* `tracker_scan`: kernel K3 (csrc/tracker_scan.cu) for CUDA float32
  tensors whose shapes K3 takes (`kernel_takes`: persons <= track slots <=
  MAX_TRACKS, 21 joints), one launch for all frames with the track state
  resident on chip; for other shapes on CUDA, the same loop as the plain
  version with kernel K1 solving each frame's assignment (JAX's `lax.scan`
  of tracking.step beyond its kernel's domain, pipeline.py:231-262 there);
  the plain version for CPU tensors. The route depends on the shapes and
  the device only.

Layout of the kernel's inputs (`_pack`): one record per frame
(`frame_layout`: the persons' joints, flags and the frame scalars, each
field 16-byte aligned), which the kernel copies into shared memory one
frame ahead; the state as [T, ...] rows, one per track slot. `scan_plan`
decides per launch what of it lives on chip. The TPU kernel's [rows, 128
lanes] tiles, 8-row padding and SMEM scalar blocks were Mosaic limits and
are not carried over.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from smartedgesensor3dhumanpose_tpu_torch import _kernels, skeleton, tracking
from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian, linalg
from smartedgesensor3dhumanpose_tpu_torch.types import Persons3D, TrackerState

K_JOINTS = skeleton.NUM_FUSION_JOINTS
# Track slots K3 takes: the embedded JV solves persons x slots with n = T
# columns, so T is bounded by the JV's own limit (ops.hungarian.MAX_N).
MAX_TRACKS = hungarian.MAX_N


def frame_local_chain(state0: TrackerState, has_dets, fb_delay, pivots, cfg):
    """Vectorized precompute of every frame-local scalar the scan carries
    (tracking.step's feedback-delay and frame-counter arithmetic, exactly).

    has_dets [F] bool, fb_delay [F, C], pivots [F]. Returns (pred_delta_t
    [F], slot_w [F] int32 velocity-ring slot, dt_glob [F], final
    fb_delay_buffer [W], final frame_nr [] int32).
    """
    f = pivots.shape[0]
    w = state0.fb_delay_buffer.shape[0]
    dtype = pivots.dtype
    dev = pivots.device

    valid_delay = fb_delay > 0
    n_valid = torch.sum(valid_delay, dim=1)
    curr_avg = torch.where(
        n_valid > 0,
        torch.sum(torch.where(valid_delay, fb_delay, 0.0), dim=1)
        / torch.clamp(n_valid, min=1),
        cfg.avg_delay,
    ).to(dtype)

    # frame_nr only advances on frames with detections; the ring slot of a
    # frame is its frame_nr at entry modulo W.
    has_i = has_dets.to(torch.int64)
    fn = state0.frame_nr.to(torch.int64) + torch.cumsum(has_i, 0) - has_i
    slot = fn % w

    # Ring entry k after frame f: the delay of the last frame <= f that
    # wrote slot k, else the initial entry.
    idx = torch.arange(f, device=dev)
    rings = []
    for k in range(w):
        last = torch.cummax(torch.where(slot == k, idx, -1), dim=0).values
        rings.append(torch.where(
            last >= 0, curr_avg[last.clamp(min=0)], state0.fb_delay_buffer[k]
        ))
    ring = torch.stack(rings, dim=0)  # [W, F]
    pred_delta_t = torch.mean(ring, dim=0)

    prev_pivot = torch.cat([state0.t_prev_global[None].to(dtype), pivots[:-1]])
    dt_glob = torch.clamp(pivots - prev_pivot, min=1e-6)
    frame_nr = (state0.frame_nr + torch.sum(has_i)).to(torch.int32)
    return pred_delta_t, slot.to(torch.int32), dt_glob, ring[:, -1], frame_nr


def _rebuild(like, values):
    """A tuple or NamedTuple of the same type as `like` holding `values`."""
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def _frame(tree, f: int):
    """Frame f of a stacked Persons3D / precomputed tuple (PriorResult's
    iteration count, a 0-d tensor or an int, passes through)."""
    if isinstance(tree, torch.Tensor):
        return tree[f] if tree.dim() else tree
    if isinstance(tree, int):
        return tree
    return _rebuild(tree, [_frame(x, f) for x in tree])


def stack_frames(items):
    """Stack a list of per-frame outputs (TrackStepOutput, StepOutput, any
    tuple tree of tensors) along a new leading frame axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return _rebuild(first, [stack_frames(list(xs)) for xs in zip(*items)])


def tracker_scan_steps(state0: TrackerState, persons: Persons3D, pivots,
                       fb_delay, pre, prior_cfg, cfg, assign):
    """`tracking.step(..., precomputed=pre_t)` frame by frame, each frame's
    assignment solved by `assign`. Arguments and returns as
    `tracker_scan`."""
    dtype = persons.xyz.dtype
    state = state0
    outs = []
    for f in range(pivots.shape[0]):
        state, out = tracking.step(
            state, _frame(persons, f), pivots[f].to(dtype), fb_delay[f],
            prior_cfg, cfg, precomputed=_frame(pre, f), assign=assign,
        )
        outs.append(out)
    return state, stack_frames(outs)


def tracker_scan_reference(state0: TrackerState, persons: Persons3D, pivots,
                           fb_delay, pre, prior_cfg, cfg):
    """Plain PyTorch K3: `tracker_scan_steps` with the plain JV. Arguments
    and returns as `tracker_scan`."""
    return tracker_scan_steps(state0, persons, pivots, fb_delay, pre, prior_cfg,
                              cfg, hungarian.linear_sum_assignment_reference)


def kernel_takes(p: int, t_slots: int, k_j: int) -> bool:
    """Whether K3 takes these shapes: P <= T <= MAX_TRACKS, K = 21 (JAX's
    rule for its tracker kernel, pipeline.py:231-236 there, at the port's
    JV width)."""
    return p <= t_slots <= MAX_TRACKS and k_j == K_JOINTS


# Shared memory one thread block may hold on an H100 (static + dynamic,
# after the opt-in), and an upper bound of K3's static shared memory (the JV
# state, the scan sums, the velocity sigmas and two barriers: ~4.3 KB).
SMEM_PER_BLOCK = 232_448
STATIC_SMEM_RESERVE = 5_120


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def frame_layout(p: int):
    """K3's per-frame input record for `p` persons: (fields, bytes). Each
    field is (name, dtype, shape within one frame, byte offset); every
    offset is 16-byte aligned and `bytes` a multiple of 16, as the kernel's
    bulk copies need (csrc/tracker_scan.cu::frame_layout, the same rule)."""
    f32, u8 = torch.float32, torch.uint8
    shapes = (
        ("meas", f32, (p, 3 * K_JOINTS)),  # fusion joints
        ("rx", f32, (p, 3 * K_JOINTS)),    # LM result, normalized joints
        ("root", f32, (p, 3)),
        ("hgt", f32, (p,)),
        ("okpk", u8, (p, K_JOINTS)),       # joint score above min_score
        ("act", u8, (p, K_JOINTS)),        # LM-active joints
        ("valid", u8, (p,)),
        ("hm", u8, (p,)),                  # person has measurements
        ("fsc", f32, (3,)),                # pivot, pred_delta_t, dt_glob
        ("fint", torch.int32, (2,)),       # slot_w, has_dets
    )
    fields, offset = [], 0
    for name, dtype, shape in shapes:
        fields.append((name, dtype, shape, offset))
        offset += _pad16(math.prod(shape) * dtype.itemsize)
    return fields, offset


def pack_frames(values: dict, p: int) -> torch.Tensor:
    """The records [F, bytes] uint8 of `frame_layout(p)` holding `values`
    (name -> [F, ...] tensor of the field's shape), padding zeroed: one
    copy per field into a view of its bytes."""
    fields, nbytes = frame_layout(p)
    f = values["fsc"].shape[0]
    records = torch.zeros((f, nbytes), dtype=torch.uint8, device=values["fsc"].device)
    for name, dtype, shape, offset in fields:
        n = math.prod(shape) * dtype.itemsize
        records[:, offset:offset + n].view(dtype).copy_(values[name].reshape(f, -1))
    return records


class ScanPlan(NamedTuple):
    """K3's shared-memory layout for one launch: frame records staged on
    chip (2 = the next frame lands while this one runs), whether the
    velocity rings live on chip, and the dynamic shared memory in bytes."""

    stages: int
    rings_on_chip: bool
    smem_bytes: int


def state_smem_bytes(p: int, t_slots: int) -> int:
    """K3's track state and scratch in shared memory (tracker_scan.cu::
    state_bytes): 4-byte words for the estimates and their world joints,
    the cost's divisors and reciprocals [T, 21], the cost [P, T], the
    merge's bit sets [T, 4] and boxes [T, 6], the slot and person scalars,
    lists and joint bit sets; bytes for the joint flags."""
    words = (2 * t_slots * 3 * K_JOINTS + 2 * t_slots * K_JOINTS + p * t_slots
             + 22 * t_slots + 10 * p)
    return 4 * words + t_slots * K_JOINTS


def scan_plan(p: int, t_slots: int, w: int) -> ScanPlan:
    """The layout K3 takes at these shapes, within SMEM_PER_BLOCK less the
    kernel's static shared memory: the frame records double-buffered if
    they fit beside the state, else single; then the velocity rings
    [T, 21, W, 3] if they fit too, else they stay in device memory."""
    budget = SMEM_PER_BLOCK - STATIC_SMEM_RESERVE
    record = frame_layout(p)[1]
    state = state_smem_bytes(p, t_slots)
    rings = _pad16(4 * t_slots * K_JOINTS * w * 3)  # keeps the state after it aligned
    stages = 2 if state + 2 * record <= budget else 1
    rings_on_chip = state + stages * record + rings <= budget
    smem = state + stages * record + (rings if rings_on_chip else 0)
    if smem > budget:
        raise ValueError(
            f"the tracker-scan kernel needs {smem} bytes of shared memory at "
            f"persons={p}, track slots={t_slots}, window={w}; a block holds {budget}"
        )
    return ScanPlan(stages, rings_on_chip, smem)


def _pack(persons: Persons3D, pre, prior_cfg, pivots, pred_delta_t, dt_glob,
          slot_w, has_dets):
    """The kernel's per-frame input records [F, bytes] (frame_layout)."""
    g_in, result, _, _ = pre
    f, p, k, _ = persons.xyz.shape
    return pack_frames(dict(
        meas=persons.xyz,
        rx=result.x,
        root=g_in.root_xyz,
        hgt=g_in.height,
        okpk=persons.score > prior_cfg.min_score,
        act=g_in.active,
        valid=persons.valid,
        hm=g_in.num_meas > 0,
        fsc=torch.stack([pivots, pred_delta_t, dt_glob], dim=1),
        fint=torch.stack([slot_w, has_dets.to(torch.int32)], dim=1),
    ), p)


def state_buffers(state: TrackerState) -> dict:
    """The kernel's state buffers: fresh copies of `state` in its layout.
    The kernel reads the initial state from them and writes the final state
    back into them (the caller's state is never written)."""
    t = state.alive.shape[0]
    f32 = torch.float32
    return dict(
        est=state.estimate.reshape(t, -1).to(f32).clone().contiguous(),
        ex=state.est_exists.to(torch.uint8).contiguous(),
        vel=state.vel_buffer.to(f32).clone().contiguous(),
        tprev=state.t_prev.to(f32).clone().contiguous(),
        hprev=state.height_prev.to(f32).clone().contiguous(),
        rootp=state.root_prev.to(f32).clone().contiguous(),
        alive=state.alive.to(torch.uint8).contiguous(),
        tid=state.track_id.to(torch.int32).clone().contiguous(),
        nobs=state.num_obs.to(torch.int32).clone().contiguous(),
        next_id=state.next_id.to(torch.int32).reshape(1).clone(),
    )


def state_from_buffers(buf: dict, state0: TrackerState, frame_nr, fb_final,
                       t_prev_global) -> TrackerState:
    """The TrackerState held in the kernel's state buffers."""
    t, k = state0.est_exists.shape
    dtype = state0.estimate.dtype
    return TrackerState(
        alive=buf["alive"] > 0,
        track_id=buf["tid"],
        estimate=buf["est"].reshape(t, k, 3).to(dtype),
        est_exists=buf["ex"] > 0,
        vel_buffer=buf["vel"].to(dtype),
        t_prev=buf["tprev"].to(dtype),
        num_obs=buf["nobs"],
        height_prev=buf["hprev"].to(dtype),
        root_prev=buf["rootp"].to(dtype),
        next_id=buf["next_id"][0],
        frame_nr=frame_nr,
        fb_delay_buffer=fb_final.to(state0.fb_delay_buffer.dtype),
        t_prev_global=t_prev_global.to(state0.t_prev_global.dtype),
    )


def _launch(records, st: dict, p: int, t_slots: int, w: int, cfg):
    """K3 on the card over the frame records [F, bytes]. Returns
    (pred_offset [F, P, K*3], publish [F, P] uint8, ids [F, P] int32,
    n_dropped [F] int32); `st` holds the final state afterwards."""
    plan = scan_plan(p, t_slots, w)
    dev = records.device
    f = records.shape[0]
    off = torch.empty((f, p, 3 * K_JOINTS), dtype=torch.float32, device=dev)
    publish = torch.empty((f, p), dtype=torch.uint8, device=dev)
    ids = torch.empty((f, p), dtype=torch.int32, device=dev)
    n_dropped = torch.empty((f,), dtype=torch.int32, device=dev)
    vel_sig = linalg.constant(skeleton.FUSION_VEL_SIGMAS, dev, torch.float32)
    _kernels.launch(
        "tracker_scan", "ses3d_tracker_scan", dev,
        records.data_ptr(), vel_sig.data_ptr(),
        st["est"].data_ptr(), st["ex"].data_ptr(), st["vel"].data_ptr(),
        st["tprev"].data_ptr(), st["hprev"].data_ptr(), st["rootp"].data_ptr(),
        st["alive"].data_ptr(), st["tid"].data_ptr(), st["nobs"].data_ptr(),
        st["next_id"].data_ptr(),
        off.data_ptr(), publish.data_ptr(), ids.data_ptr(), n_dropped.data_ptr(),
        f, p, t_slots, w, records.shape[1], plan.stages, int(plan.rings_on_chip),
        plan.smem_bytes,
        float(cfg.max_dist), float(cfg.dist_threshold), int(cfg.min_num_obs),
        float(cfg.max_unobserved_time), float(cfg.merge_dist_thresh),
        what=f"tracker_scan launch ({plan})",
    )
    return off, publish, ids, n_dropped


def tracker_scan(state0: TrackerState, persons: Persons3D, pivots, fb_delay,
                 pre, prior_cfg, cfg):
    """The whole offline tracker scan over a stacked sequence.

    `persons` (fusion output), `pivots` [F], `fb_delay` [F, C] and `pre`
    (the stacked `tracking.smooth_cold` output) carry a leading frame axis.
    Returns (final TrackerState, TrackStepOutput stacked over frames), the
    same as `lax.scan(tracking.step(..., precomputed=pre_t))`; `state0` is
    left as it was. CUDA float32 tensors go to kernel K3 (one launch) where
    it takes the shapes (`kernel_takes`), else to the per-frame loop with
    kernel K1; CPU tensors to the plain version.
    """
    dev = persons.xyz.device
    if dev.type == "cpu":
        return tracker_scan_reference(
            state0, persons, pivots, fb_delay, pre, prior_cfg, cfg
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f, p, k_j, _ = persons.xyz.shape
    t_slots = state0.alive.shape[0]
    if not kernel_takes(p, t_slots, k_j):
        return tracker_scan_steps(state0, persons, pivots, fb_delay, pre, prior_cfg,
                                  cfg, hungarian.linear_sum_assignment)
    dtype = persons.xyz.dtype
    if dtype != torch.float32:
        raise TypeError(f"the CUDA tracker-scan kernel takes float32, got {dtype}")
    w = state0.vel_buffer.shape[2]

    g_in, _, xyz_out, cov_out = pre
    has_dets = persons.valid.any(dim=1)
    pred_delta_t, slot_w, dt_glob, fb_final, frame_nr = frame_local_chain(
        state0, has_dets, fb_delay.to(dtype), pivots.to(dtype), cfg
    )
    records = _pack(persons, pre, prior_cfg, pivots.to(dtype), pred_delta_t,
                    dt_glob, slot_w, has_dets)
    st = state_buffers(state0)
    off, publish, ids, n_dropped = _launch(records, st, p, t_slots, w, cfg)

    # Outputs composed as tracking.step composes them from the precomputed
    # smoothing; the kernel owns the sequential decisions and offsets.
    publish = publish > 0
    pred_offset = off.reshape(f, p, k_j, 3).to(dtype)
    pred_noise = cfg.pred_noise_sigma ** 2 * torch.eye(3, dtype=dtype, device=dev)
    cov_pred = torch.where(g_in.active[..., None, None], cov_out + pred_noise, 0.0)
    fused = Persons3D(
        xyz=xyz_out, score=g_in.score_out, cov=cov_out,
        valid=publish, person_id=ids,
    )
    fused_pred = Persons3D(
        xyz=xyz_out + pred_offset, score=g_in.score_out, cov=cov_pred,
        valid=publish, person_id=ids,
    )
    outs = tracking.TrackStepOutput(
        fused=fused,
        fused_pred=fused_pred,
        pred_delta_t=pred_delta_t,
        n_dropped_spawns=n_dropped,
    )
    state = state_from_buffers(st, state0, frame_nr, fb_final, pivots[-1])
    return state, outs
