"""Track management, smoothing and velocity prediction.

Port of the JAX package's tracking.py: the stateful half of the reference
pose_prior node (pose_prior_mult_node.cpp skeletonCallback, :505-921) —
feedback-delay moving average, velocity-normalized track association
through kernel K1 (ops.hungarian), the LM smoother warm-started from each
matched track (or, offline, `smooth_cold` hoisted out of the frame loop),
velocity ring buffers and prediction, spawn / decay / merge, and the
publish gate.

The joint sums that decide an assignment, a gate or a merge (the
association cost and the track distance) accumulate joint by joint in k
order, as the tracker-scan kernel K3 (csrc/tracker_scan.cu) does, so the
kernel and its plain version (ops.tracker.tracker_scan_reference, a loop
of `step`) make the same integer decisions.

`step` is functional: it returns a new TrackerState and never writes into
the one passed in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smartedgesensor3dhumanpose_tpu_torch import prior, skeleton, tracing
from smartedgesensor3dhumanpose_tpu_torch.config import PriorConfig, TrackerConfig
from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian, linalg, loops
from smartedgesensor3dhumanpose_tpu_torch.types import Persons3D, TrackerState

_COST_CLIP = 1.0e3


class TrackStepOutput(NamedTuple):
    fused: Persons3D             # persons3d_fused
    fused_pred: Persons3D        # persons3d_fused_pred
    pred_delta_t: torch.Tensor   # [] predicted feedback latency
    n_dropped_spawns: torch.Tensor  # [] int32 spawns lost to the slot capacity


def _joint_dist(a, b):
    """Euclidean distance over the last axis of 3, as ((x*x + y*y) + z*z)
    under the square root: the order kernel K3 computes it in."""
    d = a - b
    sq = d * d
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])


def _masked_mean_over_joints(dist, ok):
    """Mean of `dist` [..., K] over the joints where `ok`, summed in k order
    (K3's order; a reduction kernel may sum in any order). Returns (mean,
    count); the mean is 0 where the count is 0."""
    acc = torch.zeros(dist.shape[:-1], dtype=dist.dtype, device=dist.device)
    for k in range(dist.shape[-1]):
        acc = acc + torch.where(ok[..., k], dist[..., k], 0.0)
    n = torch.sum(ok, dim=-1)
    return acc / torch.clamp(n, min=1), n


def _association_cost(state: TrackerState, persons: Persons3D, t,
                      cfg: TrackerConfig, prior_cfg: PriorConfig):
    """Detection x track cost [P, T]: mean joint distance normalized by
    per-joint velocity sigma x elapsed time (calc_normed_dist, :84-101)."""
    dtype = persons.xyz.dtype
    vel_sig = linalg.constant(skeleton.FUSION_VEL_SIGMAS, persons.xyz.device, dtype)
    delta_t = (t - state.t_prev)[None, :, None]  # [1, T, 1]
    prev = (
        state.estimate * state.height_prev[:, None, None]
        + state.root_prev[:, None, :]
    )  # [T, K, 3]
    diff_norm = _joint_dist(persons.xyz[:, None], prev[None])  # [P, T, K]
    dist = diff_norm / (vel_sig[None, None] * delta_t)
    ok = (persons.score > prior_cfg.min_score)[:, None, :] & state.est_exists[None]
    mean, n = _masked_mean_over_joints(dist, ok)
    cost = torch.where(n > 0, mean, cfg.max_dist)
    return torch.where(
        persons.valid[:, None] & state.alive[None], cost, cfg.max_dist
    )


def smooth_cold(persons: Persons3D, prior_cfg: PriorConfig):
    """Frame-independent LM smoothing, cold-started from the measurements
    (the JAX package's tracking.smooth_cold).

    The online step warm-starts the LM from each matched track, which ties
    it into the frame loop; the offline replay hoists the smoother out of
    the loop and runs it once over a whole chunk of frames. `persons` may
    carry leading axes (frames): they are flattened into the LM's person
    batch, and every person stops on its own `done` (prior.optimize), so
    the result does not depend on how frames are grouped.

    Returns the `precomputed` tuple (g_in, result, xyz_out, cov_out) that
    `step` accepts, with the leading axes of `persons`.
    """
    batch = persons.valid.shape  # (leading axes..., P)
    flat = Persons3D(*(x.reshape((-1,) + x.shape[len(batch):]) for x in persons))
    g_in = prior.build_graph_inputs(flat, prior_cfg)
    result = prior.optimize(g_in, g_in.meas, prior_cfg)
    xyz_out, cov_out = prior.denormalize(result, g_in, prior_cfg)
    xyz_out = torch.where(g_in.active[..., None], xyz_out, 0.0)
    cov_out = torch.where(g_in.active[..., None, None], cov_out, 0.0)

    def unflat(x):
        return x.reshape(batch + x.shape[1:])

    return (
        prior.GraphInputs(*(unflat(x) for x in g_in)),
        result._replace(
            x=unflat(result.x), marg_cov=unflat(result.marg_cov),
            marg_ok=unflat(result.marg_ok),
        ),
        unflat(xyz_out),
        unflat(cov_out),
    )


def step(state: TrackerState, persons: Persons3D, t, fb_delay,
         prior_cfg: PriorConfig, cfg: TrackerConfig, precomputed=None,
         assign=hungarian.linear_sum_assignment):
    """One tracker frame: `persons` from fusion, `t` the frame (pivot)
    stamp, `fb_delay` [C] measured feedback delays (-1 = unmeasured).

    `precomputed`: this frame's `smooth_cold` output (offline replay); the
    LM then does not run here. With None the LM runs warm-started from the
    tracks (the online path). `assign` solves the track assignment (K1 for
    CUDA tensors by default; the plain tracker scan passes the plain JV).
    Returns (new TrackerState, TrackStepOutput); `state` is left as it was.
    """
    dtype = persons.xyz.dtype
    dev = persons.xyz.device
    p = persons.xyz.shape[0]
    t_slots = state.alive.shape[0]
    w = state.fb_delay_buffer.shape[0]
    t = torch.as_tensor(t, dtype=dtype, device=dev)
    i32 = torch.int32

    # ---- feedback-delay moving average -> prediction horizon (:513-526)
    valid_delay = fb_delay > 0
    n_valid = torch.sum(valid_delay)
    curr_avg = torch.where(
        n_valid > 0,
        torch.sum(torch.where(valid_delay, fb_delay, 0.0)) / torch.clamp(n_valid, min=1),
        cfg.avg_delay,
    ).to(dtype)
    fb_slot = torch.arange(w, device=dev) == (state.frame_nr % w)
    fb_buffer = torch.where(fb_slot, curr_avg, state.fb_delay_buffer)
    pred_delta_t = torch.mean(fb_buffer)

    has_dets = persons.valid.any()

    # ---- association (:548-580). Invalid persons' rows are constant
    # max_dist (clipped), above every real cost and the gate, so their
    # searches are skipped (row_active; sound only with P <= T).
    cost = _association_cost(state, persons, t, cfg, prior_cfg)
    row_hint = persons.valid if t_slots >= p else None
    assignment = assign(
        torch.clamp(cost, max=_COST_CLIP).contiguous(), row_active=row_hint
    ).long()  # [P] -> track slot or -1
    t_ids = torch.arange(t_slots, device=dev)
    has_assign = assignment >= 0
    track_of = assignment.clamp(min=0)
    assigned_cost = torch.where(has_assign, cost.gather(1, track_of[:, None])[:, 0], 0.0)
    gated = (
        has_assign
        & (assigned_cost <= cfg.dist_threshold)
        & (has_assign & state.alive[track_of])
    )
    matched = persons.valid & gated

    # New tracks for unmatched valid persons, in person order (:570-580):
    # spawn p lands in the rank[p]-th dead slot.
    spawn = persons.valid & ~matched
    rank = torch.cumsum(spawn.to(torch.int64), 0) - 1
    dead = ~state.alive
    free_pos = torch.cumsum(dead.to(torch.int64), 0) - 1
    S_free = spawn[:, None] & dead[None, :] & (free_pos[None, :] == rank[:, None])
    new_ok = S_free.any(dim=1)
    slot_new = torch.where(
        new_ok, torch.argmax(S_free.to(i32), dim=1), t_slots
    )
    n_dropped_spawns = (spawn.sum() - new_ok.sum()).to(i32)
    track_idx = torch.where(matched, track_of, torch.where(new_ok, slot_new, t_slots))
    has_track = matched | new_ok

    # Initialize spawned slots: S1[t, p] marks slot t receiving spawn p.
    new_ids = state.next_id.long() + rank
    S1 = slot_new[None, :] == t_ids[:, None]  # [T, P]
    spawned = S1.any(dim=1)
    alive = state.alive | spawned
    track_id = torch.where(
        spawned, torch.sum(torch.where(S1, new_ids[None, :], 0), dim=1),
        state.track_id.long(),
    ).to(i32)
    est = torch.where(spawned[:, None, None], 0.0, state.estimate)
    est_exists = state.est_exists & ~spawned[:, None]
    vel_buf = torch.where(spawned[:, None, None, None], 0.0, state.vel_buffer)
    t_prev = torch.where(spawned, t, state.t_prev)
    num_obs = torch.where(spawned, 0, state.num_obs)
    height_prev = torch.where(spawned, -1.0, state.height_prev)
    root_prev = torch.where(spawned[:, None], 0.0, state.root_prev)
    next_id = (state.next_id + new_ok.sum()).to(i32)

    # ---- per-person graph (+ LM smoothing warm-started from the track)
    if precomputed is None:
        g_in = prior.build_graph_inputs(persons, prior_cfg)
    else:
        g_in = precomputed[0]
    participates = has_track & (g_in.num_meas > 0)  # (:739-741)

    # Each person's previous track state (garbage where no track; masked).
    safe_idx = torch.where(has_track, track_idx, 0)
    prev_est_p = est[safe_idx]
    prev_exists_p = est_exists[safe_idx] & has_track[:, None]
    h_prev_p = height_prev[safe_idx]
    root_prev_p = root_prev[safe_idx]
    uninit = h_prev_p < 0  # (:699-702)
    h_prev_p = torch.where(uninit, g_in.height, h_prev_p)
    root_prev_p = torch.where(uninit[:, None], g_in.root_xyz, root_prev_p)

    use_velocity = g_in.active & prev_exists_p  # (:500)
    if precomputed is None:
        with tracing.child("prior"):
            warm = torch.where(use_velocity[..., None], prev_est_p, g_in.meas)
            result = prior.optimize(g_in, warm, prior_cfg)
            xyz_out, cov_out = prior.denormalize(result, g_in, prior_cfg)
            xyz_out = torch.where(g_in.active[..., None], xyz_out, 0.0)
            cov_out = torch.where(g_in.active[..., None, None], cov_out, 0.0)
    else:
        _, result, xyz_out, cov_out = precomputed

    # ---- velocity buffers + prediction (:818-831)
    dt_glob = torch.clamp(t - state.t_prev_global, min=1e-6)
    curr_world = result.x * g_in.height[:, None, None] + g_in.root_xyz[:, None]
    prev_world = prev_est_p * h_prev_p[:, None, None] + root_prev_p[:, None]
    vel = (curr_world - prev_world) / dt_glob  # [P, K, 3]

    vel_buf_p = vel_buf[safe_idx]  # [P, K, W, 3]
    removed = prev_exists_p & ~g_in.active  # (:490-493)
    vel_buf_p = torch.where(removed[..., None, None], 0.0, vel_buf_p)
    w_slot = (torch.arange(w, device=dev) == (state.frame_nr % w))[:, None]  # [W, 1]
    vel_buf_p = torch.where(
        w_slot & use_velocity[..., None, None], vel[:, :, None, :], vel_buf_p
    )
    mean_vel = torch.mean(vel_buf_p, dim=2)
    pred_offset = torch.where(use_velocity[..., None], mean_vel * pred_delta_t, 0.0)
    xyz_pred = xyz_out + pred_offset
    pred_noise = cfg.pred_noise_sigma ** 2 * torch.eye(3, dtype=dtype, device=dev)
    cov_pred = torch.where(g_in.active[..., None, None], cov_out + pred_noise, 0.0)

    # ---- write back track state (:839-843): slot t takes person p.
    upd = participates & has_dets
    scatter_idx = torch.where(upd, track_idx, t_slots)
    M2 = scatter_idx[None, :] == t_ids[:, None]  # [T, P], one person per slot
    updated = M2.any(dim=1)
    src = torch.argmax(M2.to(i32), dim=1)  # the person writing each slot
    est = torch.where(updated[:, None, None], result.x[src], est)
    est_exists = torch.where(updated[:, None], g_in.active[src], est_exists)
    vel_buf = torch.where(updated[:, None, None, None], vel_buf_p[src], vel_buf)
    t_prev = torch.where(updated, t, t_prev)
    height_prev = torch.where(updated, g_in.height[src], height_prev)
    root_prev = torch.where(updated[:, None], g_in.root_xyz[src], root_prev)
    num_obs = (num_obs + updated.to(i32)).to(i32)

    # Publish gate (:845-848): strictly more than min_num_obs observations.
    obs_after = num_obs[safe_idx]
    publish = upd & (obs_after > cfg.min_num_obs)
    person_ids = torch.where(has_track, track_id[safe_idx], -1).to(i32)

    fused = Persons3D(
        xyz=xyz_out, score=g_in.score_out, cov=cov_out,
        valid=publish, person_id=person_ids,
    )
    fused_pred = Persons3D(
        xyz=xyz_pred, score=g_in.score_out, cov=cov_pred,
        valid=publish, person_id=person_ids,
    )

    # ---- track decay (:191-211)
    alive = alive & ((t - t_prev) <= cfg.max_unobserved_time)

    # ---- merge overlapping tracks (:869-903); skipped on frames without
    # detections (:537-546).
    alive, fused, fused_pred = _merge_tracks(
        alive, track_id, est, est_exists, height_prev, root_prev,
        fused, fused_pred, has_dets, cfg,
    )

    new_state = TrackerState(
        alive=alive,
        track_id=track_id,
        estimate=est,
        est_exists=est_exists,
        vel_buffer=vel_buf,
        t_prev=t_prev,
        num_obs=num_obs,
        height_prev=height_prev,
        root_prev=root_prev,
        next_id=next_id,
        frame_nr=(state.frame_nr + has_dets.to(i32)).to(i32),
        fb_delay_buffer=fb_buffer,
        t_prev_global=t,
    )
    return new_state, TrackStepOutput(
        fused=fused,
        fused_pred=fused_pred,
        pred_delta_t=pred_delta_t,
        n_dropped_spawns=n_dropped_spawns,
    )


def _merge_tracks(alive, track_id, est, est_exists, height_prev, root_prev,
                  fused: Persons3D, fused_pred: Persons3D, has_dets,
                  cfg: TrackerConfig):
    """Remove tracks overlapping an earlier one (mean common-joint distance
    below the threshold, calc_3d_dist :103-119); published persons of a
    removed track take the keeper's id (:892-898).

    The reference's lexicographic pair loop reduces to the recurrence
    surv[j] = alive[j] and no surviving close i < j, solved as a monotone
    fixpoint (see the JAX package's tracking._merge_tracks), as
    `loops.while_loop`: eagerly each round is one host test, in a CUDA
    graph a trip of a WHILE node. Each round settles at least the lowest
    alive slot still unsettled (its close predecessors are all settled),
    so T rounds bound it.
    """
    t_slots = alive.shape[0]
    if t_slots < 2:
        return alive, fused, fused_pred
    idx = torch.arange(t_slots, device=alive.device)
    world = est * height_prev[:, None, None] + root_prev[:, None, :]
    ok = est_exists[:, None] & est_exists[None, :]  # [T, T, K]
    mean_d, n = _masked_mean_over_joints(_joint_dist(world[:, None], world[None]), ok)
    close = (
        (idx[:, None] < idx[None, :])
        & has_dets
        & (n > 0)
        & (mean_d < cfg.merge_dist_thresh)
        & alive[:, None]
        & alive[None, :]
    )  # [T(keeper), T(victim)]

    def settle(carry):
        live, dead = carry
        live = live | (alive & ~(close & ~dead[:, None]).any(dim=0))
        return live, dead | (close & live[:, None]).any(dim=0)

    live, dead = loops.while_loop(
        lambda c: (alive & ~c[0] & ~c[1]).any(), settle,
        (torch.zeros_like(alive), torch.zeros_like(alive)), t_slots,
    )

    kill = close & live[:, None]
    keeper = torch.argmax(kill.to(torch.int32), dim=0)  # first surviving keeper
    keeper_id = track_id[keeper]  # [T(victim)]; gated by `dead` below

    def reassign(pid):
        match = (pid[:, None] == track_id[None, :]) & dead[None, :]  # [P, T]
        victim = torch.argmax(match.to(torch.int32), dim=1)
        return torch.where(match.any(dim=1), keeper_id[victim], pid)

    return (
        alive & ~dead,
        fused._replace(person_id=reassign(fused.person_id)),
        fused_pred._replace(person_id=reassign(fused_pred.person_id)),
    )
