"""The greedy cross-view association: the fold (kernel K2 and its plain
PyTorch version) and the camera scan.

The association (reference skeleton_3d_triang_mult_node.cpp:562-674) visits
the cameras in order and matches each camera's detections against the
hypotheses accumulated from the earlier cameras. Two routes compute it, as
in the JAX package (fusion.associate there; the choice is
fusion.association_route's):

* the fold, the port of the TPU kernel ops/association_pallas.py::
  _assoc_kernel: `associate_fold` launches the CUDA kernel
  (csrc/association_fold.cu) for CUDA tensors and runs
  `associate_fold_reference` for CPU tensors. Both follow the TPU kernel's
  orientation: the JV solve has detections as rows and hypotheses as
  columns, n = max(h_cap, dp) with dp = D rounded up to a multiple of 8,
  and skips unusable detection rows only when h_cap >= dp. In float32 the
  two agree bit for bit. The kernel takes h_cap, dp <= 120; the plain
  version any width;
* the camera scan, the port of the JAX package's fusion._associate_camera
  (fusion.py:96-313) and of the scan branch of its associate: `associate_scan`,
  one camera per step over a batch of frames, the JV of each step (hypotheses
  as rows, detections as columns) one batched `hungarian.
  linear_sum_assignment_batched` call: kernel K1 on the card (its wide
  routine past 120 columns), the plain JV on the CPU. On the card in
  float32 the rest of a step is kernels S1 (the costs, vetoes, mask and
  the solve's input) and S2 (extend or spawn; csrc/scan_step.cu), three
  launches a step in place of `_scan_camera`'s ~115, which the CPU runs
  and which their host build equals bit for bit. It runs at any width K1
  takes and never reads a device value on the host, so it captures.

The two give the same decisions except on exactly tied solver optima (the
tie tiers below make those rare).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from smartedgesensor3dhumanpose_tpu_torch import _kernels
from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian

# Costs fed to the solver are clipped here: every infeasible entry collapses
# onto one tier that still dominates any real epipolar cost.
ASSIGN_COST_CLIP = 1.0e3
# Deterministic tie-break for clipped entries, eps (d+1)(h+1): symmetric
# under transposition, so solvers of either orientation pick the same
# assignment on otherwise tied optima (fusion.py:44-54 of the JAX package).
SOLVER_TIE_EPS = 1.0e-3
# Unusable detection rows sit on a strictly higher tier than valid but
# infeasible pairings.
INVALID_DET_COST = 2.0 * ASSIGN_COST_CLIP

# Shared memory one thread block may hold on an H100 (static + dynamic,
# after the opt-in), an upper bound of K2's static shared memory (the JV
# state, five per-lane arrays, the scan sums, two barriers: ~6.7 KB), and
# the most the kernel spends on its two prefetched table slices.
SMEM_PER_BLOCK = 232_448
STATIC_SMEM_RESERVE = 8_192
PREFETCH_MAX_BYTES = 64 * 1024


class FoldPlan(NamedTuple):
    """K2's shared-memory layout for one launch: whether each camera's
    table slice [C*D, D] is copied on chip during the previous camera step,
    and the dynamic shared memory in bytes."""

    prefetch: bool
    smem_bytes: int


def padded_dets(d: int) -> int:
    """Row count of the fold's solve: D rounded up to a multiple of 8."""
    return max(8, -(-d // 8) * 8)


def fold_smem_bytes(c: int, d: int, h_cap: int, prefetch: bool) -> int:
    """K2's dynamic shared memory (association_fold.cu::fold_smem_bytes):
    the two table slices when prefetching, det_slot [C, 128] int32, the
    frame's flags [C*D] float32 and int32, the solver's cost [dp, n] float32
    and the feasibility mask [dp, 128] bytes."""
    dp = padded_dets(d)
    n_jv = max(h_cap, dp)
    slices = 2 * 4 * c * d * d if prefetch else 0
    return slices + c * 128 * 4 + 2 * c * d * 4 + dp * n_jv * 4 + dp * 128


def _prefetch(c: int, d: int) -> bool:
    """Whether K2 prefetches the table slices: two of them fit in
    PREFETCH_MAX_BYTES and a slice is a whole number of 16-byte units, as
    the bulk copy needs."""
    slice_bytes = 4 * c * d * d
    return slice_bytes % 16 == 0 and 2 * slice_bytes <= PREFETCH_MAX_BYTES


def fold_plan(c: int, d: int, h_cap: int) -> FoldPlan:
    """The layout K2 takes at these shapes (`_prefetch`); raise if even the
    fold's state does not fit in a block."""
    prefetch = _prefetch(c, d)
    smem = fold_smem_bytes(c, d, h_cap, prefetch)
    budget = SMEM_PER_BLOCK - STATIC_SMEM_RESERVE
    if smem > budget:
        raise ValueError(
            f"the fold kernel needs {smem} bytes of shared memory at cameras={c}, "
            f"detections={d}, h_cap={h_cap}; a block holds {budget}"
        )
    return FoldPlan(prefetch, smem)


def fold_fits(c: int, d: int, h_cap: int) -> bool:
    """Whether kernel K2 takes these shapes: h_cap and the padded detection
    count within the JV's register width (hungarian.MAX_N) and the fold's
    state within a block's shared memory (`fold_plan`)."""
    return (max(h_cap, padded_dets(d)) <= hungarian.MAX_N
            and fold_smem_bytes(c, d, h_cap, _prefetch(c, d))
            <= SMEM_PER_BLOCK - STATIC_SMEM_RESERVE)


def associate_fold_reference(ctab, conf_obs, det_ok, h_cap, gate, max_cost):
    """Plain PyTorch fold of one frame.

    Args:
      ctab: [C, C*D, D] per-observation cost of observation (c1, d1) (row
        c1*D + d1) against detection d2 of camera c (first axis); -1 where
        the pair is unusable (no shared confident joint, or c1 >= c).
      conf_obs: [C*D] confident-voter flags (score > 0.5) as 0/1 floats.
      det_ok: [C, D] bool usable detections.
      h_cap: hypothesis slots; gate: max_epipolar_error; max_cost: MAX_COSTS.

    Returns (det_slot [h_cap, C] int32, -1 where unobserved; n_hyp [] int32;
    n_dropped [] int32).
    """
    dev, dt = ctab.device, ctab.dtype
    c_cams, x_len, d = ctab.shape
    dp = padded_dets(d)
    n_jv = max(h_cap, dp)
    ct_all = ctab.reshape(c_cams, c_cams, d, d)  # [c, c1, d1, d2]
    conf = conf_obs.reshape(c_cams, d)
    hyps = torch.arange(h_cap, device=dev)
    dets = torch.arange(dp, device=dev)
    det_slot = torch.full((h_cap, c_cams), -1, dtype=torch.int64, device=dev)
    n_hyp = torch.zeros((), dtype=torch.int64, device=dev)
    n_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    pad = torch.full((h_cap, dp - d), -1.0, dtype=dt, device=dev)

    for c in range(c_cams):
        dok = torch.zeros(dp, dtype=torch.bool, device=dev)
        dok[:d] = det_ok[c]
        n_obs = (det_slot >= 0).sum(dim=1)  # [H]
        total = torch.zeros((h_cap, dp), dtype=dt, device=dev)
        n_used = torch.zeros_like(total)
        votes_all = torch.zeros_like(total)
        votes_conf = torch.zeros_like(total)
        # Sum over the hypotheses' observations in camera order, as the
        # kernel does (unobserved cameras add exact zeros).
        for c1 in range(c_cams):
            s1 = det_slot[:, c1]
            on = (s1 >= 0)[:, None]
            s1c = s1.clamp(min=0)
            row = torch.cat([ct_all[c, c1][s1c], pad], dim=1)  # [H, dp]
            row = torch.where(on, row, -1.0)
            usable = row >= 0
            total = total + torch.where(usable, row, 0.0)
            n_used = n_used + usable.to(dt)
            big = row > gate
            votes_all = votes_all + big.to(dt)
            votes_conf = votes_conf + torch.where(big, conf[c1][s1c][:, None], 0.0)

        cost = total / torch.clamp(n_used, min=1.0)
        n_obs_f = torch.clamp(n_obs, min=1).to(dt)[:, None]
        n_votes = torch.where((n_obs == 1)[:, None], votes_all, votes_conf)
        veto = n_votes / n_obs_f > 1.0 - 1.0 / (2.0 * n_obs_f)
        bad = (n_used < 0.5) | (n_obs == 0)[:, None] | ~dok[None, :]
        cost = torch.where(bad, max_cost, cost)
        veto = veto | bad
        mask = ~veto & (cost < gate)  # [H, dp] feasible pairings

        # Solve only when a detection or hypothesis has more than one
        # feasible pairing (reference :628); else the mask is the answer.
        need = bool((mask.sum(0) > 1).any() | (mask.sum(1) > 1).any())
        if need:
            tie = (SOLVER_TIE_EPS * (dets + 1).to(dt))[None, :] * (hyps + 1).to(dt)[:, None]
            clipped = torch.clamp(cost, max=ASSIGN_COST_CLIP)
            tiered = torch.where(
                clipped >= ASSIGN_COST_CLIP, ASSIGN_COST_CLIP + tie, clipped
            )
            tiered = torch.where(dok[None, :], tiered, INVALID_DET_COST)
            jv = torch.zeros((dp, n_jv), dtype=dt, device=dev)
            jv[:, :h_cap] = tiered.T
            roc = hungarian._jv_plain(
                jv, n_jv, dp, dok if h_cap >= dp else None
            )[:h_cap]
            assign = torch.where((roc >= 0) & (roc < d), roc, -1)
        else:
            first = torch.argmax(mask.to(torch.int32), dim=1)
            assign = torch.where(mask.any(dim=1), first, -1)

        # Extend or spawn (reference :636-673).
        has = assign >= 0
        a0 = assign.clamp(min=0)
        assigned_valid = has & dok[a0]
        pair_ok = has & mask[hyps, a0]
        extend = assigned_valid & pair_ok
        spawn_from_hyp = assigned_valid & ~pair_ok
        handled = torch.zeros(dp, dtype=torch.bool, device=dev)
        handled[a0[assigned_valid]] = True
        spawn_unhandled = dok & ~handled

        # Solver spawns in hypothesis order, then unhandled detections in
        # detection order.
        slot1 = n_hyp + torch.cumsum(spawn_from_hyp.to(torch.int64), 0) - 1
        n1 = n_hyp + spawn_from_hyp.sum()
        slot2 = n1 + torch.cumsum(spawn_unhandled.to(torch.int64), 0) - 1
        n2 = n1 + spawn_unhandled.sum()
        dts = torch.full((dp,), -1, dtype=torch.int64, device=dev)
        dts[a0[spawn_from_hyp]] = slot1[spawn_from_hyp]
        dts = torch.where(spawn_unhandled, slot2, dts)
        lands = (dts >= 0) & (dts < h_cap)
        slot_det = torch.full((h_cap,), -1, dtype=torch.int64, device=dev)
        slot_det[dts[lands]] = dets[lands]

        det_slot[:, c] = torch.where(extend, assign, slot_det)
        n_dropped = n_dropped + torch.clamp(n2 - h_cap, min=0)
        n_hyp = torch.clamp(n2, max=h_cap)

    return (
        det_slot.to(torch.int32),
        n_hyp.to(torch.int32),
        n_dropped.to(torch.int32),
    )


def _launch(ctab, conf_obs, det_ok, h_cap, gate, max_cost):
    """K2 on the card for a batch of frames: ctab [B, C, C*D, D]."""
    if ctab.dtype != torch.float32:
        raise TypeError(f"the CUDA fold kernel takes float32, got {ctab.dtype}")
    b, c, x_len, d = ctab.shape
    if x_len != c * d or conf_obs.shape != (b, c * d) or det_ok.shape != (b, c, d):
        raise ValueError(
            "fold shapes: ctab [B, C, C*D, D], conf_obs [B, C*D], det_ok "
            f"[B, C, D]; got {tuple(ctab.shape)}, {tuple(conf_obs.shape)}, "
            f"{tuple(det_ok.shape)}"
        )
    if max(h_cap, padded_dets(d)) > hungarian.MAX_N:
        raise ValueError(f"fold supports h_cap, dp <= {hungarian.MAX_N}")
    for name, tensor in (("conf_obs", conf_obs), ("det_ok", det_ok)):
        if tensor.device != ctab.device:
            raise ValueError(f"{name} is on {tensor.device}, ctab on {ctab.device}")
    ctab = ctab.contiguous()
    conf = conf_obs.to(torch.float32).contiguous()
    dok = det_ok.to(torch.int32).contiguous()
    # The bulk copies read the table from 16-byte aligned addresses only.
    prefetch = fold_plan(c, d, h_cap).prefetch and ctab.data_ptr() % 16 == 0
    smem = fold_smem_bytes(c, d, h_cap, prefetch)
    det_slot = torch.empty((b, h_cap, c), dtype=torch.int32, device=ctab.device)
    counts = torch.empty((b, 2), dtype=torch.int32, device=ctab.device)
    _kernels.launch(
        "association_fold", "ses3d_association_fold", ctab.device,
        ctab.data_ptr(), conf.data_ptr(), dok.data_ptr(), det_slot.data_ptr(),
        counts.data_ptr(), b, c, d, h_cap, int(prefetch), smem,
        float(gate), float(max_cost),
        what=f"association_fold launch (prefetch={prefetch}, smem={smem})",
    )
    return det_slot, counts[:, 0], counts[:, 1]


def associate_fold(ctab, conf_obs, det_ok, h_cap, gate, max_cost):
    """The fold of one frame (shapes as in `associate_fold_reference`):
    kernel K2 for CUDA tensors, the plain version for CPU tensors."""
    if ctab.device.type == "cpu":
        return associate_fold_reference(ctab, conf_obs, det_ok, h_cap, gate, max_cost)
    if ctab.device.type != "cuda":
        raise ValueError(f"unsupported device {ctab.device}")
    ds, nh, nd = _launch(
        ctab[None], conf_obs[None], det_ok[None], h_cap, gate, max_cost
    )
    return ds[0], nh[0], nd[0]


def associate_fold_batched_reference(ctab, conf_obs, det_ok, h_cap, gate,
                                     max_cost):
    """Plain PyTorch fold of B frames, frame by frame (shapes as in
    `associate_fold_batched`)."""
    outs = [
        associate_fold_reference(ctab[i], conf_obs[i], det_ok[i], h_cap, gate, max_cost)
        for i in range(ctab.shape[0])
    ]
    return tuple(torch.stack(x) for x in zip(*outs))


def associate_fold_batched(ctab, conf_obs, det_ok, h_cap, gate, max_cost):
    """The fold of B frames, one thread block per frame on the card:
    ctab [B, C, C*D, D], conf_obs [B, C*D], det_ok [B, C, D] ->
    (det_slot [B, h_cap, C], n_hyp [B], n_dropped [B])."""
    if ctab.device.type == "cpu":
        return associate_fold_batched_reference(
            ctab, conf_obs, det_ok, h_cap, gate, max_cost
        )
    if ctab.device.type != "cuda":
        raise ValueError(f"unsupported device {ctab.device}")
    return _launch(ctab, conf_obs, det_ok, h_cap, gate, max_cost)


def _scan_camera(det_slot, n_hyp, n_dropped, ctab_c, conf_obs, det_ok, c,
                 gate, max_cost):
    """One step of the camera scan: fold camera c's detections into the
    hypotheses of a batch of frames (the JAX package's
    fusion._associate_camera). det_slot [B, H, C] int64 (-1 where
    unobserved), n_hyp and n_dropped [B] int64, ctab_c [B, C*D, D],
    conf_obs [B, C*D], det_ok [B, D] bool. Returns the three updated."""
    b, h, c_cams = det_slot.shape
    d = det_ok.shape[1]
    dev, dt = ctab_c.device, ctab_c.dtype
    observed = det_slot >= 0  # [B, H, C]
    # Each hypothesis' observation rows (c1 * D + d1) of the pair-cost table:
    # one gather, unobserved cameras read as the -1 sentinel.
    rows = (torch.arange(c_cams, device=dev) * d + det_slot.clamp(min=0)).reshape(b, h * c_cams)
    obs = torch.gather(ctab_c, 1, rows[..., None].expand(b, h * c_cams, d))
    obs = torch.where(observed[..., None], obs.reshape(b, h, c_cams, d), -1.0)
    conf = torch.gather(conf_obs, 1, rows).reshape(b, h, c_cams)
    usable = obs >= 0
    big = obs > gate
    # The mean per-observation cost over observations sharing joints
    # (:344-366), summed in camera order as the fold sums it; the counts are
    # exact in any order.
    total = torch.zeros((b, h, d), dtype=dt, device=dev)
    for c1 in range(c_cams):
        total = total + torch.where(usable[:, :, c1], obs[:, :, c1], 0.0)
    n_used = usable.sum(dim=2).to(dt)
    votes_all = big.sum(dim=2).to(dt)
    votes_conf = torch.where(big, conf[..., None], 0.0).sum(dim=2)
    n_obs = observed.sum(dim=2)  # [B, H]
    cost = total / torch.clamp(n_used, min=1.0)
    # Vetoes (:344-381): only confident observations vote, except the lone
    # observation of a one-observation hypothesis; each adds 1 / n_obs.
    n_votes = torch.where((n_obs == 1)[..., None], votes_all, votes_conf)
    n_obs_f = torch.clamp(n_obs, min=1).to(dt)[..., None]
    veto = n_votes / n_obs_f > 1.0 - 1.0 / (2.0 * n_obs_f)
    unusable = (n_used < 0.5) | (n_obs == 0)[..., None]
    cost = torch.where(unusable, max_cost, cost)
    veto = veto | unusable
    ok = det_ok[:, None, :]
    cost = torch.where(ok, cost, max_cost)
    veto = veto | ~ok
    mask = ~veto & (cost < gate)  # [B, H, D] feasible pairings

    # Solve where a detection or hypothesis has more than one feasible
    # pairing (:628); elsewhere the mask is the unique assignment. The solve
    # runs for every frame (on a trivial matrix where its answer is
    # discarded), so no host test decides anything. A discarded problem
    # turns all its rows off: it runs the row reduction and no search (with
    # H > D its rows would otherwise chase the dummy columns, O(H^2) steps);
    # a needed one keeps all its rows, as with no mask.
    need = ((mask.sum(dim=1) > 1).any(dim=1) | (mask.sum(dim=2) > 1).any(dim=1))
    from_mask = torch.where(mask.any(dim=2), torch.argmax(mask.to(torch.int32), dim=2), -1)
    hyps = torch.arange(h, device=dev)
    dets = torch.arange(d, device=dev)
    # Infeasible entries on the clip tier plus eps (h+1)(d+1); unusable
    # detections on a higher tier.
    tie = SOLVER_TIE_EPS * (hyps + 1).to(dt)[:, None] * (dets + 1).to(dt)[None, :]
    clipped = torch.clamp(cost, max=ASSIGN_COST_CLIP)
    tiered = torch.where(clipped >= ASSIGN_COST_CLIP, ASSIGN_COST_CLIP + tie, clipped)
    tiered = torch.where(ok, tiered, INVALID_DET_COST)
    trivial = (hyps[:, None] != dets[None, :]).to(dt)
    solved = hungarian.linear_sum_assignment_batched(
        torch.where(need[:, None, None], tiered, trivial).contiguous(),
        need[:, None].expand(b, h),
    )
    assign = torch.where(need[:, None], solved.to(torch.int64), from_mask)  # [B, H]

    # Extend or spawn (reference :636-673): an assigned valid detection
    # extends the hypothesis if the pairing is feasible and spawns a new one
    # otherwise; unassigned valid detections spawn too.
    A = assign[..., None] == dets  # [B, H, D]
    assigned_valid = (A & ok).any(dim=2)
    pair_ok = (A & mask).any(dim=2)
    extend = assigned_valid & pair_ok
    spawn_from_hyp = assigned_valid & ~pair_ok
    handled = (A & assigned_valid[..., None]).any(dim=1)  # [B, D]
    spawn_unhandled = det_ok & ~handled
    # Solver spawns in hypothesis order, then unhandled detections in
    # detection order.
    slot1 = n_hyp[:, None] + torch.cumsum(spawn_from_hyp.to(torch.int64), 1) - 1
    n1 = n_hyp + spawn_from_hyp.sum(dim=1)
    slot2 = n1[:, None] + torch.cumsum(spawn_unhandled.to(torch.int64), 1) - 1
    n2 = n1 + spawn_unhandled.sum(dim=1)
    det_to_slot = torch.where(A & spawn_from_hyp[..., None], slot1[..., None], -1).amax(dim=1)
    det_to_slot = torch.where(spawn_unhandled, slot2, det_to_slot)  # [B, D]
    S = det_to_slot[:, None, :] == hyps[None, :, None]  # [B, H, D]
    spawn_on = S.any(dim=2)
    spawn_det = torch.where(S, dets, 0).sum(dim=2)
    det_of_hyp = torch.where(A, dets, 0).sum(dim=2)
    col = torch.where(extend, det_of_hyp, torch.where(spawn_on, spawn_det, det_slot[:, :, c]))
    cam = torch.arange(c_cams, device=dev) == c
    det_slot = torch.where(cam, col[..., None], det_slot)
    # n_hyp was clipped to h already, so this step's overflow is n2 - h.
    return det_slot, torch.clamp(n2, max=h), n_dropped + torch.clamp(n2 - h, min=0)


class ScanStep(ctypes.Structure):
    """csrc/scan_step.cu `Step`, field by field: one camera step's inputs,
    carry and outputs (pointers) and its shapes and settings."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "ctab", "conf", "det_ok", "tier", "trivial", "det_slot", "n_obs", "n_hyp",
        "n_dropped", "cost", "row_active", "mask", "from_mask", "need", "solved")] + [
        (name, ctypes.c_int) for name in ("b", "h", "c", "d", "cam")] + [
        (name, ctypes.c_float) for name in ("gate", "max_cost", "clip", "invalid")]


# What S1 and S2 take (csrc/scan_step.cu): detections a camera, and S1's
# tiered costs of a frame in shared memory (H x D floats in 48 KB).
SCAN_MAX_DETS = 128
SCAN_MAX_SLOTS = 12 * 1024


def scan_kernels_take(h_cap: int, d: int) -> bool:
    """Whether kernels S1 and S2 take a scan of h_cap slots and d detections."""
    return d <= SCAN_MAX_DETS and h_cap * d <= SCAN_MAX_SLOTS


def associate_scan_kernels(ctab, conf_obs, det_ok, h_cap, gate, max_cost, host=False):
    """`associate_scan` with each step's costs and extend-or-spawn as kernels
    S1 and S2 (csrc/scan_step.cu) around the step's batched JV: on the card
    for float32 CUDA tensors, or (`host`) their host build with the plain
    JV for float32 CPU tensors, the tests' handle on their arithmetic.
    Shapes and results as `associate_scan`'s."""
    b, c_cams, _, d = ctab.shape
    dev = ctab.device
    if ctab.dtype != torch.float32 or (dev.type == "cuda") == host:
        raise ValueError(f"the scan kernels take float32 {'CPU' if host else 'CUDA'} tensors; "
                         f"got {ctab.dtype} on {dev}")
    f32, i64 = torch.float32, torch.int64
    ctab = ctab.contiguous()
    conf = conf_obs.to(f32).contiguous()
    dok = det_ok.to(torch.bool).contiguous()
    hyps = torch.arange(h_cap, device=dev)
    dets = torch.arange(d, device=dev)
    tie = SOLVER_TIE_EPS * (hyps + 1).to(f32)[:, None] * (dets + 1).to(f32)[None, :]
    tier = (ASSIGN_COST_CLIP + tie).contiguous()
    trivial = (hyps[:, None] != dets[None, :]).to(f32)
    det_slot = torch.full((b, h_cap, c_cams), -1, dtype=i64, device=dev)
    n_obs = torch.zeros((b, h_cap), dtype=i64, device=dev)
    n_hyp = torch.zeros(b, dtype=i64, device=dev)
    n_dropped = torch.zeros(b, dtype=i64, device=dev)
    cost = torch.empty((b, h_cap, d), dtype=f32, device=dev)
    row_active = torch.empty((b, h_cap), dtype=torch.bool, device=dev)
    mask = torch.empty((b, h_cap, d), dtype=torch.bool, device=dev)
    from_mask = torch.empty((b, h_cap), dtype=i64, device=dev)
    need = torch.empty(b, dtype=torch.bool, device=dev)
    step = ScanStep(*(t.data_ptr() for t in (
        ctab, conf, dok, tier, trivial, det_slot, n_obs, n_hyp, n_dropped, cost, row_active,
        mask, from_mask, need)), None, b, h_cap, c_cams, d, 0, gate, max_cost,
        ASSIGN_COST_CLIP, INVALID_DET_COST)

    def run(name: str, what: str) -> None:
        if host:
            entry = getattr(_kernels.host_library(), f"ses3d_{name}_host")
            _kernels.check(entry(ctypes.byref(step)), what)
        else:
            _kernels.launch(name, f"ses3d_{name}", dev, ctypes.byref(step), what=what)

    for cam in range(c_cams):
        step.cam = cam
        run("scan_costs", f"scan costs launch (camera {cam})")
        solved = hungarian.linear_sum_assignment_batched(cost, row_active)
        step.solved = solved.data_ptr()
        run("scan_extend", f"scan extend launch (camera {cam})")
    return det_slot.to(torch.int32), n_hyp.to(torch.int32), n_dropped.to(torch.int32)


def associate_scan(ctab, conf_obs, det_ok, h_cap, gate, max_cost):
    """The camera scan over a batch of frames (the JAX package's scan branch
    of fusion.associate, its cameras unrolled): ctab [B, C, C*D, D],
    conf_obs [B, C*D], det_ok [B, C, D] -> (det_slot [B, h_cap, C] int32,
    n_hyp [B] int32, n_dropped [B] int32), as `associate_fold_batched`.
    One batched JV per camera: kernel K1 for CUDA tensors, the plain JV for
    CPU tensors; on the card in float32 the rest of each step is kernels
    S1 and S2 (`associate_scan_kernels`) where they take the shapes."""
    if (ctab.is_cuda and ctab.dtype == torch.float32
            and scan_kernels_take(h_cap, ctab.shape[-1])):
        return associate_scan_kernels(ctab, conf_obs, det_ok, h_cap, gate, max_cost)
    b, c_cams = ctab.shape[:2]
    dev = ctab.device
    det_slot = torch.full((b, h_cap, c_cams), -1, dtype=torch.int64, device=dev)
    n_hyp = torch.zeros(b, dtype=torch.int64, device=dev)
    n_dropped = torch.zeros(b, dtype=torch.int64, device=dev)
    for c in range(c_cams):
        det_slot, n_hyp, n_dropped = _scan_camera(
            det_slot, n_hyp, n_dropped, ctab[:, c], conf_obs, det_ok[:, c], c,
            gate, max_cost,
        )
    return det_slot.to(torch.int32), n_hyp.to(torch.int32), n_dropped.to(torch.int32)
