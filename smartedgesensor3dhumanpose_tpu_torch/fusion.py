"""Multi-view fusion: cross-view association + triangulation.

Port of the JAX package's fusion.py, the reference skeleton_3d node's hot
path (skeleton_3d_triang_mult_node.cpp triangulate_persons, :525-997):

* the greedy association over cameras (:562-674), routed by shape as the
  JAX package routes it (`association_route`): the fold, kernel K2
  (ops.association) on the card, one launch for a whole chunk of frames
  (`fuse_frames`; the online `fuse_frame` is a chunk of one), or the
  camera scan, one batched JV (kernel K1) per camera; either reads the
  table of pair costs, written by kernel E1 (ops.epipolar) on the card in
  float32, one launch a chunk (`pair_costs_route`),
* confidence-weighted DLT with 3-view / leave-one-out outlier rejection
  (:676-844), every leave-one-out variant computed as one batch axis, the
  unscented 3D covariance (:508-523) and the limb, root and feet gates,
  routed by device, dtype and shape (`triangulation_route`): kernel F1
  (ops.triangulation_kernel) on the card in float32, one launch for all
  of a chunk's hypotheses (its wide variant past 91 cameras), else the
  plain PyTorch body,
* the pairwise skeleton merge (:984-996).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch import cameras as cameras_lib
from smartedgesensor3dhumanpose_tpu_torch import skeleton, tracing
from smartedgesensor3dhumanpose_tpu_torch.config import FusionConfig
from smartedgesensor3dhumanpose_tpu_torch.ops import (
    association,
    covariance,
    epipolar,
    hungarian,
    linalg,
    triangulation,
    triangulation_kernel,
)
from smartedgesensor3dhumanpose_tpu_torch.types import CameraRig, Frame, Persons3D


class HypothesisSet(NamedTuple):
    """Fixed-slot person hypotheses accumulated across cameras: slot h
    observes camera c iff cam_mask[h, c] (reference PersonHypothesis,
    :153-159). Fields may carry a leading frame axis."""

    kp: torch.Tensor         # [H, C, J, 3] normalized keypoints (x, y, conf)
    cov: torch.Tensor        # [H, C, J, 3] packed normalized covariance
    cam_mask: torch.Tensor   # [H, C] bool
    obs_score: torch.Tensor  # [H, C] per-observation person score
    n_hyp: torch.Tensor      # [] int32 live hypothesis count
    n_dropped: torch.Tensor  # [] int32 spawns lost to the slot capacity


# The most bytes one of the plain pair costs' per-joint terms ([frames,
# C(C-1)/2, J, D, D] float32) may take: a chunk of frames whose would take
# more computes them a slice of frames at a time (the 480-camera dome's
# take ~0.5 GB a frame; the demo's 0.5 MB). Kernel E1 keeps no such terms.
FOLD_INPUT_BYTES = 1 << 30


def pair_costs_route(device, dtype) -> str:
    """The pair costs' route for these tensors: "kernel" on CUDA in float32
    (kernel E1, `epipolar.pair_costs`: the whole table in one launch), else
    "plain" (`pair_costs_plain`)."""
    on_card = torch.device(device).type == "cuda" and dtype == torch.float32
    return "kernel" if on_card else "plain"


def pair_costs_plain(kp_n, F, min_kp_score: float):
    """Kernel E1's plain twin: `epipolar.pairwise_association_costs_packed`
    (the per-joint terms of `pair_terms_plain` summed by torch.sum) of every
    camera pair c1 < c2, scattered into ctab [..., C2, C1*D1, D2], -1 where
    unusable and for c1 >= c2. kp_n [..., C, D, J, 3]; one leading axis is
    taken in slices of frames whose terms fit FOLD_INPUT_BYTES."""
    c, d, j = kp_n.shape[-4], kp_n.shape[-3], kp_n.shape[-2]
    lead = kp_n.shape[:-4]
    ctab = torch.full(lead + (c, c, d, d), -1.0, dtype=kp_n.dtype, device=kp_n.device)
    per_frame = max(c * (c - 1) // 2 * j * d * d * kp_n.element_size(), 1)
    sliced = len(lead) == 1
    step = max(1, FOLD_INPUT_BYTES // per_frame) if sliced else 1
    for lo in range(0, lead[0] if sliced else 1, step):
        part = slice(lo, lo + step) if sliced else slice(None)
        cost_p, usable_p, iu, ju = epipolar.pairwise_association_costs_packed(
            kp_n[part], F, min_kp_score
        )
        ctab[part][..., ju, iu, :, :] = torch.where(usable_p, cost_p, -1.0)
    return ctab.reshape(lead + (c, c * d, d))


def fold_inputs(kp_n, det_score, rig: CameraRig, config: FusionConfig):
    """The association fold's inputs: the per-observation epipolar costs
    between every detection pair, computed once per frame and packed as
    ctab [..., C2, C1*D1, D2] (-1 where unusable, including c1 >= c2), and
    the confident-voter flags conf_obs [..., C*D] (score > 0.5, :352).
    kp_n [..., C, D, J, 3]: leading axes (frames) pass through. The table
    comes by `pair_costs_route`: kernel E1 in one launch, or its plain twin.
    A traced call counts the frames E1 wrote (`association.pair_costs_e1`,
    0 on the plain route)."""
    c, d = kp_n.shape[-4], kp_n.shape[-3]
    lead = kp_n.shape[:-4]
    route = pair_costs_route(kp_n.device, kp_n.dtype)
    if route == "kernel":
        ctab = epipolar.pair_costs(kp_n, rig.F, config.min_kp_score)
    else:
        ctab = pair_costs_plain(kp_n, rig.F, config.min_kp_score)
    tracing.note("association.pair_costs_e1", math.prod(lead) if route == "kernel" else 0)
    conf_obs = (det_score > 0.5).to(kp_n.dtype).reshape(lead + (c * d,))
    return ctab, conf_obs


def association_route(config: FusionConfig, cameras: int, dets: int) -> str:
    """The association's route for these shapes, as the JAX package's
    fusion.associate picks it (see config.py): "fold" (kernel K2 on the
    card, its plain version on the CPU), "reference" (the plain fold on any
    device) or "scan" (the camera scan). It depends on the config and the
    shapes only, so a `Pipeline` decides it once, at construction; a
    "pallas_scan" (or "kernel") outside K2's domain raises here.

    "auto" takes the fold where K2 takes the shapes (hypothesis slots and
    padded detections <= 120, the fold's shared memory within a block),
    else the scan: JAX's TPU rule (fusion.py:373) at the port's kernel
    widths.
    """
    impl = config.assignment_impl
    fits = association.fold_fits(cameras, dets, config.max_hypotheses)
    if impl == "auto":
        return "fold" if fits else "scan"
    if impl in ("pallas_scan", "kernel"):
        if not fits:
            raise ValueError(
                f"assignment_impl={impl!r} is the association fold, whose kernel "
                f"takes hypothesis slots and padded detections <= "
                f"{hungarian.MAX_N} within a block's shared memory; got "
                f"cameras={cameras}, detections={dets}, "
                f"max_hypotheses={config.max_hypotheses}. Use 'auto' or 'cond_while'."
            )
        return "fold"
    if impl in ("cond_while", "pallas", "unrolled"):
        return "scan"
    if impl == "reference":
        return "reference"
    raise ValueError(f"unknown assignment_impl {impl!r}")


def associate(kp_n, cov_n, det_score, det_ok, rig: CameraRig,
              config: FusionConfig) -> HypothesisSet:
    """Greedy cross-view association over all cameras of a chunk of frames,
    by `association_route`: the fold (one launch for the chunk) or the
    camera scan (one batched JV per camera); either only gathers the
    precomputed pair costs by the hypotheses' observation identities.

    kp_n, cov_n: [B, C, D, J, 3]; det_score [B, C, D]; det_ok [B, C, D]
    bool; a HypothesisSet with the same leading frame axis comes back. One
    frame without that axis gives one HypothesisSet without it. A traced
    call counts the camera steps of the scan (`association.scan_steps`, 0
    on the fold).
    """
    if kp_n.dim() == 4:
        hyps = associate(kp_n[None], cov_n[None], det_score[None], det_ok[None],
                         rig, config)
        return HypothesisSet(*(x[0] for x in hyps))
    ctab, conf_obs = fold_inputs(kp_n, det_score, rig, config)
    route = association_route(config, kp_n.shape[1], kp_n.shape[2])
    tracing.note("association.scan_steps", kp_n.shape[1] if route == "scan" else 0)
    fold = {
        "fold": association.associate_fold_batched,
        "reference": association.associate_fold_batched_reference,
        "scan": association.associate_scan,
    }[route]
    det_slot, n_hyp, n_dropped = fold(
        ctab, conf_obs, det_ok, config.max_hypotheses,
        config.max_epipolar_error, config.max_cost,
    )
    return _gather_hypotheses(det_slot, n_hyp, n_dropped, kp_n, cov_n, det_score)


def _gather_hypotheses(det_slot, n_hyp, n_dropped, kp_n, cov_n, det_score):
    """Select each (frame, hypothesis, camera) slot's detection data:
    det_slot [B, H, C], kp_n [B, C, D, J, 3]."""
    on = det_slot >= 0  # [B, H, C]
    b, _, c = det_slot.shape
    frames = torch.arange(b, device=det_slot.device)[:, None, None]
    cams = torch.arange(c, device=det_slot.device)
    sel = det_slot.clamp(min=0).long()
    unobserved = linalg.constant([0.0, 0.0, -1.0], kp_n.device, kp_n.dtype)
    kp = torch.where(on[..., None, None], kp_n[frames, cams, sel], unobserved)
    cov = torch.where(on[..., None, None], cov_n[frames, cams, sel], 0.0)
    obs_score = torch.where(on, det_score[frames, cams, sel], 0.0)
    return HypothesisSet(
        kp=kp, cov=cov, cam_mask=on, obs_score=obs_score,
        n_hyp=n_hyp, n_dropped=n_dropped,
    )


def _select_outlier_drops(err0, k, rem_d2, idx3, loo_err, view_mask,
                          config: FusionConfig):
    """Which view (if any) to drop per joint (:748-838); -1 = none.

    Exactly 3 views: drop the view whose removal leaves the smallest pair
    distance, if it beats err0^2. 4+ views: the leave-one-out solution with
    the smallest error among those at least 10% better than err0.
    """
    big = 3.0e38
    thresh = config.reproj_error_max_acceptable
    slot3 = torch.argmin(rem_d2, dim=-1, keepdim=True)
    best3 = torch.take_along_dim(idx3, slot3, dim=-1)[..., 0]
    best3_val = torch.take_along_dim(rem_d2, slot3, dim=-1)[..., 0]
    drop3 = torch.where(best3_val < err0 * err0, best3, -1)

    cand = view_mask & (loo_err < 0.9 * err0[..., None])
    loo_masked = torch.where(cand, loo_err, big)
    best4 = torch.argmin(loo_masked, dim=-1)
    drop4 = torch.where(cand.any(dim=-1), best4, -1)

    over = err0 > thresh
    return torch.where(
        over & (k == 3), drop3, torch.where(over & (k >= 4), drop4, -1)
    )


def triangulation_route(cameras: int, device, dtype) -> str:
    """The triangulation's route for these tensors: on CUDA in float32
    "kernel" (F1) where the rig's cameras fit its shared memory
    (triangulation_kernel.fits), "wide" (F1's wide variant) where they fit
    that (fits_wide), else "plain" (the CPU, float64, wider rigs). It
    depends on what a `Pipeline` knows at construction only: the device,
    the rig's dtype and the camera count."""
    if torch.device(device).type != "cuda" or dtype != torch.float32:
        return "plain"
    if triangulation_kernel.fits(cameras):
        return "kernel"
    return "wide" if triangulation_kernel.fits_wide(cameras) else "plain"


def triangulate_hypotheses(hyps: HypothesisSet, rig: CameraRig,
                           config: FusionConfig) -> Persons3D:
    """Triangulate every hypothesis into a 21-joint fusion skeleton: view
    masks, weighted DLT, outlier rejection, score down-weighting, UT
    covariance, limb inflation and root/feet gates (:676-982). Kernel F1
    or its wide variant (one launch for the batch) where
    `triangulation_route` takes them, else the plain body; a traced call
    counts the hypotheses each triangulates (`triangulation.f1`,
    `triangulation.f1w`; 0 off its route)."""
    h, c = hyps.cam_mask.shape
    route = triangulation_route(c, hyps.kp.device, hyps.kp.dtype)
    tracing.note("triangulation.f1", h if route == "kernel" else 0)
    tracing.note("triangulation.f1w", h if route == "wide" else 0)
    if route in ("kernel", "wide"):
        return triangulation_kernel.triangulate(
            hyps.kp, hyps.cov, hyps.cam_mask, rig.P.to(torch.float32),
            rig.F.to(torch.float32), config,
        )
    return _triangulate_plain(hyps, rig, config)


def _triangulate_plain(hyps: HypothesisSet, rig: CameraRig, config: FusionConfig,
                       with_drops: bool = False):
    """`triangulate_hypotheses` in plain PyTorch, on any device and dtype;
    `with_drops` also returns each joint's dropped view [H, J] (-1 none),
    as `(persons, drops)`."""
    dtype = hyps.kp.dtype
    dev = hyps.kp.device
    model = skeleton.input_model(config.pose_method)
    h, c, j, _ = hyps.kp.shape
    P = rig.P.to(dtype)

    kp_hj = hyps.kp.transpose(1, 2)  # [H, J, C, 3]
    cov_hj = hyps.cov.transpose(1, 2)
    conf = kp_hj[..., 2]
    view_mask = hyps.cam_mask[:, None, :] & (conf >= config.min_kp_score)
    k = torch.sum(view_mask, dim=-1)  # [H, J]

    T = triangulation.view_contribs(P, kp_hj, view_mask, weight_by_conf=True)
    M0 = torch.sum(T, dim=-3)
    xyz0 = triangulation.solve_normal(M0, k)
    err0 = triangulation.reprojection_error(xyz0, P, kp_hj, view_mask)

    # Leave-one-out for every view: A^T A without view c is M0 - T_c.
    eye_c = torch.eye(c, dtype=torch.bool, device=dev)
    loo_mask = view_mask[..., None, :] & ~eye_c  # [H, J, C, C]
    xyz_loo = triangulation.solve_normal(
        M0[..., None, :, :] - T, torch.sum(loo_mask, dim=-1)
    )  # [H, J, C(drop), 3]
    err_loo = triangulation.reprojection_error(
        xyz_loo, P, kp_hj[..., None, :, :].expand(h, j, c, c, 3), loo_mask
    )

    rem_d2, idx3 = epipolar.three_view_drop_scores(rig.F.to(dtype), kp_hj, view_mask)
    drop = _select_outlier_drops(err0, k, rem_d2, idx3, err_loo, view_mask, config)
    dropped = drop >= 0
    drop_idx = torch.where(dropped, drop, 0)

    final_mask = view_mask & ~(
        dropped[..., None]
        & (torch.arange(c, device=dev)[None, None, :] == drop_idx[..., None])
    )
    err = torch.where(
        dropped,
        torch.take_along_dim(err_loo, drop_idx[..., None], dim=-1)[..., 0],
        err0,
    )
    # The published position: the base DLT, or the selected leave-one-out
    # solution when a view was dropped (:792,835).
    xyz = torch.where(
        dropped[..., None],
        torch.take_along_dim(xyz_loo, drop_idx[..., None, None], dim=-2)[..., 0, :],
        xyz0,
    )

    k_final = torch.sum(final_mask, dim=-1)
    conf_sum = torch.sum(torch.where(final_mask, conf, 0.0), dim=-1)
    avg_score = conf_sum / torch.clamp(k_final, min=1).to(dtype)
    scale = torch.where(
        err > config.reproj_error_max_acceptable,
        config.reproj_error_max_acceptable / torch.clamp(err, min=1e-20),
        1.0,
    )
    avg_score = avg_score * scale
    joint_valid = k >= 2  # (:734-736)

    cov3d = covariance.triangulation_covariance(
        P, kp_hj, cov_hj, final_mask, xyz, kappa=config.ut_kappa
    )

    # Scatter the 17 input joints into the 21-joint fusion layout.
    to_fusion = linalg.constant(model.to_fusion, dev, torch.int64)
    kf = skeleton.NUM_FUSION_JOINTS
    xyz_f = torch.zeros((h, kf, 3), dtype=dtype, device=dev)
    score_f = torch.zeros((h, kf), dtype=dtype, device=dev)
    cov_f = torch.zeros((h, kf, 3, 3), dtype=dtype, device=dev)
    xyz_f[:, to_fusion] = torch.where(joint_valid[..., None], xyz, 0.0)
    score_f[:, to_fusion] = torch.where(joint_valid, avg_score, 0.0)
    cov_f[:, to_fusion] = torch.where(joint_valid[..., None, None], cov3d, 0.0)

    xyz_f, score_f, cov_f, n_pre, n_dropped, has_root = (
        _apply_limb_inflation_and_gates(xyz_f, score_f, cov_f, model, config)
    )
    persons = Persons3D(
        xyz=xyz_f,
        score=score_f,
        cov=cov_f,
        valid=_person_gate(xyz_f, score_f, n_pre, n_dropped, has_root, config),
        person_id=torch.full((h,), -1, dtype=torch.int32, device=dev),
    )
    return (persons, drop) if with_drops else persons


def _apply_limb_inflation_and_gates(xyz_f, score_f, cov_f,
                                    model: skeleton.InputModel,
                                    config: FusionConfig):
    """Limb-length covariance inflation (:861-883) and the root-distance
    gate (:923-953) on the 21-joint layout. Returns (xyz, score, cov,
    n_valid_pre_gate, n_dropped, has_root)."""
    dtype = xyz_f.dtype
    to_fusion = np.asarray(model.to_fusion)
    parent17 = np.asarray(model.parent)
    limb_len = np.asarray(model.limb_length)
    limb_sig = np.asarray(model.limb_sigma)

    add_sigma = torch.zeros_like(score_f)  # [H, K]
    for j17 in range(len(to_fusion)):
        fj = int(to_fusion[j17])
        pj17 = int(parent17[j17])
        if pj17 >= 0 and limb_len[j17] > 0:
            pf = int(to_fusion[pj17])
            dist = torch.linalg.vector_norm(xyz_f[:, fj] - xyz_f[:, pf], dim=-1)
            sig = (
                config.limb_cov_offset_sigma
                * (dist - float(limb_len[j17]))
                / float(limb_sig[j17])
            )
            active = (score_f[:, fj] > 0) & (score_f[:, pf] > 0)
            add_sigma[:, fj] = add_sigma[:, fj] + torch.where(active, sig, 0.0)
    # COCO has no neck joint: gate the shoulder pair's distance (:875-882).
    r17, l17 = model.shoulder_pair
    if r17 >= 0:
        rf, lf = int(to_fusion[r17]), int(to_fusion[l17])
        dist = torch.linalg.vector_norm(xyz_f[:, rf] - xyz_f[:, lf], dim=-1)
        sig = (
            config.limb_cov_offset_sigma
            * (dist - model.shoulder_dist)
            / model.shoulder_sigma
        )
        active = (score_f[:, rf] > 0) & (score_f[:, lf] > 0)
        sig = torch.where(active, sig, 0.0)
        add_sigma[:, rf] = add_sigma[:, rf] + sig
        add_sigma[:, lf] = add_sigma[:, lf] + sig

    eye3 = torch.eye(3, dtype=dtype, device=xyz_f.device)
    cov_f = cov_f + (add_sigma ** 2)[..., None, None] * eye3

    n_pre = torch.sum(score_f > 0, dim=1)
    root_xyz, root_score = _root_of(xyz_f, score_f)
    dist_root = torch.linalg.vector_norm(xyz_f - root_xyz[:, None, :], dim=-1)
    drop = (
        (root_score > 0)[:, None]
        & (score_f > 0)
        & (dist_root > config.max_joint_dist_to_root)
    )
    n_dropped = torch.sum(drop, dim=1)
    score_f = torch.where(drop, 0.0, score_f)
    xyz_f = torch.where(drop[..., None], 0.0, xyz_f)
    cov_f = torch.where(drop[..., None, None], 0.0, cov_f)
    return xyz_f, score_f, cov_f, n_pre, n_dropped, root_score > 0


def _root_of(xyz_f, score_f):
    """Root joint: MidHip if present, else the mean of both hips
    (:923-935). Returns (root_xyz [P, 3], root_score [P])."""
    midhip = skeleton.MIDHIP
    lhip, rhip = skeleton.LHIP, skeleton.RHIP
    have_mid = score_f[:, midhip] > 0
    have_hips = (score_f[:, lhip] > 0) & (score_f[:, rhip] > 0)
    hip_mean = 0.5 * (xyz_f[:, lhip] + xyz_f[:, rhip])
    hip_score = 0.5 * (score_f[:, lhip] + score_f[:, rhip])
    root_xyz = torch.where(
        have_mid[:, None],
        xyz_f[:, midhip],
        torch.where(have_hips[:, None], hip_mean, 0.0),
    )
    root_score = torch.where(
        have_mid, score_f[:, midhip], torch.where(have_hips, hip_score, 0.0)
    )
    return root_xyz, root_score


def _person_gate(xyz_f, score_f, n_pre, n_dropped, has_root,
                 config: FusionConfig):
    """Person validity: feet-height plausibility (:955-966) and the
    reference's valid-keypoint count gate (:968), whose counter loses one
    per dropped joint and one per originally empty slot when a root
    exists (:938-952)."""
    kf = score_f.shape[1]
    la, ra = skeleton.LANKLE, skeleton.RANKLE
    have_l = score_f[:, la] > 0
    have_r = score_f[:, ra] > 0
    feet_h = torch.where(
        have_l & have_r,
        0.5 * (xyz_f[:, la, 2] + xyz_f[:, ra, 2]),
        torch.where(
            have_l, xyz_f[:, la, 2], torch.where(have_r, xyz_f[:, ra, 2], 0.0)
        ),
    )
    feet_ok = torch.abs(feet_h) <= config.max_feet_height
    num_valid = torch.where(has_root, n_pre - n_dropped - (kf - n_pre), n_pre)
    return feet_ok & (num_valid > config.min_num_valid_keypoints)


def merge_close_persons(persons: Persons3D, config: FusionConfig) -> Persons3D:
    """Greedy pairwise merge of skeletons closer than the threshold
    (:984-996), as P-1 steps over victim slots j in ascending order, each
    merging j into the first close keeper i < j; this visits the same states
    as the reference's lexicographic pair loop (see the JAX package's
    fusion.merge_close_persons). Leading axes (frames) of `persons` are
    merged independently, in the same P-1 steps."""
    p = persons.xyz.shape[-3]
    if p < 2:
        return persons
    idx = torch.arange(p, device=persons.xyz.device)
    xyz, score, cov, valid = persons.xyz, persons.score, persons.cov, persons.valid
    for j in range(1, p):
        xj = xyz[..., j:j + 1, :, :]  # [..., 1, K, 3]
        sj = score[..., j:j + 1, :]
        cj = cov[..., j:j + 1, :, :, :]
        joint_ok = (score > 0) & (sj > 0)  # [..., P, K]
        d = torch.linalg.vector_norm(xyz - xj, dim=-1)
        n = torch.sum(joint_ok, dim=-1)
        mean_d = torch.sum(torch.where(joint_ok, d, 0.0), dim=-1) / torch.clamp(n, min=1)
        close = (
            valid & valid[..., j:j + 1] & (idx < j) & (n > 0)
            & (mean_d < config.merge_dist_thresh)
        )  # [..., P]
        do_merge = close.any(dim=-1, keepdim=True)
        # The first close keeper, gathered without a host read.
        k = torch.argmax(close.to(torch.int32), dim=-1, keepdim=True)  # [..., 1]
        xk = torch.take_along_dim(xyz, k[..., None, None], dim=-3)  # [..., 1, K, 3]
        si = torch.take_along_dim(score, k[..., None], dim=-2)
        ck = torch.take_along_dim(cov, k[..., None, None, None], dim=-4)
        # merge_persons (:410-423): score-weighted position, max score,
        # averaged covariance wherever the combined score is positive.
        tot = si + sj
        any_score = tot > 0
        w_i = torch.where(any_score, si / torch.where(any_score, tot, 1.0), 0.0)
        merged_xyz = torch.where(
            any_score[..., None], w_i[..., None] * xk + (1 - w_i)[..., None] * xj, xk
        )
        merged_score = torch.where(any_score, torch.maximum(si, sj), si)
        merged_cov = torch.where(any_score[..., None, None], 0.5 * (ck + cj), ck)
        into = (idx == k) & do_merge  # [..., P], the keeper's row when merging
        xyz = torch.where(into[..., None, None], merged_xyz, xyz)
        score = torch.where(into[..., None], merged_score, score)
        cov = torch.where(into[..., None, None, None], merged_cov, cov)
        valid = valid & ~((idx == j) & do_merge)
    return persons._replace(xyz=xyz, score=score, cov=cov, valid=valid)


def normalize_frame(frame: Frame, rig: CameraRig, config: FusionConfig):
    """Normalized keypoints and covariances [..., C, D, J, 3] and the usable
    detections det_ok [..., C, D]: a populated slot with more than half its
    keypoints valid (:579,599). Leading axes (frames) pass through."""
    kp_n, cov_n, kp_ok = cameras_lib.normalize_keypoints(
        frame.kp2d, frame.cov2d, rig.K, config.min_kp_score
    )
    enough = torch.sum(kp_ok, dim=-1) > (config.num_input_joints // 2)
    return kp_n, cov_n, frame.det_valid & enough


def fuse_frames(frames: Frame, rig: CameraRig, config: FusionConfig):
    """Full fusion of a chunk of synchronized frames (every Frame field with
    a leading frame axis B): normalize -> associate (one fold launch for the
    chunk) -> triangulate (the chunk's hypotheses as one batch) -> gate ->
    merge; the skeleton_3d node's per-frame path, frame by frame the same
    as `fuse_frame`.

    Returns (persons [B, H, ...], n_dropped [B] int32 hypothesis spawns lost
    to the slot capacity).
    """
    return fuse_chunks([frames], rig, config)[0]


def _no_stage(name: str):
    return contextlib.nullcontext()


def fuse_chunks(chunks, rig: CameraRig, config: FusionConfig, stage=_no_stage):
    """`fuse_frames` of each chunk of frames in `chunks`: every chunk's
    normalisation and association, then every chunk's triangulation, then
    each chunk's gates and merge, so that `stage` (a context manager of a
    name, e.g. `tracing.child`) holds each of the first two as one block,
    `fusion.associate` and `fusion.triangulate`. Returns a list of
    (persons, n_dropped), one per chunk."""
    with stage("fusion.associate"):
        hyps = []
        for frames in chunks:
            kp_n, cov_n, det_ok = normalize_frame(frames, rig, config)
            hyps.append(associate(kp_n, cov_n, frames.det_score, det_ok, rig, config))
    with stage("fusion.triangulate"):
        persons = [triangulate_frames(h, rig, config) for h in hyps]
    return [(gate_and_merge(p, h, config), h.n_dropped) for p, h in zip(persons, hyps)]


def triangulate_frames(hyps: HypothesisSet, rig: CameraRig,
                       config: FusionConfig) -> Persons3D:
    """`triangulate_hypotheses` of a chunk's hypotheses (a leading frame
    axis B) as one batch: persons [B, H, ...]."""
    b, h = hyps.cam_mask.shape[:2]
    flat = hyps._replace(
        kp=hyps.kp.flatten(0, 1), cov=hyps.cov.flatten(0, 1),
        cam_mask=hyps.cam_mask.flatten(0, 1), obs_score=hyps.obs_score.flatten(0, 1),
    )
    persons = triangulate_hypotheses(flat, rig, config)
    return Persons3D(*(x.reshape((b, h) + x.shape[1:]) for x in persons))


def gate_and_merge(persons: Persons3D, hyps: HypothesisSet, config: FusionConfig) -> Persons3D:
    """The fused persons of triangulated hypotheses: only live hypotheses
    with >= 2 observations stay valid (:684), then the pairwise merge.
    Leading axes (frames) pass through."""
    h = hyps.cam_mask.shape[-2]
    active = torch.arange(h, device=hyps.cam_mask.device) < hyps.n_hyp[..., None]
    n_obs = torch.sum(hyps.cam_mask, dim=-1)
    persons = persons._replace(valid=persons.valid & active & (n_obs >= 2))
    return merge_close_persons(persons, config)


def fuse_frame(frame: Frame, rig: CameraRig, config: FusionConfig,
               with_stats: bool = False):
    """Full fusion of one synchronized frame (`fuse_frames` on a chunk of
    one).

    with_stats: also return the [] int32 count of hypothesis spawns lost to
    the slot capacity, as `(persons, n_dropped)`.
    """
    persons, n_dropped = fuse_frames(Frame(*(x[None] for x in frame)), rig, config)
    persons = Persons3D(*(x[0] for x in persons))
    if with_stats:
        return persons, n_dropped[0]
    return persons
