"""Write the golden files the PyTorch port is held to, on the card
(chip_smoke.py) and on the CPU (test_torch_pipeline.py):

* tests/data/torch_golden_demo16.npz: the JAX reference's online path,
  `Pipeline.step` frame by frame;
* tests/data/torch_golden_offline16.npz: its offline replay,
  `Pipeline(..., fusion_batch=32).run_offline` over the whole sequence
  (cold-start smoothing, so joints differ from the online file's by up to
  ~0.1 mm), plus the tracker stage on its own: the tracker's inputs
  (`<scene>/stage_in/...`: fusion and smooth_cold outputs) and the tracker
  scan and reprojection on them (`<scene>/stage/...`, the same keys as
  the end-to-end outputs).

Both run JAX on the CPU in float32 with `PipelineConfig.demo_16cam()` and
`hall_rig(16)` over the benign and the adversarial scene of
`parity._FULL_SCENE` / `parity._ADVERSARIAL` (16 cameras x 6 people, seed 7,
64 frames). Detection slots are padded with det_valid=False to the config's
8 slots, so both scenes run at the demo width. Both files hold the same keys
per scene.

Usage (from the repository root):
    python tests/make_torch_golden.py [online|offline]   # default: both
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
OUT = {
    "online": os.path.join(_ROOT, "tests", "data", "torch_golden_demo16.npz"),
    "offline": os.path.join(_ROOT, "tests", "data", "torch_golden_offline16.npz"),
}
SCENES = ("benign", "adversarial")
OFFLINE_FUSION_BATCH = 32


def scene_frames(adversarial: bool, num_dets: int):
    """(SceneConfig kwargs, frame arrays padded to `num_dets` slots)."""
    import parity
    from smartedgesensor3dhumanpose_tpu.io import synthetic
    from smartedgesensor3dhumanpose_tpu_torch.io.synthetic import pad_detections

    kw = dict(parity._FULL_SCENE)
    if adversarial:
        kw.update(parity._ADVERSARIAL)
    scene = synthetic.generate_scene(synthetic.SceneConfig(**kw))
    data = synthetic.frames_from_scene(scene, np.float32)
    return kw, pad_detections(data, num_dets)


def first_published(fused_valid: np.ndarray, fused_id: np.ndarray) -> np.ndarray:
    """[F, P] True where a track id is published for the first time: the
    prediction there rides on velocity buffers filled during unpublished
    warm-up frames, which no published output constrains (ROADMAP C3)."""
    seen = set()
    mask = np.zeros(fused_valid.shape, bool)
    for f in range(fused_valid.shape[0]):
        for p in np.nonzero(fused_valid[f])[0]:
            tid = int(fused_id[f, p])
            if tid not in seen:
                mask[f, p] = True
        seen.update(int(i) for i in fused_id[f][fused_valid[f]])
    return mask


def _golden_fields(out) -> dict:
    """The stored fields of a StepOutput (one frame, or stacked)."""
    return {
        "raw_valid": out.persons_raw.valid,
        "raw_joint_on": out.persons_raw.score > 0,
        "fused_valid": out.fused.valid,
        "fused_id": out.fused.person_id,
        "fused_joint_on": out.fused.score > 0,
        "pred_valid": out.fused_pred.valid,
        "fb_valid": out.feedback.valid,
        "fb_kp_valid": out.feedback.kp_valid,
        "n_dropped_hyp": out.n_dropped_hypotheses,
        "n_dropped_spawns": out.n_dropped_track_spawns,
        "fused_xyz": out.fused.xyz,
        "pred_xyz": out.fused_pred.xyz,
        "pred_delta_t": out.pred_delta_t,
    }


def run_reference(data: dict, mode: str) -> dict:
    import jax
    import jax.numpy as jnp

    from smartedgesensor3dhumanpose_tpu import cameras, pipeline
    from smartedgesensor3dhumanpose_tpu.config import PipelineConfig
    from smartedgesensor3dhumanpose_tpu.types import Frame

    config = PipelineConfig.demo_16cam()
    if mode == "offline":
        pipe = pipeline.Pipeline(cameras.hall_rig(16), config,
                                 fusion_batch=OFFLINE_FUSION_BATCH)
        _, out = pipe.run_offline(pipe.init_state(dtype=jnp.float32),
                                  Frame.from_arrays(data))
        res = {k: np.asarray(v) for k, v in _golden_fields(jax.device_get(out)).items()}
    else:
        pipe = pipeline.Pipeline(cameras.hall_rig(16), config)
        state = pipe.init_state(dtype=jnp.float32)
        rows = []
        for f in range(data["kp2d"].shape[0]):
            frame = Frame.from_arrays({k: v[f] for k, v in data.items()})
            state, out = pipe.step(state, frame)
            rows.append(_golden_fields(jax.device_get(out)))
        res = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    res["first_published"] = first_published(res["fused_valid"], res["fused_id"])
    return res


# The tracker's inputs kept per frame in the offline golden: the fused
# persons' fields it reads, and the smooth_cold fields it reads.
STAGE_PERSON_FIELDS = ("xyz", "score", "valid")
STAGE_GRAPH_FIELDS = ("active", "root_xyz", "height", "score_out", "num_meas")


def run_offline_stages(data: dict) -> dict:
    """The offline path's tracker stage on its own: JAX fusion and
    smooth_cold of the sequence (the same lax.map chunks as run_offline),
    then the XLA tracker scan and reprojection on exactly those inputs.

    The cold-start LM in float32 does not converge within its iteration cap
    on some ill-posed (ghost) persons, and there its output moves by up to
    a metre with the summation order; a second float32 implementation
    cannot reproduce those persons, and through the track estimates they
    feed, later tracker decisions. Keeping the tracker's inputs lets the
    port's tracker (K3 on the card) be held to this stage exactly.
    Returns {"stage_in/<key>": inputs, "stage/<key>": outputs}."""
    import types

    import jax
    import jax.numpy as jnp

    from smartedgesensor3dhumanpose_tpu import cameras, fusion, pipeline, reprojection, tracking
    from smartedgesensor3dhumanpose_tpu.config import PipelineConfig
    from smartedgesensor3dhumanpose_tpu.types import Frame, TrackerState

    config = PipelineConfig.demo_16cam()
    rig = cameras.hall_rig(16)
    frames = Frame.from_arrays(data)

    def fuse_one(frame):
        frame, pivot = pipeline.mask_stale_cameras(frame, config.fusion.max_sync_diff)
        persons, n_drop = fusion.fuse_frame(frame, rig, config.fusion,
                                            unroll_cameras=True, with_stats=True)
        return persons, pivot, n_drop

    @jax.jit
    def stage_inputs(frames):
        persons, pivots, n_drop = jax.lax.map(fuse_one, frames, batch_size=OFFLINE_FUSION_BATCH)
        pre = jax.lax.map(lambda p: tracking.smooth_cold(p, config.prior), persons,
                          batch_size=OFFLINE_FUSION_BATCH)
        return persons, pivots, n_drop, pre

    @jax.jit
    def stage_outputs(persons, pivots, pre):
        def body(carry, xs):
            person_t, pivot_t, fb_t, pre_t = xs
            return tracking.step(carry, person_t, pivot_t.astype(person_t.xyz.dtype), fb_t,
                                 config.prior, config.tracker, precomputed=pre_t)

        t = config.tracker
        state0 = TrackerState.initial(t.max_tracks, t.n_mov_avg, t.avg_delay, dtype=jnp.float32)
        _, track = jax.lax.scan(body, state0, (persons, pivots, frames.fb_delay, pre))
        feedback = jax.vmap(lambda pr, dt, ts: reprojection.reproject(
            pr, rig, config.prior.pose_method, dt, ut_kappa=config.fusion.ut_kappa,
            ts_per_cam=ts))(track.fused_pred, track.pred_delta_t, frames.cam_stamp)
        return track, feedback

    persons, pivots, n_drop, pre = jax.device_get(stage_inputs(frames))
    track, feedback = jax.device_get(stage_outputs(persons, pivots, pre))
    g_in, result, xyz_out, cov_out = pre
    out = types.SimpleNamespace(
        persons_raw=persons, fused=track.fused, fused_pred=track.fused_pred,
        feedback=feedback, n_dropped_hypotheses=n_drop,
        n_dropped_track_spawns=track.n_dropped_spawns, pred_delta_t=track.pred_delta_t,
    )
    res = {f"stage/{k}": np.asarray(v) for k, v in _golden_fields(out).items()}
    res["stage/first_published"] = first_published(res["stage/fused_valid"], res["stage/fused_id"])
    inputs = {f"person_{k}": getattr(persons, k) for k in STAGE_PERSON_FIELDS}
    inputs.update({f"graph_{k}": getattr(g_in, k) for k in STAGE_GRAPH_FIELDS})
    inputs.update(pivot=pivots, n_dropped_hyp=n_drop, result_x=result.x,
                  xyz_out=xyz_out, cov_out=cov_out)
    res.update({f"stage_in/{k}": np.asarray(v) for k, v in inputs.items()})
    return res


def main(modes) -> None:
    import jax

    from smartedgesensor3dhumanpose_tpu_torch.io.synthetic import frames_digest

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)  # float32 throughout
    from smartedgesensor3dhumanpose_tpu.config import PipelineConfig

    num_dets = PipelineConfig.demo_16cam().fusion.max_dets_per_cam
    for mode in modes:
        blob = {}
        for name in SCENES:
            kw, data = scene_frames(name == "adversarial", num_dets)
            res = run_reference(data, mode)
            if mode == "offline":
                res.update(run_offline_stages(data))
            blob[f"{name}/scene"] = np.array(json.dumps(kw, sort_keys=True))
            blob[f"{name}/input_sha256"] = np.array(frames_digest(data))
            for k, v in res.items():
                blob[f"{name}/{k}"] = v
            print(mode, name, {k: v.shape for k, v in res.items()})
            if mode == "offline":
                differ = {k: int((res[k] != res[f"stage/{k}"]).sum()) for k in (
                    "raw_valid", "fused_valid", "fused_id", "n_dropped_spawns")}
                print("  run_offline vs its tracker stage run alone, entries that differ:", differ)
        os.makedirs(os.path.dirname(OUT[mode]), exist_ok=True)
        np.savez_compressed(OUT[mode], **blob)
        print(OUT[mode], os.path.getsize(OUT[mode]), "bytes")


if __name__ == "__main__":
    args = sys.argv[1:]
    if any(a not in OUT for a in args):
        sys.exit(f"usage: {sys.argv[0]} [online|offline]")
    main(args or list(OUT))
