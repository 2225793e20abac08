"""The port's association fold (ops/association.py, kernel K2's plain
version, through fusion.associate) against the JAX package's fusion.associate.

Two references: the XLA camera scan with the cond-guarded JV
(`assignment_impl="cond_while"`) in float64, and the TPU kernel
`association_pallas._assoc_kernel` (`"pallas_scan"`) in interpret mode in
float32. The compared outputs are integers (which detection each hypothesis
observes per camera, the live and dropped counts), so they must be exactly
equal; the gathered observation data agree to the ulp. The scenes are those of
test_association_pallas.py: benign, ghost detections, and over capacity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartedgesensor3dhumanpose_tpu import cameras as jax_cameras
from smartedgesensor3dhumanpose_tpu import fusion as jax_fusion
from smartedgesensor3dhumanpose_tpu.config import FusionConfig as JaxFusionConfig
from smartedgesensor3dhumanpose_tpu.io import synthetic as jax_synthetic
from smartedgesensor3dhumanpose_tpu_torch import cameras, fusion
from smartedgesensor3dhumanpose_tpu_torch.config import FusionConfig
from smartedgesensor3dhumanpose_tpu_torch.ops import association
from smartedgesensor3dhumanpose_tpu_torch.types import Frame

pytestmark = pytest.mark.torch_port

SCENARIOS = {
    # (cameras, people, frames, seed, hypothesis slots, scene knobs)
    "benign": (6, 3, 4, 11, 16, {}),
    "ghosts": (6, 3, 4, 11, 16, dict(num_ghost_slots=2, ghost_rate=0.6)),
    "overcap": (4, 6, 2, 7, 4, {}),
}


def _scene(cams, people, frames, seed, **kw):
    scene = jax_synthetic.generate_scene(
        jax_synthetic.SceneConfig(
            num_cameras=cams, num_people=people, num_frames=frames, seed=seed,
            pixel_noise=2.0, keypoint_dropout=0.08, detection_dropout=0.05, **kw,
        )
    )
    return jax_synthetic.frames_from_scene(scene)


@pytest.mark.parametrize("impl,dtype", [("cond_while", np.float64), ("pallas_scan", np.float32)])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_fold_matches_jax(scenario, impl, dtype):
    cams, people, frames, seed, h, kw = SCENARIOS[scenario]
    data = _scene(cams, people, frames, seed, **kw)
    d = data["kp2d"].shape[2]
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jcfg = JaxFusionConfig(num_cameras=cams, max_dets_per_cam=d, max_hypotheses=h,
                           assignment_impl=impl)
    tcfg = FusionConfig(num_cameras=cams, max_dets_per_cam=d, max_hypotheses=h)
    jrig = jax_cameras.hall_rig(cams, dtype=jdt)
    trig = cameras.hall_rig(cams, dtype=tdt, device="cpu")

    @jax.jit
    def jax_assoc(kp2d, cov2d, det_score, det_valid):
        kp_n, cov_n, kp_ok = jax_cameras.normalize_keypoints(
            kp2d, cov2d, jrig.K, jcfg.min_kp_score
        )
        det_ok = det_valid & (jnp.sum(kp_ok, axis=-1) > jcfg.num_input_joints // 2)
        return jax_fusion.associate(kp_n, cov_n, det_score, det_ok, jrig, jcfg)

    dropped = 0
    for t in range(frames):
        arrays = {k: np.asarray(v[t]) for k, v in data.items()}
        for k in ("kp2d", "cov2d", "det_score"):
            arrays[k] = arrays[k].astype(dtype)
        want = jax.device_get(jax_assoc(
            arrays["kp2d"], arrays["cov2d"], arrays["det_score"], arrays["det_valid"]
        ))
        frame = Frame.from_arrays(arrays, "cpu")
        kp_n, cov_n, det_ok = fusion.normalize_frame(frame, trig, tcfg)
        got = fusion.associate(kp_n, cov_n, frame.det_score, det_ok, trig, tcfg)
        msg = f"{scenario} {impl} t{t}"
        np.testing.assert_array_equal(got.cam_mask.numpy(), want.cam_mask, err_msg=msg)
        # The same detections, normalized by two compilers: XLA may rewrite
        # (x - cx) / fx, which moves the result by one ulp.
        ulp = np.finfo(dtype).eps
        np.testing.assert_allclose(got.kp.numpy(), want.kp, rtol=2 * ulp, atol=0, err_msg=msg)
        np.testing.assert_array_equal(got.obs_score.numpy(), want.obs_score, err_msg=msg)
        assert int(got.n_hyp) == int(want.n_hyp), msg
        assert int(got.n_dropped) == int(want.n_dropped), msg
        dropped += int(got.n_dropped)
    if scenario == "overcap":
        assert dropped > 0


def test_reference_impl_equals_kernel_wrapper():
    """assignment_impl="reference" and the default "kernel" wrapper give the
    same fold on CPU tensors (the wrapper runs the plain version there)."""
    cams, people, frames, seed, h, kw = SCENARIOS["ghosts"]
    data = _scene(cams, people, 1, seed, **kw)
    frame = Frame.from_arrays({k: np.asarray(v[0]) for k, v in data.items()}, "cpu")
    rig = cameras.hall_rig(cams, device="cpu")
    base = FusionConfig(num_cameras=cams, max_dets_per_cam=data["kp2d"].shape[2],
                        max_hypotheses=h)
    kp_n, cov_n, det_ok = fusion.normalize_frame(frame, rig, base)
    outs = [
        fusion.associate(kp_n, cov_n, frame.det_score, det_ok, rig,
                         dataclasses.replace(base, assignment_impl=impl))
        for impl in ("kernel", "reference")
    ]
    assert torch.equal(outs[0].cam_mask, outs[1].cam_mask)
    assert torch.equal(outs[0].kp, outs[1].kp)


def test_batched_fold_equals_per_frame():
    cams, people, frames, seed, h, kw = SCENARIOS["benign"]
    data = _scene(cams, people, frames, seed, **kw)
    rig = cameras.hall_rig(cams, device="cpu")
    cfg = FusionConfig(num_cameras=cams, max_dets_per_cam=data["kp2d"].shape[2],
                       max_hypotheses=h)
    inputs = []
    for t in range(frames):
        frame = Frame.from_arrays({k: np.asarray(v[t]) for k, v in data.items()}, "cpu")
        kp_n, _, det_ok = fusion.normalize_frame(frame, rig, cfg)
        ctab, conf = fusion.fold_inputs(kp_n, frame.det_score, rig, cfg)
        inputs.append((ctab, conf, det_ok))
    args = (h, cfg.max_epipolar_error, cfg.max_cost)
    batched = association.associate_fold_batched(
        *(torch.stack(x) for x in zip(*inputs)), *args
    )
    for t, (ctab, conf, det_ok) in enumerate(inputs):
        single = association.associate_fold(ctab, conf, det_ok, *args)
        for b, s in zip(batched, single):
            assert torch.equal(b[t], s), t


@pytest.mark.parametrize("c,d,h_cap,prefetch", [
    (16, 8, 16, True),    # the demo shape: two 8 KB table slices on chip
    (6, 8, 16, True),
    (64, 32, 40, False),  # the scaled layout: a 256 KB slice stays in device memory
    (64, 32, 120, False),  # the JV's limit
    (5, 3, 4, False),     # a slice that is not a whole number of 16-byte units
])
def test_fold_plan(c, d, h_cap, prefetch):
    """K2's shared-memory plan: which shapes prefetch the table slices, and
    a byte count that is the sum of what the block holds and fits it."""
    plan = association.fold_plan(c, d, h_cap)
    assert plan.prefetch is prefetch
    dp = association.padded_dets(d)
    want = (2 * 4 * c * d * d if prefetch else 0) + 4 * c * 128 + 8 * c * d \
        + 4 * dp * max(h_cap, dp) + dp * 128
    assert plan.smem_bytes == want == association.fold_smem_bytes(c, d, h_cap, prefetch)
    assert plan.smem_bytes + association.STATIC_SMEM_RESERVE <= association.SMEM_PER_BLOCK


def test_fold_plan_refuses_what_a_block_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        association.fold_plan(400, 32, 120)
