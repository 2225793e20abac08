"""Camera calibration, fundamental matrices and keypoint normalization.

Setup-time math (rig construction, F matrices) runs on the host in NumPy
float64, like the reference's double-precision Eigen startup path
(skeleton_3d_triang_mult_node.cpp:161-253,1187-1206); the values become
tensors at the boundary. Per-frame normalization (:312-333) is a torch
function.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.types import CameraRig


def quat_to_rot(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    """Unit quaternion -> 3x3 rotation matrix."""
    q = np.array([qx, qy, qz, qw], dtype=np.float64)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def make_transform(xyz: Sequence[float], quat: Sequence[float]) -> np.ndarray:
    """(translation, quaternion xyzw) -> 4x4 homogeneous transform."""
    t = np.eye(4, dtype=np.float64)
    t[:3, :3] = quat_to_rot(*quat)
    t[:3, 3] = np.asarray(xyz, dtype=np.float64)
    return t


def invert_transform(t: np.ndarray) -> np.ndarray:
    r, p = t[:3, :3], t[:3, 3]
    inv = np.eye(4, dtype=np.float64)
    inv[:3, :3] = r.T
    inv[:3, 3] = -r.T @ p
    return inv


def _cross_matrix(v: np.ndarray) -> np.ndarray:
    return np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]],
        dtype=np.float64,
    )


def fundamental_matrices(P: np.ndarray) -> np.ndarray:
    """All ordered pairwise fundamental matrices in normalized coordinates:
    F[i, j] = [e_ij]_x P_j pinv(P_i), e_ij = P_j C_i (reference :1195-1204).
    F[i, i] is zero. Returns [C, C, 3, 3] float64."""
    P = np.asarray(P, dtype=np.float64)
    c = P.shape[0]
    centers = np.ones((c, 4), dtype=np.float64)
    for i in range(c):
        r, t = P[i, :, :3], P[i, :, 3]
        centers[i, :3] = -r.T @ t
    f = np.zeros((c, c, 3, 3), dtype=np.float64)
    for i in range(c):
        p_inv = np.linalg.pinv(P[i])
        for j in range(c):
            if i == j:
                continue
            e_ij = P[j] @ centers[i]
            f[i, j] = _cross_matrix(e_ij) @ P[j] @ p_inv
    return f


def build_rig(
    P: np.ndarray,
    K: np.ndarray,
    image_size: np.ndarray | Tuple[int, int] = (640, 480),
    dtype=torch.float32,
    device="cuda",
) -> CameraRig:
    """Assemble a CameraRig from extrinsics [C, 3, 4] and intrinsics ([C, 4]
    (fx, fy, cx, cy) or [C, 3, 3]); `image_size` is [C, 2] or one
    (width, height) for all cameras. F is computed in float64 on the host
    from the float64 P, then cast."""
    P = np.asarray(P, dtype=np.float64)
    c = P.shape[0]
    K = np.asarray(K, dtype=np.float64)
    if K.ndim == 3:
        K = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], axis=-1)
    if K.shape != (c, 4):
        raise ValueError(f"K must be [C,4] or [C,3,3]; got {K.shape}")
    size = np.asarray(image_size, dtype=np.float64)
    if size.ndim == 1:
        size = np.broadcast_to(size, (c, 2))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return CameraRig(K=t(K), P=t(P), F=t(fundamental_matrices(P)), image_size=t(size))


def normalize_keypoints(
    kp2d: torch.Tensor,
    cov2d: torch.Tensor,
    K: torch.Tensor,
    min_score: float,
):
    """Pixel keypoints -> normalized camera coordinates (reference :312-333).

    Returns (kp_n [C, D, J, 3] with score -1 where invalid, cov_n
    [C, D, J, 3], kp_ok [C, D, J] bool).
    """
    fx = K[:, 0][:, None, None]
    fy = K[:, 1][:, None, None]
    cx = K[:, 2][:, None, None]
    cy = K[:, 3][:, None, None]
    score = kp2d[..., 2]
    kp_ok = score >= min_score
    xn = (kp2d[..., 0] - cx) / fx
    yn = (kp2d[..., 1] - cy) / fy
    kp_n = torch.stack(
        [
            torch.where(kp_ok, xn, 0.0),
            torch.where(kp_ok, yn, 0.0),
            torch.where(kp_ok, score, -1.0),
        ],
        dim=-1,
    )
    cov_scale = torch.stack(
        [1.0 / (fx * fx), 1.0 / (fx * fy), 1.0 / (fy * fy)], dim=-1
    )
    cov_n = torch.where(kp_ok[..., None], cov2d * cov_scale, 0.0)
    return kp_n, cov_n, kp_ok


# The 16-camera hall rig of the reference demo
# (pose_prior/launch/cameras_extrinsics.launch:2-18): (x, y, z) and
# (qx, qy, qz, qw) of each camera frame in its parent; cam_1 is parented to
# `base`, all others to cam_1.
_HALL_CAM1 = (
    (1.5499999523162842, 3.0099990367889404, 2.6500000953674316),
    (0.20033794865721963, 0.8588611032421662, -0.4429022587675689,
     -0.16143079273810093),
)

_HALL_FROM_CAM1: Dict[int, tuple] = {
    2: ((-2.633945169170119, -2.919909318757409, 3.899855565698045),
        (0.0001549807609790004, 0.7211508944129336, 0.5390229674254626,
         0.4351960524364166)),
    3: ((0.2983395144465615, -3.672175293061444, 5.343037490830041),
        (-0.06865687953221701, 0.8069533359984313, 0.5711889255662295,
         0.133625438163711)),
    4: ((3.082286613353125, -0.7352749601527868, 1.605414951543227),
        (0.00173402746986561, -0.4114917017932643, -0.1990145962580835,
         0.8894182160155785)),
    5: ((6.110513295352616, 0.8838426509323714, 0.2910790340644311),
        (0.08877506424266578, -0.4420197566892827, -0.2054472967461308,
         0.86863624776131)),
    6: ((6.309275706436605, 0.8670510298754263, 0.3301988321930609),
        (0.07571247861839947, 0.2078607164622132, 0.1871870694710939,
         0.9570906666330913)),
    7: ((3.671714458416727, -2.04866904829892, 3.999743130789737),
        (0.02245259971977893, 0.6185599787670887, 0.3894578235044512,
         0.6820572095834463)),
    8: ((3.636096914580173, -1.87412306230743, 3.718174238261642),
        (-0.09751455925953315, 0.8362413042797954, 0.4909729691594715,
         -0.2239127850384252)),
    9: ((9.522813893600864, -5.043990354525926, 8.935525904167434),
        (0.05333145796631635, -0.7184327226382133, -0.4325859167277253,
         0.5421066346050116)),
    10: ((13.01738867673681, -0.6221644970654454, 3.383990708231272),
         (0.0885725855715381, -0.5036638814909422, -0.2211362884833759,
          0.8304073298583782)),
    11: ((6.321705018182777, -7.809246137029179, 12.72672461967454),
         (-0.06053939788934688, 0.8590686088136293, 0.5016569086573112,
          -0.08170956278588196)),
    12: ((3.336688045659408, -2.078892358471732, 4.001116364124468),
         (0.04171164204751583, 0.002159889573339447, 0.01744511852961815,
          0.9989750455513238)),
    13: ((-4.682912977706426, -1.296521317594658, 1.797625172974838),
         (0.03988976582242469, 0.3468503949134559, 0.2669305655261811,
          0.8982492322951938)),
    14: ((0.04917572027208461, -5.911637211143098, 9.059150457801374),
         (0.007348283668459651, 0.6788738985652794, 0.4433205066476218,
          0.5852718692707477)),
    15: ((-0.2472550939829693, -5.82690517416104, 8.815203174380958),
         (-0.02538722853061115, 0.8437166699754711, 0.5361261800222171,
          0.008147915553398765)),
    16: ((-7.313903817527387, -4.270998566476825, 5.454492489404784),
         (-0.007791216737115181, 0.6528724744485751, 0.4281954444214442,
          0.6247763523260997)),
}


def hall_extrinsics(num_cameras: int = 16) -> np.ndarray:
    """Base->cam 3x4 extrinsics of the reference demo hall
    (lookupTransform(cam_i, base) = inv(T_base_cam_i), reference :166-167)."""
    if not 1 <= num_cameras <= 16:
        raise ValueError("hall rig has 16 cameras")
    t_base_cam1 = make_transform(*_HALL_CAM1)
    poses = [t_base_cam1]
    for idx in range(2, num_cameras + 1):
        xyz, quat = _HALL_FROM_CAM1[idx]
        poses.append(t_base_cam1 @ make_transform(xyz, quat))
    return np.stack([invert_transform(t)[:3, :] for t in poses], axis=0)


def ring_extrinsics(
    num_cameras: int,
    radius: float = 6.0,
    heights: Tuple[float, ...] = (2.2, 3.2, 4.4),
    look_at_z: float = 1.0,
) -> np.ndarray:
    """Base->cam extrinsics of a synthetic multi-ring hall (cameras beyond the
    16 calibrated ones), each looking at a point on the hall axis."""
    mats = []
    for i in range(num_cameras):
        ring = i % len(heights)
        n_ring = (num_cameras + len(heights) - 1 - ring) // len(heights)
        j = i // len(heights)
        ang = 2.0 * np.pi * j / max(n_ring, 1) + 0.35 * ring
        c = np.array(
            [radius * np.cos(ang), radius * np.sin(ang), heights[ring]]
        )
        z = np.array([0.0, 0.0, look_at_z]) - c
        z = z / np.linalg.norm(z)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        r = np.stack([x, y, z])
        mats.append(np.hstack([r, (-r @ c)[:, None]]))
    return np.stack(mats, axis=0)


def hall_rig(
    num_cameras: int = 16,
    intrinsics: Tuple[float, float, float, float] = (420.0, 420.0, 320.0, 240.0),
    image_size: Tuple[int, int] = (640, 480),
    dtype=torch.float32,
    device="cuda",
) -> CameraRig:
    """The demo hall rig with nominal 640x480 sensor intrinsics; beyond 16
    cameras it extends with `ring_extrinsics`."""
    if num_cameras <= 16:
        P = hall_extrinsics(num_cameras)
    else:
        P = np.concatenate(
            [hall_extrinsics(16), ring_extrinsics(num_cameras - 16)], axis=0
        )
    K = np.tile(np.asarray(intrinsics, dtype=np.float64), (num_cameras, 1))
    return build_rig(P, K, image_size, dtype=dtype, device=device)


def project_to_pixels(xyz_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points to pixels.

    Args:
      xyz_cam: [..., 3] points in a camera frame.
      K: [4] (fx, fy, cx, cy) for that camera.
    Returns:
      [..., 2] pixel coordinates.
    """
    z = xyz_cam[..., 2]
    px = K[0] * xyz_cam[..., 0] / z + K[2]
    py = K[1] * xyz_cam[..., 1] / z + K[3]
    return torch.stack([px, py], dim=-1)
