"""Sequence replay: the transport-free equivalent of `rosbag play`.

The reference demo replays poses2D_16cam.bag into per-camera topics
(README.md:40-49); here a recorded (or synthetic) sequence is stored as
NPZ/JSONL, per-camera message streams are pushed through the approximate-time
synchronizer (sync.py: native C++, or its Python mirror when asked for),
and synchronized sets are packed into fixed-shape frame dicts of NumPy
arrays (`types.Frame.from_arrays` puts one on the device). The same
formats as the JAX package's `io.replay`: a recording made by either
package replays in the other.
"""

from __future__ import annotations

import json
from typing import Iterator

import numpy as np

from smartedgesensor3dhumanpose_tpu_torch import sync as sync_lib


def save_npz(path: str, scene: dict) -> None:
    """Persist a generated scene (io.synthetic.generate_scene output)."""
    np.savez_compressed(
        path,
        kp2d=scene["kp2d"],
        cov2d=scene["cov2d"],
        det_valid=scene["det_valid"],
        det_score=scene["det_score"],
        cam_stamp=scene["cam_stamp"],
        fb_delay=scene["fb_delay"],
        gt_xyz=scene.get("gt_xyz", np.zeros(0)),
    )


def load_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_jsonl(path: str, scene: dict) -> None:
    """One JSON line per (frame, camera) message — a Person2DList equivalent
    (person_msgs/Person2DList.msg: header stamp, fb_delay, persons with
    keypoints x/y/score/cov)."""
    kp2d = scene["kp2d"]
    cov2d = scene["cov2d"]
    det_valid = scene["det_valid"]
    det_score = scene["det_score"]
    t, c = kp2d.shape[:2]
    with open(path, "w") as f:
        for ti in range(t):
            for ci in range(c):
                persons = []
                for di in range(kp2d.shape[2]):
                    if not det_valid[ti, ci, di]:
                        continue
                    persons.append(
                        {
                            "score": float(det_score[ti, ci, di]),
                            "keypoints": np.round(
                                kp2d[ti, ci, di], 4
                            ).tolist(),
                            "cov": np.round(cov2d[ti, ci, di], 6).tolist(),
                        }
                    )
                f.write(
                    json.dumps(
                        {
                            "camera": ci,
                            "stamp": float(scene["cam_stamp"][ti, ci]),
                            "fb_delay": float(scene["fb_delay"][ti, ci]),
                            "persons": persons,
                        }
                    )
                    + "\n"
                )


def load_jsonl_messages(path: str):
    """Yield (camera, stamp, fb_delay, persons) in file order."""
    with open(path) as f:
        for line in f:
            msg = json.loads(line)
            yield msg["camera"], msg["stamp"], msg["fb_delay"], msg["persons"]


class SynchronizedReplay:
    """Push per-camera messages through the approximate-time synchronizer and
    emit fixed-shape frame dicts (NumPy) ready for Frame construction.

    Mirrors the reference's topology: per-camera streams -> N-way
    ApproximateTime sync -> fused frame (synchronizer_vec.h +
    approximate_time_vec.h), with the message store held host-side and only
    opaque handles flowing through the synchronizer.
    """

    def __init__(
        self,
        num_cameras: int,
        max_dets: int,
        num_joints: int = 17,
        prefer_native: bool = True,
    ):
        self.num_cameras = num_cameras
        self.max_dets = max_dets
        self.num_joints = num_joints
        self.sync = sync_lib.make_synchronizer(
            num_cameras, prefer_native=prefer_native
        )
        self._store: dict = {}
        self._next_handle = 1  # 0 reserved

    def push(self, camera: int, stamp_s: float, fb_delay: float, persons):
        """persons: list of {score, keypoints [J,3], cov [J,3]} dicts or a
        (kp2d [D,J,3], cov2d [D,J,3], score [D]) tuple.

        Returns the opaque message handle (lets live callers track
        per-message arrival times, see online.run_online_synced)."""
        handle = self._next_handle
        self._next_handle += 1
        self._store[handle] = (fb_delay, persons)
        self.sync.push(camera, int(round(stamp_s * 1e9)), handle)
        return handle

    def pop_frames(self) -> Iterator[dict]:
        """Drain synchronized sets as padded frame dicts."""
        while True:
            got = self.sync.pop()
            if got is None:
                return
            stamps, handles = got
            yield self._pack(stamps, handles)

    def _pack(self, stamps, handles) -> dict:
        c, d, j = self.num_cameras, self.max_dets, self.num_joints
        kp2d = np.zeros((c, d, j, 3), np.float32)
        cov2d = np.zeros((c, d, j, 3), np.float32)
        det_score = np.zeros((c, d), np.float32)
        det_valid = np.zeros((c, d), bool)
        fb_delay = np.full((c,), -1.0, np.float32)
        for ci in range(c):
            fb, persons = self._store.pop(handles[ci])
            fb_delay[ci] = fb
            if isinstance(persons, tuple):
                kp, cov, score = persons
                n = min(d, kp.shape[0])
                kp2d[ci, :n] = kp[:n]
                cov2d[ci, :n] = cov[:n]
                det_score[ci, :n] = score[:n]
                det_valid[ci, :n] = score[:n] > 0
            else:
                for di, person in enumerate(persons[:d]):
                    kp2d[ci, di] = np.asarray(
                        person["keypoints"], np.float32
                    )
                    cov2d[ci, di] = np.asarray(person["cov"], np.float32)
                    det_score[ci, di] = person["score"]
                    det_valid[ci, di] = True
        return {
            "kp2d": kp2d,
            "cov2d": cov2d,
            "det_score": det_score,
            "det_valid": det_valid,
            "cam_stamp": np.asarray(stamps, np.float64) * 1e-9,
            "fb_delay": fb_delay,
            # The contributing message handles (one per camera) — live
            # consumers use them to attribute arrival times; Frame
            # construction ignores the key.
            "handles": list(handles),
        }


def replay_jsonl(
    path: str,
    num_cameras: int,
    max_dets: int,
    prefer_native: bool = True,
) -> Iterator[dict]:
    """Full bag-equivalent replay: JSONL messages -> synchronizer -> frames."""
    replay = SynchronizedReplay(
        num_cameras, max_dets, prefer_native=prefer_native
    )
    for camera, stamp, fb_delay, persons in load_jsonl_messages(path):
        replay.push(camera, stamp, fb_delay, persons)
        yield from replay.pop_frames()
