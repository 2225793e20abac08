"""Runtime observability: the reference's warning taxonomy, structured.

The reference surfaces pipeline health through ROS_WARN/cout messages users
are told to watch (README.md:49): large frame delay
(skeleton_3d_triang_mult_node.cpp:1040-1042), backwards time / reused
messages (:1043-1046), stale-camera removal (:1049-1056), large reprojection
down-weighting (:840-843), sync out-of-order / bound violations
(approximate_time_vec.h:156-167), new tracks (pose_prior_mult_node.cpp:577)
and track merges (:873). This module recomputes the same conditions
host-side from Frame/StepOutput data and emits structured events through
standard logging — without touching the hot path. The same checks as the
JAX package's `monitor`; tensors, on any device, are read on the host.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np

from smartedgesensor3dhumanpose_tpu_torch.convert import host

logger = logging.getLogger("smartedgesensor3dhumanpose_tpu_torch")


@dataclasses.dataclass
class Event:
    kind: str
    message: str
    data: dict

    def log(self):
        logger.warning("%s: %s %s", self.kind, self.message, self.data)


class PipelineMonitor:
    """Stateful per-frame health checks (host side, NumPy only).

    Call `check_frame` before stepping (gives the reference's skip-frame
    verdict) and `check_output` after.
    """

    def __init__(
        self,
        max_frame_delay: float = 0.17,  # (:1040)
        max_sync_diff: float = 0.067,   # (:64)
        emit_log: bool = True,
    ):
        self.max_frame_delay = max_frame_delay
        self.max_sync_diff = max_sync_diff
        self.emit_log = emit_log
        self.last_stamp: Optional[float] = None
        self.known_ids: set = set()
        self.events: List[Event] = []

    def _emit(self, kind, message, **data):
        ev = Event(kind, message, data)
        self.events.append(ev)
        if self.emit_log:
            ev.log()
        return ev

    def check_frame(self, cam_stamp: np.ndarray) -> bool:
        """Pre-step guards. Returns False when the frame should be skipped
        (re-used message / jumped backwards in time, :1043-1046)."""
        cam_stamp = host(cam_stamp)
        pivot = float(cam_stamp.max())
        process = True
        if self.last_stamp is not None:
            delta = pivot - self.last_stamp
            if delta > self.max_frame_delay:
                self._emit(
                    "large_frame_delay",
                    f"delta_t = {delta:.3f}s (should be < "
                    f"{self.max_frame_delay}s)",
                    delta_t=delta,
                )
            if delta <= 0.0:
                self._emit(
                    "non_monotonic_frame",
                    "re-using message or jumped backwards in time; "
                    "frame not processed",
                    delta_t=delta,
                )
                process = False
        if process:
            self.last_stamp = pivot
        stale = (pivot - cam_stamp) > self.max_sync_diff
        for i in np.nonzero(stale)[0]:
            self._emit(
                "stale_camera_removed",
                f"camera {i} lags the pivot by "
                f"{(pivot - cam_stamp[i]) * 1e3:.1f}ms; removed for this "
                "frame",
                camera=int(i),
                lag_s=float(pivot - cam_stamp[i]),
            )
        return process

    def check_output(self, out) -> None:
        """Post-step events: new tracks (the published id set grew) and
        fixed-slot capacity overflow (people silently lost this frame —
        the reference grows its hypothesis/track vectors unboundedly,
        skeleton_3d_triang_mult_node.cpp:662-673 /
        pose_prior_mult_node.cpp:570-580, so it never drops; here the
        padded capacity must be raised when this fires)."""
        valid = host(out.fused.valid)
        ids = set(host(out.fused.person_id)[valid].tolist())
        for new in sorted(ids - self.known_ids):
            self._emit("track_published", f"track {new} now published",
                       track_id=int(new))
        self.known_ids |= ids
        n_hyp = int(host(out.n_dropped_hypotheses))
        if n_hyp > 0:
            self._emit(
                "hypothesis_overflow",
                f"{n_hyp} hypothesis spawns dropped: frame exceeds "
                "max_hypotheses slots; people may be missing — raise "
                "FusionConfig.max_hypotheses",
                n_dropped=n_hyp,
            )
        n_trk = int(host(out.n_dropped_track_spawns))
        if n_trk > 0:
            self._emit(
                "track_overflow",
                f"{n_trk} track spawns dropped: every track slot alive; "
                "raise TrackerConfig.max_tracks",
                n_dropped=n_trk,
            )

    def summary(self) -> dict:
        counts: dict = {}
        for ev in self.events:
            counts[ev.kind] = counts.get(ev.kind, 0) + 1
        return counts
