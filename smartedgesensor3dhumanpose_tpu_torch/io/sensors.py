"""Virtual smart edge sensors: close the semantic-feedback loop.

In the reference system the loop closes *through the physical sensors*: the
reprojection node publishes each camera's feedback with the camera's ORIGINAL
frame stamp echoed in the header
(/root/reference/pose_reprojection/src/skeleton_reproj_mult_node.cpp:157-159,
233-234), the EdgeTPU sensor measures the loop age
`fb_delay = receive_time - orig_stamp` and reports it on its next
Person2DList (/root/reference/person_msgs/msg/Person2DList.msg:2). That
measured value — not a constant — is what drives the tracker's prediction
horizon (pose_prior_mult_node.cpp:513-531).

This module simulates those sensors so a replay genuinely closes the loop:
each `VirtualSensorArray` camera receives the pipeline's `Reprojection2D`
feedback after a configurable network latency, measures the delay from the
echoed original stamps, and surfaces it for the camera's next captured
frame. `run_closed_loop` wires it around the pipeline step — the
`fb_delay` entering frame t is the value the sensors actually measured from
earlier frames' feedback, replacing io.synthetic's open-loop constant.

Time is the scene clock (frame stamps), so the loop is deterministic and
testable: injecting a processing+network latency L makes the tracker's
`pred_delta_t` converge to exactly L within the reference's 3-frame moving
window.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch.convert import tree_to
from smartedgesensor3dhumanpose_tpu_torch.types import Frame


@dataclasses.dataclass
class VirtualSensorArray:
    """One simulated edge sensor per camera.

    Args:
      num_cameras: number of sensors.
      network_latency: seconds between the pipeline emitting feedback and
        the sensor receiving it (downlink transport; the reference's sensors
        sit on a real network).
    """

    num_cameras: int
    network_latency: float = 0.0

    def __post_init__(self):
        # In-flight feedback per camera: (arrival_time, measured_delay).
        self._pending: List[List[Tuple[float, float]]] = [
            [] for _ in range(self.num_cameras)
        ]
        # Latest measurement known to each sensor; -1 = unmeasured (the
        # reference wire value before the first feedback arrives — the
        # tracker then falls back to its configured default horizon).
        self._last = np.full((self.num_cameras,), -1.0, np.float64)
        self.n_received = 0

    def receive_feedback(
        self, orig_stamp: np.ndarray, emit_time: float
    ) -> None:
        """The pipeline published per-camera feedback at `emit_time`.

        orig_stamp: [C] the original capture stamps echoed on each camera's
        feedback message (Reprojection2D.orig_stamp). Each sensor receives
        its message network_latency later and measures
        fb_delay = arrival - orig_stamp (the sensor-side measurement the
        reference's Person2DList.fb_delay field carries).
        """
        orig_stamp = np.asarray(orig_stamp, np.float64)
        if orig_stamp.shape != (self.num_cameras,):
            raise ValueError(
                f"orig_stamp shape {orig_stamp.shape} != ({self.num_cameras},)"
            )
        arrival = float(emit_time) + self.network_latency
        for c in range(self.num_cameras):
            self._pending[c].append(
                (arrival, arrival - float(orig_stamp[c]))
            )
        self.n_received += 1

    def measured_fb_delay(self, capture_time: np.ndarray) -> np.ndarray:
        """fb_delay each sensor attaches to a frame captured at these times.

        capture_time: [C] per-camera capture stamps (or a scalar). Feedback
        still in flight (arrival after the capture) is not yet known to the
        sensor; the newest arrived measurement wins.

        Returns [C] float64, -1 where no feedback has arrived yet.
        """
        t = np.broadcast_to(
            np.asarray(capture_time, np.float64), (self.num_cameras,)
        )
        for c in range(self.num_cameras):
            arrived = [p for p in self._pending[c] if p[0] <= t[c]]
            if arrived:
                self._last[c] = arrived[-1][1]
                self._pending[c] = [
                    p for p in self._pending[c] if p[0] > t[c]
                ]
        return self._last.copy()


class ClosedLoopReport(NamedTuple):
    pred_delta_t: np.ndarray      # [T] tracker prediction horizon per frame
    fb_delay_measured: np.ndarray  # [T, C] fb_delay actually fed in
    n_feedback_received: int


def run_closed_loop(
    step_fn: Callable,
    state,
    frames: Frame,
    sensors: VirtualSensorArray,
    processing_latency: float = 0.0,
    collect_outputs: bool = False,
):
    """Replay `frames` with the feedback loop CLOSED through virtual sensors.

    Per frame: (1) the sensors report the fb_delay they have measured from
    previously received feedback (overriding whatever open-loop value the
    Frame carried), (2) the pipeline steps, (3) its Reprojection2D feedback —
    carrying each camera's echoed original stamp — is delivered back to the
    sensors at `pivot_stamp + processing_latency` on the scene clock.

    The total injected loop latency is therefore
    `processing_latency + sensors.network_latency`, and the tracker's
    pred_delta_t must converge to it.

    Args:
      step_fn: (state, frame) -> (state, StepOutput), e.g. Pipeline.step.
      frames: Frame with a leading time axis, on the pipeline's device.
      processing_latency: capture->feedback-emission latency on the scene
        clock (the reference's sync + compute time; a constant keeps the
        replay deterministic).
      collect_outputs: also return the per-frame StepOutputs, on the CPU.

    Each frame's horizon, pivot stamp and echoed stamps reach the host in
    one device-to-host copy (in float64, which holds every value exactly).

    Returns:
      (final_state, last_out, ClosedLoopReport[, outputs]).
    """
    n = int(frames.kp2d.shape[0])
    fb_like = frames.fb_delay
    stamps = frames.cam_stamp.detach().cpu().numpy().astype(np.float64)

    pred = np.zeros((n,), np.float64)
    fed = np.zeros((n, sensors.num_cameras), np.float64)
    outputs = [] if collect_outputs else None
    out = None
    for i in range(n):
        fb = sensors.measured_fb_delay(stamps[i])
        fed[i] = fb
        fr = Frame(*(a[i] for a in frames))._replace(
            fb_delay=torch.as_tensor(fb, dtype=fb_like.dtype, device=fb_like.device)
        )
        state, out = step_fn(state, fr)
        reads = torch.cat([
            out.pred_delta_t.reshape(1).double(),
            out.pivot_stamp.reshape(1).double(),
            out.feedback.orig_stamp.double(),
        ]).cpu().numpy()
        pred[i] = reads[0]
        sensors.receive_feedback(reads[2:], float(reads[1]) + processing_latency)
        if collect_outputs:
            outputs.append(tree_to(out, "cpu"))

    report = ClosedLoopReport(
        pred_delta_t=pred,
        fb_delay_measured=fed,
        n_feedback_received=sensors.n_received,
    )
    if collect_outputs:
        return state, out, report, outputs
    return state, out, report
