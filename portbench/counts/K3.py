"""Kernel K3 (csrc/tracker_scan.cu, the offline tracker scan) over one
sequence: per frame the fusion's joints and the smoothed joints, roots,
heights, flags and frame scalars read once, the tracker state read and
written once, the published joints, masks and ids written once; the
operations these frames need: each valid person's cost against every
track slot, its JV searches (at most n + 1 steps of n lanes), the
per-joint velocity update, and the [T, T] merge distances on frames with
detections. Copied from chip_smoke.py's `k3_bound`; the valid persons
and detection frames are counted on the sequence the reference tracks.
"""

from portbench.lib.peaks import bound_ms

# The kernel's names in a device trace.
TRACE_NAMES = ("tracker_scan_kernel",)

JOINTS = 21


def nbytes(frames: int, persons: int, slots: int, window: int) -> int:
    f, p, k = frames, persons, JOINTS
    inputs = (f * p * k * 3 * 4 * 2 + f * p * (3 + 1) * 4 + f * p * k * 2 + f * p * 2
              + f * 5 * 4 + k * 4)
    # estimate, est_exists, vel_buffer, t_prev, height_prev, root_prev,
    # alive, track_id, num_obs, and the frame counter.
    state = (slots * k * 3 * 4 + slots * k + slots * k * window * 3 * 4 + slots * 4 + slots * 4
             + slots * 3 * 4 + slots + slots * 4 + slots * 4 + 4)
    outputs = f * p * k * 3 * 4 + f * p * (1 + 4) + f * 4
    return inputs + 2 * state + outputs


def ops(slots: int, window: int, valid_persons: int, detection_frames: int) -> int:
    t, k = slots, JOINTS
    return (valid_persons * t * k * 19
            + valid_persons * (t + 1) * t * 4
            + valid_persons * k * 3 * (8 + window)
            + detection_frames * t * (t - 1) // 2 * k * 16)


def bound(frames, persons, slots, window, valid_persons, detection_frames) -> float:
    """Milliseconds one launch needs at the least."""
    return bound_ms(nbytes(frames, persons, slots, window),
                    ops(slots, window, valid_persons, detection_frames))
