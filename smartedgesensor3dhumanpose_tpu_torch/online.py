"""Online latest-wins execution: producer/consumer decoupling.

The reference decouples its synchronizer callback thread from the compute
worker with a mutex+condvar latest-frame-wins handoff
(skeleton_3d_triang_mult_node.cpp:999-1006, 1008-1086): if triangulation
falls behind the sensor rate, backlogged frames are overwritten and only the
newest synchronized set is processed. Here a producer thread feeds
synchronized frames into the native `LatestSlot` (sync.py's ctypes binding
over native/runtime.cpp) and the consumer loop drains it into the pipeline
step; drops are counted by the slot.

The producer touches no tensor: frames are indexed (or built from host
arrays) and stepped in the consumer. On CUDA the step's clock stops after
`torch.cuda.synchronize`, so `step_ms` is the device's work too and not
only the Python dispatch.

The synchronized loop keeps each stepped set's timeline on the host clock
(`OnlineSyncedReport.sets`, `SET_SPANS`); while a tracer records
(tracing.py) it records the same spans there, tied to the set's index.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch import sync as sync_lib
from smartedgesensor3dhumanpose_tpu_torch import tracing
from smartedgesensor3dhumanpose_tpu_torch.pipeline import synchronize
from smartedgesensor3dhumanpose_tpu_torch.types import Frame


class OnlineReport(NamedTuple):
    processed_handles: List[int]   # frame indices actually stepped, in order
    dropped: int                   # backlog frames overwritten in the slot
    produced: int                  # frames offered by the producer
    step_ms_p50: float             # consumer step latency
    step_ms: List[float]           # per-step consumer latencies


def run_online(
    step_fn: Callable,
    state,
    frames: Frame,
    feed_interval_s: float,
    slot=None,
    consumer_hook: Optional[Callable[[int], None]] = None,
    prefer_native_slot: bool = True,
):
    """Replay `frames` (a Frame with a leading time axis) through a
    latest-wins loop.

    Args:
      step_fn: (state, frame) -> (state, out), e.g. Pipeline.step.
      frames: Frame with a leading time axis, on the pipeline's device.
      feed_interval_s: producer period (the sensor/sync output rate).
      slot: optional injected slot (for differential tests).
      consumer_hook: called once per processed frame with the handle —
        tests use this to slow the consumer and force drops.

    Returns:
      (final_state, last_out, OnlineReport)
    """
    n = int(frames.kp2d.shape[0])
    if slot is None:
        slot = sync_lib.make_latest_slot(1, prefer_native=prefer_native_slot)
    device = frames.kp2d.device
    done = threading.Event()
    # Nanosecond stamps from the pivot (newest camera) time, read in one
    # device-to-host copy before the loop.
    stamps_ns = (
        frames.cam_stamp.detach().cpu().numpy().max(axis=-1) * 1e9
    ).astype(np.int64)

    def producer():
        for i in range(n):
            slot.put([int(stamps_ns[i])], [i])
            time.sleep(feed_interval_s)
        done.set()

    th = threading.Thread(target=producer, daemon=True)

    processed: List[int] = []
    lat: List[float] = []
    out = None
    th.start()
    while True:
        got = slot.take()
        if got is None:
            if done.is_set():
                # done.set() happens after the final put, so one more take
                # drains a frame published between our empty take and the
                # done check; a second empty take means truly finished.
                got = slot.take()
                if got is None:
                    break
            else:
                time.sleep(feed_interval_s / 20.0)
                continue
        _, (handle,) = got
        handle = int(handle)
        fr = Frame(*(a[handle] for a in frames))
        t0 = time.perf_counter()
        state, out = step_fn(state, fr)
        synchronize(device)
        lat.append(time.perf_counter() - t0)
        processed.append(handle)
        if consumer_hook is not None:
            consumer_hook(handle)
    th.join()
    report = OnlineReport(
        processed_handles=processed,
        dropped=int(slot.dropped),
        produced=n,
        step_ms_p50=float(np.median(lat) * 1e3) if lat else 0.0,
        step_ms=[t * 1e3 for t in lat],
    )
    return state, out, report


class OnlineSyncedReport(NamedTuple):
    processed_frames: int       # frames actually stepped on device
    frames_synced: int          # synchronized sets the policy emitted
    produced_messages: int      # per-camera messages offered
    # Messages that never appeared in an emitted set: sync-policy drops
    # (queue overflow / candidate invalidation) plus the tail still
    # buffered when the stream ended.
    messages_unconsumed: int
    slot_dropped: int           # synchronized frames overwritten (latest-wins)
    step_ms_p50: float          # step wall latency
    e2e_ms_p50: float           # newest-contributing-message arrival -> step done
    step_ms: List[float]
    e2e_ms: List[float]
    # One row per stepped set, in step order: the set's index, then the
    # host clock (perf_counter ns) at the push of its newest message (as
    # the loop hands it to the synchronizer), the
    # synchronizer's pop, the end of packing (the slot's put), the slot's
    # take, the step's entry (the frame built) and the return of the
    # synchronize after the step. Span k of SET_SPANS runs from stamp k to
    # stamp k + 1, so the five tile the set's end-to-end latency.
    sets: np.ndarray


# The spans of a stepped set, in order (OnlineSyncedReport.sets).
SET_SPANS = ("sync.hold", "sync.pack", "slot", "frame.build", "step")

_FLOAT_FIELDS = ("kp2d", "cov2d", "det_score", "fb_delay")


def default_frame_builder(fd: dict, device="cuda", dtype=torch.float32) -> Frame:
    """A SynchronizedReplay frame dict as a Frame on `device`: keypoints,
    covariances, scores and delays in `dtype`, stamps in float32 (as
    Frame.from_arrays casts them)."""
    frame = Frame.from_arrays(fd, device)
    return frame._replace(**{k: getattr(frame, k).to(dtype) for k in _FLOAT_FIELDS})


def run_online_synced(
    step_fn: Callable,
    state,
    messages: Iterable[Tuple[int, float, float, list]],
    num_cameras: int,
    max_dets: int,
    message_interval_s: float = 0.0,
    frame_builder: Callable[[dict], Frame] = default_frame_builder,
    slot=None,
    consumer_hook: Optional[Callable[[int], None]] = None,
    prefer_native: bool = True,
):
    """LIVE single-process loop: per-camera messages -> native
    ApproximateTimeSync -> latest-wins slot -> pipeline step.

    This is the reference node's full live topology in one process
    (skeleton_3d_triang_mult_node.cpp:1216-1224: subscriber callbacks feed
    the sync policy, synchronized sets land in the mutex+condvar latest-wins
    handoff at :999-1025, the worker thread computes): a producer thread
    pushes raw per-camera messages through the C++ synchronizer, packs each
    emitted set, and offers it to the native LatestSlot; the consumer drains
    the newest set into the step. Backlog is dropped at the slot (counted),
    and messages the sync policy never emits (overflow drops / stream tail)
    are counted too.

    Args:
      step_fn: (state, frame) -> (state, out), e.g. Pipeline.step.
      messages: iterable of (camera, stamp_s, fb_delay, persons) in arrival
        order — e.g. io.replay.load_jsonl_messages(path).
      message_interval_s: producer sleep between messages (the live sensor
        message rate; 0 = as fast as possible).
      frame_builder: packs a synchronized frame dict into a Frame on the
        pipeline's device (the default puts it on the card; pass e.g.
        `lambda fd: default_frame_builder(fd, "cpu")` otherwise). It runs
        in the consumer.

    Returns:
      (final_state, last_out, OnlineSyncedReport)
    """
    from smartedgesensor3dhumanpose_tpu_torch.io import replay as replay_lib

    if slot is None:
        slot = sync_lib.make_latest_slot(1, prefer_native=prefer_native)
    replay = replay_lib.SynchronizedReplay(
        num_cameras, max_dets, prefer_native=prefer_native
    )
    done = threading.Event()
    frame_store: List[dict] = []
    # Per emitted set (host clock, ns): its newest message's push, the
    # synchronizer's pop, the end of packing.
    produced: List[tuple] = []
    push_ns = {}
    counts = {"messages": 0, "frames": 0}
    now = time.perf_counter_ns

    def producer():
        for camera, stamp, fb_delay, persons in messages:
            pushed = now()
            handle = replay.push(camera, stamp, fb_delay, persons)
            push_ns[handle] = pushed
            counts["messages"] += 1
            while (got := replay.sync.pop()) is not None:
                popped = now()
                fd = replay._pack(*got)
                # Arrival time of the newest contributing message: the
                # synchronized set cannot exist before it.
                arr = max(push_ns.pop(h, popped) for h in fd["handles"])
                idx = len(frame_store)
                frame_store.append(fd)
                counts["frames"] += 1
                pivot_ns = int(np.max(fd["cam_stamp"]) * 1e9)
                produced.append((arr, popped, now()))
                slot.put([pivot_ns], [idx])
            if message_interval_s > 0:
                time.sleep(message_interval_s)
        done.set()

    th = threading.Thread(target=producer, daemon=True)

    sets: List[tuple] = []
    out = None
    tracer = tracing.active()
    th.start()
    while True:
        got = slot.take()
        taken = now()
        if got is None:
            if done.is_set():
                got = slot.take()  # drain a frame racing the done flag
                taken = now()
                if got is None:
                    break
            else:
                time.sleep(max(message_interval_s, 1e-4) / 4.0)
                continue
        _, (idx,) = got
        idx = int(idx)
        fr = frame_builder(frame_store[idx])
        if tracer is not None:
            span = tracer.open("step", rid=idx)
        t0 = now()
        state, out = step_fn(state, fr)
        synchronize(fr.kp2d.device)
        t1 = now()
        row = (idx, *produced[idx], taken, t0, t1)
        sets.append(row)
        if tracer is not None:
            tracer.close(span, t1, start=t0)
            for k, name in enumerate(SET_SPANS[:-1]):
                tracer.span(name, row[k + 1], row[k + 2], rid=idx, parent=-1)
        if consumer_hook is not None:
            consumer_hook(idx)
    th.join()

    table = np.array(sets, dtype=np.int64).reshape(-1, 2 + len(SET_SPANS))
    step_lat = (table[:, 6] - table[:, 5]) * 1e-9
    e2e_lat = (table[:, 6] - table[:, 1]) * 1e-9
    processed = len(table)
    report = OnlineSyncedReport(
        processed_frames=processed,
        frames_synced=counts["frames"],
        produced_messages=counts["messages"],
        messages_unconsumed=(
            counts["messages"] - counts["frames"] * num_cameras
        ),
        slot_dropped=int(slot.dropped),
        step_ms_p50=float(np.median(step_lat) * 1e3) if processed else 0.0,
        e2e_ms_p50=float(np.median(e2e_lat) * 1e3) if processed else 0.0,
        step_ms=[float(t) * 1e3 for t in step_lat],
        e2e_ms=[float(t) * 1e3 for t in e2e_lat],
        sets=table,
    )
    return state, out, report
