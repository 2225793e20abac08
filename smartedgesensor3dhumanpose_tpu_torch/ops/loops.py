"""A loop that stops on a device value: the port's `lax.while_loop` with a
static bound on its trips.

The JAX package runs two such loops on the device: the LM iteration
(`prior.optimize`) and the track-merge fixpoint (`tracking._merge_tracks`).
`while_loop(cond, body, carry, max_trips)` is their counterpart here (on
CUDA the tree solver's LM is one kernel launch instead, ops/lm_prior.py).

Eagerly (on the CPU, or on CUDA outside a capture) it tests `cond(carry)`
on the host before each trip, as a Python `while` does.

While the current stream captures a CUDA graph (`linalg.capturing`;
graphs.py) no host may read a device value. The loop is then one CUDA-graph
WHILE conditional node (csrc/graph_loop.cu): its first test is computed on
the device before the node, one trip is captured as the node's body with
the next test at its end, and on a replay the device runs the body while
the test holds, at most `max_trips` times. A replay runs the trips the
eager loop runs; a trip that does not run costs nothing.

The carry lives in tensors allocated before the node, and the body writes
them in place (a body that returns its carry's own tensors adds no copy). A tensor allocated inside the body never leaves it:
where the device runs the body no time, that memory holds whatever it
held before. Each captured graph has its own `Bodies`: the stream its loops'
bodies capture on and the memory pool they allocate from, kept as long as
the graph (graphs.py). The loops of one graph run one after another and
may share that pool; no two graphs share one, so graphs replayed at once
on several streams of a card (parallel/sharding.py) never write each
other's loop memory.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from smartedgesensor3dhumanpose_tpu_torch import _kernels, tracing
from smartedgesensor3dhumanpose_tpu_torch.ops import linalg

# A WHILE node captured while a tracer records (tracing.py) gives it the
# trips the node's last replay ran (int32) and the device clock at the
# loop's start and at the end of each trip run (ns, int64 [max_trips + 1]),
# which each replay rewrites (`Tracer.trip_log`), and the number of nodes
# its body holds, one trip's kernels and copies with the trip's test (the
# counter `loop.body_nodes`). A profiler trace of a replay may miss some of
# a loop body's kernels; these records do not.

# The Bodies of the graph being captured (`capturing_into`), else None.
_current = None


class Bodies:
    """The stream that the loop bodies of one graph capture on and the
    memory pool they allocate from (its own, released when the last
    reference to this object goes). Made before the graph's capture, with
    the kernel library loaded, so that none of it is first done while a
    stream captures."""

    def __init__(self, device: torch.device, capture_stream: torch.cuda.Stream):
        _kernels.library()
        self.device = device
        with torch.cuda.device(device):
            # torch hands out its streams round robin from a fixed set: the
            # body must not capture on the stream that captures the graph.
            self.stream = torch.cuda.Stream(device)
            while self.stream.cuda_stream == capture_stream.cuda_stream:
                self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.MemPool()


@contextlib.contextmanager
def capturing_into(bodies: Bodies):
    """The loops captured in this block take their bodies' stream and
    memory from `bodies`."""
    global _current
    saved, _current = _current, bodies
    try:
        yield
    finally:
        _current = saved


@contextlib.contextmanager
def _allocating_to(pool, device: torch.device):
    """Route the current stream's allocations to `pool` (the graph's own
    pool does not serve a stream that captures into another graph). Each
    routing holds a reference to the pool until it ends, as
    `torch.cuda.use_mem_pool` does."""
    torch._C._cuda_beginAllocateCurrentStreamToPool(device.index, pool.id)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(device.index, pool.id)
        torch._C._cuda_releasePool(device.index, pool.id)


class _Trip:
    """The body of a WHILE node being captured: `repeat_while(pred)` ends
    it with the test of the next trip."""

    def __init__(self, handle: int, trips: torch.Tensor, max_trips: int, stamps, stream):
        self.handle, self.trips, self.max_trips = handle, trips, max_trips
        self.stamps, self.stream = stamps, stream
        self.tested = False

    def repeat_while(self, pred: torch.Tensor) -> None:
        err = _kernels.library().ses3d_loop_next(
            self.stream.cuda_stream, self.handle, pred.data_ptr(),
            self.trips.data_ptr(), self.max_trips, self.stamps)
        _kernels.check(err, "while node: the trip's test")
        self.tested = True


@contextlib.contextmanager
def _while_node(pred: torch.Tensor, max_trips: int):
    """Capture the block as the body of a WHILE node that the device
    enters while `pred` (0-d bool, computed before the node) holds; the
    block ends with `repeat_while(next pred)` on the yielded _Trip."""
    dev = pred.device
    bodies = _current
    if bodies is None or bodies.device != dev:
        raise RuntimeError(f"a loop on {dev} captured outside graphs.CapturedFunction's capture "
                           "for that device")
    stream, pool = bodies.stream, bodies.pool
    lib = _kernels.library()
    trips = torch.empty((), dtype=torch.int32, device=dev)
    stamps = None
    tracer = tracing.active()
    if tracer is not None:
        # Written by the node's kernels on every replay (stamps[0] and one
        # per trip run); `empty` adds no node to the graph.
        stamps = torch.empty(max_trips + 1, dtype=torch.int64, device=dev)
        tracer.loop(trips, stamps, "while")
        stamps = stamps.data_ptr()
    handle = ctypes.c_ulonglong(0)
    err = lib.ses3d_loop_begin(
        torch.cuda.current_stream(dev).cuda_stream, pred.data_ptr(), trips.data_ptr(),
        max_trips, stamps, stream.cuda_stream, ctypes.byref(handle))
    _kernels.check(err, "while node: begin")
    trip = _Trip(handle.value, trips, max_trips, stamps, stream)
    try:
        with torch.cuda.stream(stream), _allocating_to(pool, dev):
            yield trip
        if not trip.tested:
            raise RuntimeError("a while node's body must end with repeat_while")
    finally:
        nodes = ctypes.c_ulonglong(0)
        err = lib.ses3d_loop_end(stream.cuda_stream, ctypes.byref(nodes))
    _kernels.check(err, "while node: end")
    if tracer is not None:
        tracer.count("loop.body_nodes", nodes.value, tracer.loops[-1].stage)


def while_loop(cond, body, carry: tuple, max_trips: int) -> tuple:
    """`carry = body(carry)` while `cond(carry)` holds, at most `max_trips`
    times; returns the last carry.

    `carry` is a tuple of tensors, `body` returns a tuple of the same
    shapes and dtypes, and `cond` returns a 0-d bool tensor. Eagerly the
    test runs on the host. While a CUDA graph is captured the loop is a
    WHILE node on the device (module docstring) and the result lies in
    copies of `carry` that the body writes in place; both give the same
    carry bit for bit. The loop itself never writes the caller's tensors;
    a body that updates its carry in place writes them when the loop runs
    eagerly.
    """
    if not linalg.capturing(carry[0]):
        for _ in range(max_trips):
            if not bool(cond(carry)):
                break
            carry = body(carry)
        return carry
    carry = tuple(t.clone() for t in carry)
    with _while_node(cond(carry), max_trips) as trip:
        for dst, src in zip(carry, body(carry), strict=True):
            if src is not dst:  # a body may update its carry in place
                dst.copy_(src)
        trip.repeat_while(cond(carry))
    return carry
