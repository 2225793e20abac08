"""The port's one recorder of spans and counters, on one clock.

A `Tracer` keeps, in memory allocated when it is made, the spans that the
port records at its layer boundaries and the counters it records beside
them, and hands them over only when its owner asks (`drain`): nothing is
logged or written per record.

- A span has a name, a start and an end, the span it lies in (`parent`,
  an index into the same records, -1 for none) and a request id (`rid`):
  the set's index in the live loop, the call's index offline. Counters
  carry a name, a value, the scope they count in and a request id.
- Host spans are taken on the host's monotonic clock
  (`time.perf_counter_ns`). The live loop (online.run_online_synced)
  records each stepped set's `sync.hold`, `sync.pack`, `slot`,
  `frame.build` and `step`; `graphs.CapturedFunction` records
  `graph.copy_in`, `graph.replay` (the launch call) and `graph.copy_out`.
  Both record only into the tracer that is active (`with tracer:` or
  `recording`); with none active a call costs a `None` test.
- Stage marks (`StageMarks`) are written by the entry points of a
  `Pipeline(..., trace=True)`: on CUDA a one-thread kernel per mark
  (csrc/graph_loop.cu `ses3d_stage_mark`) writes the device clock
  (%globaltimer, ns) into a ring of rows on the device, one row per call;
  the call's first mark advances the row, so a replayed graph needs no
  host sync and no copy to the host. The ring is read at `drain`. On the
  CPU, which runs synchronously, a mark takes the host clock. Each row
  becomes a span named after the entry point (first mark to last mark)
  and one child span per stage. While a graph is captured, each mark
  also counts the kernel nodes captured before it: `<stage>.kernels`
  counters. Code inside a stage may add a counter of its own there
  (`note`): `<stage>.<name>` under the top-level stage, taken at capture
  (on the CPU, where nothing is captured, at each call), e.g.
  `fusion.triangulation.f1`, the hypotheses kernel F1 triangulates per
  call, and `fusion.association.scan_steps`, the camera scan's steps.
- Loops captured while a tracer is active (ops/loops.py WHILE nodes, the
  LM's one launch in ops/lm_prior.py) keep their trips and the device
  clock of each trip in tensors that every replay rewrites (`trip_log`);
  a drain turns the last replay's into `loop` spans (and `loop.trip`
  spans for WHILE nodes) inside the stage that holds the loop. A WHILE
  body's node count is the counter `loop.body_nodes`.

One clock: entering a tracer and draining it each take a calibration
point from the device clock to the host clock (a one-thread kernel
answers a flag that the host sets in pinned memory, as an NTP exchange:
the offset from the shortest of five round trips) and from the host clock
to the unix clock in ns. Between the two points offset and drift are
interpolated, and a drained record's times are on the unix clock.
torch.profiler's events are on the unix clock too, but converted from the
CPU's time-stamp counter at a rate it estimates, which may stray by
hundreds of ppm; so while a profiler records, entering and draining also
leave `ANCHOR` ranges in its trace, and `on_profiler_clock` moves drained
records onto the trace's own timeline through them.

Records are taken by one thread at a time (the live loop's consumer).
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

SPAN_DTYPE = np.dtype([("name", "U40"), ("start", "i8"), ("end", "i8"), ("parent", "i8"),
                       ("rid", "i8"), ("device", "?")])
COUNTER_DTYPE = np.dtype([("name", "U40"), ("value", "i8"), ("scope", "U40"), ("rid", "i8")])

# The label of a call's last mark (StageMarks.call adds it).
END = "end"
# The profiler range a tracer leaves at each calibration point.
ANCHOR = "tracing.clock"
# Columns of a StageMarks ring: the most marks one call may take. Its rows:
# the calls a drain can read back.
MAX_MARKS = 16
RING_ROWS = 4096
# Host spans a Tracer keeps between two drains; past it a span is dropped
# and counted.
CAPACITY = 1 << 16

_ACTIVE = None   # the Tracer that host spans are recorded into, else None
_MARKS = None    # the StageMarks of the entry point running now, else None


def active():
    """The tracer that records now, or None."""
    return _ACTIVE


@contextlib.contextmanager
def recording(tracer):
    """Make `tracer` the one that records in this block (no calibration)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, tracer
    try:
        yield tracer
    finally:
        _ACTIVE = saved


class Records(NamedTuple):
    """What a drain hands over: times in unix ns (torch.profiler's clock)."""

    spans: np.ndarray      # SPAN_DTYPE; `parent` indexes this array
    counters: np.ndarray   # COUNTER_DTYPE
    calibration: dict      # the clock points the times were mapped with
    dropped: int           # host spans that found the buffer full


class _Loop(NamedTuple):
    trips: torch.Tensor    # int32 0-d: trips of the last replay
    stamps: torch.Tensor   # int64 [max_trips + 1]: device clock, ns
    kind: str              # "while" (a stamp per trip) or "lm" (start, end)
    marks: object          # the StageMarks being captured, or None
    stage: str             # the stage open at capture, or ""


def _host_to_unix_point() -> tuple:
    """(host ns, unix ns, width ns) of the tightest of five readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[2]:
            best = ((a + b) // 2, u, b - a)
    return best


def _device_to_host_point(device: torch.device) -> tuple:
    """(host ns, device ns, round trip ns, each probe's device ns at its
    kernel's start): five exchanges with a one-thread kernel that waits for
    a flag the host sets in pinned memory and answers with %globaltimer;
    the shortest round trip's midpoint."""
    from smartedgesensor3dhumanpose_tpu_torch import _kernels

    lib = _kernels.library()
    best, answers = None, []
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        for _ in range(5):
            flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
            reply = torch.zeros(4, dtype=torch.int64, pin_memory=True)
            f, r = flag.numpy(), reply.numpy()
            err = lib.ses3d_clock_probe(stream.cuda_stream, flag.data_ptr(), reply.data_ptr(),
                                        1_000_000_000)
            _kernels.check(err, "clock probe launch")
            deadline = time.perf_counter_ns() + 10_000_000_000
            while r[2] == 0 and time.perf_counter_ns() < deadline:
                pass
            t1 = time.perf_counter_ns()
            f[0] = 1
            while r[1] == 0 and time.perf_counter_ns() < deadline:
                pass
            t2 = time.perf_counter_ns()
            stream.synchronize()
            if r[1] != 1:
                raise RuntimeError("the clock probe kernel did not answer")
            answers.append(int(r[3]))
            if best is None or t2 - t1 < best[2]:
                best = ((t1 + t2) // 2, int(r[0]), t2 - t1)
    return (*best, answers)


def _line(points, src: int, dst: int):
    """Map values on clock `src` to clock `dst` through calibration points
    (tuples indexed by clock): offset and drift from the first and last."""
    (a0, b0), (a1, b1) = (points[0][src], points[0][dst]), (points[-1][src], points[-1][dst])
    if a1 == a0:
        return lambda v: np.asarray(v, np.int64) + (b0 - a0)
    rate = (b1 - b0) / (a1 - a0)
    return lambda v: b0 + np.round((np.asarray(v, np.int64) - a0) * rate).astype(np.int64)


class Tracer:
    """The recorder (module docstring). `device`: the card whose clock the
    stage marks of this tracer's rings read (None or a CPU device: no
    device clock)."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        capacity = CAPACITY
        self._names: dict = {}
        self._name_list: list = []
        self._name = np.zeros(capacity, np.int32)
        self._start = np.zeros(capacity, np.int64)
        self._end = np.zeros(capacity, np.int64)
        self._parent = np.full(capacity, -1, np.int64)
        self._rid = np.full(capacity, -1, np.int64)
        self._n = 0
        self._open: list = []
        self._counters: list = []
        self.dropped = 0
        self.rings: list = []    # StageMarks that write into this tracer
        self.loops: list = []    # _Loop records of captured loops
        self._points: list = []  # calibration points: (host, unix, device)
        self._anchors: list = []  # (point, host ns before, after) of ANCHOR ranges
        self._probes: list = []   # (point, device ns) of clock probes a profiler saw
        self._saved: list = []

    # ------------------------------------------------------------ host --

    def _id(self, name: str) -> int:
        i = self._names.get(name)
        if i is None:
            i = self._names[name] = len(self._name_list)
            self._name_list.append(name)
        return i

    def span(self, name: str, start: int, end: int, rid=None, parent=None) -> int:
        """Record a finished host span (perf_counter ns); returns its index,
        or -1 where the buffer is full. `parent` defaults to the innermost
        open span, `rid` to the parent's."""
        i = self._n
        if i >= CAPACITY:
            self.dropped += 1
            return -1
        if parent is None:
            parent = self._open[-1] if self._open else -1
        if rid is None:
            rid = self._rid[parent] if parent >= 0 else -1
        self._name[i], self._start[i], self._end[i] = self._id(name), start, end
        self._parent[i], self._rid[i] = parent, rid
        self._n = i + 1
        return i

    def open(self, name: str, rid=None, start=None) -> int:
        """Open a span that later spans nest in; close it with `close`."""
        i = self.span(name, time.perf_counter_ns() if start is None else start, -1, rid)
        self._open.append(i)
        return i

    def close(self, i: int, end=None, start=None) -> None:
        """Close span `i` (now, or at `end`); `start` moves its start."""
        if not self._open or self._open[-1] != i:
            raise RuntimeError("spans close innermost first")
        self._open.pop()
        if i >= 0:
            self._end[i] = time.perf_counter_ns() if end is None else end
            if start is not None:
                self._start[i] = start

    def count(self, name: str, value: int, scope: str = "") -> None:
        """Record a counter: `value` of `name` in `scope` (a stage or an
        entry point), tied to the innermost open span's request."""
        rid = self._rid[self._open[-1]] if self._open and self._open[-1] >= 0 else -1
        self._counters.append((name, int(value), scope, int(rid)))

    # ----------------------------------------------------------- loops --

    def loop(self, trips: torch.Tensor, stamps: torch.Tensor, kind: str) -> None:
        """A captured loop's trip record (ops/loops.py, ops/lm_prior.py)."""
        marks = _MARKS
        self.loops.append(_Loop(trips, stamps, kind, marks,
                                marks.open_stage() if marks is not None else ""))

    def trip_log(self) -> list:
        """(trips, stamps) of every loop captured while this tracer was
        active, in capture order; each replay rewrites them."""
        return [(lp.trips, lp.stamps) for lp in self.loops]

    def body_nodes(self) -> list:
        """The node count of each WHILE body captured while active."""
        return [v for name, v, _, _ in self._counters if name == "loop.body_nodes"]

    # ----------------------------------------------------------- clock --

    def _anchor(self, point: int) -> None:
        """Three ANCHOR ranges in a running profiler's trace."""
        if not torch.autograd._profiler_enabled():
            return
        for _ in range(3):
            h0 = time.perf_counter_ns()
            with torch.profiler.record_function(ANCHOR):
                pass
            self._anchors.append((point, h0, time.perf_counter_ns()))

    def _calibrate(self, point: int) -> tuple:
        host, unix, _ = _host_to_unix_point()
        if self.device is not None and self.device.type == "cuda":
            dhost, dev, _, answers = _device_to_host_point(self.device)
            if torch.autograd._profiler_enabled():
                self._probes += [(point, g) for g in answers]
            return (host, unix, dev - dhost)  # device clock minus host clock
        return (host, unix, 0)

    def __enter__(self):
        global _ACTIVE
        if not self._saved:
            self._anchors, self._probes = [], []
            self._points = [self._calibrate(0)]
            self._anchor(0)
            for ring in self.rings:
                ring.drained = ring.calls
        self._saved.append(_ACTIVE)
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._saved.pop()
        return False

    def _device_to_host(self):
        """Device ns -> host ns, through the points' offsets (interpolated
        on the host clock)."""
        pts = self._points
        h0, d0 = pts[0][0], pts[0][2]
        h1, d1 = pts[-1][0], pts[-1][2]
        drift = 0.0 if h1 == h0 else (d1 - d0) / (h1 - h0)

        def conv(v):
            v = np.asarray(v, np.int64)
            # v = h + d0 + drift * (h - h0)  =>  h = (v - d0 + drift * h0) / (1 + drift)
            return np.round((v - d0 + drift * h0) / (1.0 + drift)).astype(np.int64)
        return conv

    # ----------------------------------------------------------- drain --

    def drain(self) -> Records:
        """Every record since the last drain (or activation), on the unix
        clock; the host buffer is emptied. Waits for the device first."""
        if self._open:
            raise RuntimeError("drain with a span still open")
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        point = self._calibrate(1)
        self._points = (self._points or [point])[:1] + [point]
        self._anchor(1)
        n = self._n
        rows = [(self._name_list[self._name[i]], self._start[i], self._end[i], self._parent[i],
                 self._rid[i], False) for i in range(n)]
        counters = list(self._counters)
        to_host = self._device_to_host()
        for ring in self.rings:
            ring.read(rows, counters, to_host)
        spans = np.array(rows, dtype=SPAN_DTYPE) if rows else np.zeros(0, SPAN_DTYPE)
        to_unix = _line(self._points, 0, 1)
        for field in ("start", "end"):
            done = spans[field] >= 0
            spans[field][done] = to_unix(spans[field][done])
        calibration = {"points": [tuple(int(x) for x in p) for p in self._points],
                       "device": None if self.device is None else str(self.device),
                       "anchors": [(k, int(to_unix(a)), int(to_unix(b)))
                                   for k, a, b in self._anchors],
                       "probes": [(k, int(to_unix(to_host(g)))) for k, g in self._probes]}
        out = Records(spans, np.array(counters, dtype=COUNTER_DTYPE), calibration, self.dropped)
        self._n, self._counters, self.dropped = 0, [], 0
        self._points, self._anchors, self._probes = [point], [], []
        return out


def on_profiler_clock(records: Records, events) -> Records:
    """`records` moved onto the timeline of a torch.profiler trace that
    was recording while they were taken (its kineto events, with `name()`,
    `start_ns()`, `duration_ns()`, `device_type()`). Host spans: each
    calibration point's ANCHOR range whose host stamps hug it closest gives
    the offset there, two points the drift too. Stage marks on a card: the
    clock probes' first reading of the device clock against the starts of
    their kernels in the trace (a mark too reads the clock first thing),
    the median at each point."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = list(events)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                    if e.name() == ANCHOR and e.device_type() == cpu)
    anchors = records.calibration["anchors"]
    if len(ranges) != len(anchors) or not anchors:
        raise ValueError(f"the trace holds {len(ranges)} {ANCHOR} ranges, the records "
                         f"{len(anchors)}")
    best = {}
    for (point, a, b), (s, e) in zip(anchors, ranges):
        slack = (b - a) - (e - s)
        if point not in best or slack < best[point][0]:
            best[point] = (slack, (a + b) // 2, (s + e) // 2)
    host_line = _line([(mine, theirs) for _, mine, theirs in best.values()], 0, 1)
    device_line = host_line
    probes = records.calibration.get("probes", [])
    if probes:
        starts = sorted(e.start_ns() for e in events
                        if e.device_type() == cuda and "clock_probe_kernel" in e.name())
        if len(starts) != len(probes):
            raise ValueError(f"the trace holds {len(starts)} clock probes, the records "
                             f"{len(probes)}")
        by_point: dict = {}
        for (point, mine), theirs in zip(probes, starts):
            by_point.setdefault(point, []).append((mine, theirs - mine))
        points = []
        for pairs in by_point.values():
            mine = int(np.median([m for m, _ in pairs]))
            points.append((mine, mine + int(np.median([o for _, o in pairs]))))
        device_line = _line(points, 0, 1)
    spans = records.spans.copy()
    marks = spans["device"] if probes else np.zeros(len(spans), bool)
    for field in ("start", "end"):
        done = spans[field] >= 0
        spans[field][done & ~marks] = host_line(spans[field][done & ~marks])
        spans[field][done & marks] = device_line(spans[field][done & marks])
    return records._replace(spans=spans)


class StageMarks:
    """The stage marks of one entry point of a traced pipeline: a ring of
    RING_ROWS rows of MAX_MARKS columns (device memory on CUDA, host memory
    on the CPU) and the host's count of the calls that wrote a row.

    The entry point runs inside `call()` and marks its stages with the
    module's `stage(name)` (a boundary: the previous top-level stage ends,
    `name` begins) and `child(name)` (a stage inside the open one); `call`
    adds the last mark. Every call must take the marks of the first."""

    def __init__(self, name: str, device, tracer: Tracer):
        self.name = name
        self.device = torch.device(device)
        self.tracer = tracer
        self.rows = rows = RING_ROWS
        self.layout = None        # the labels of a call's marks, in order
        self._stages = None       # (name, first column, last column, parent stage)
        self._seen: list = []
        self._counts: list = []   # kernel nodes captured before each mark
        self.kernels = None       # those of the last capture
        self._notes: list = []    # (name, value) of `note` in this call
        self.notes = None         # those of the last capture
        self.calls = 0            # rows written: eager calls and replays
        self.drained = 0          # rows a drain has read
        self._assoc = np.full((rows, 4), -1, np.int64)  # call, parent, rid, replayed
        if self.device.type == "cuda":
            self.ring = torch.zeros((rows, MAX_MARKS), dtype=torch.int64, device=self.device)
            self.count = torch.zeros(1, dtype=torch.int64, device=self.device)
        else:
            self.ring = np.zeros((rows, MAX_MARKS), np.int64)
        tracer.rings.append(self)

    @contextlib.contextmanager
    def call(self):
        """Run an entry point's body with its marks going to this ring."""
        global _MARKS
        saved, _MARKS = _MARKS, self
        self._seen, self._counts, self._notes = [], [], []
        try:
            yield
            self.mark(END)
        finally:
            _MARKS = saved
        if self._counts:
            self.kernels = list(self._counts)
        if self._counts or self.device.type != "cuda":
            self.notes = list(self._notes)
        if self.layout is None:
            self.layout = tuple(self._seen)
            self._stages = _stages_of(self.layout)

    def open_stage(self) -> str:
        """The innermost stage open at this point of the call."""
        for label in reversed(self._seen):
            if label == END:
                return ""
            if label.startswith("+"):
                if "-" + label[1:] not in self._seen:
                    return label[1:]
            elif not label.startswith("-"):
                return label
        return ""

    def top_stage(self) -> str:
        """The top-level stage open at this point of the call."""
        for label in reversed(self._seen):
            if label == END:
                return ""
            if label[0] not in "+-":
                return label
        return ""

    def mark(self, label: str) -> None:
        col = len(self._seen)
        if col >= MAX_MARKS:
            raise RuntimeError(f"{self.name}: more than {MAX_MARKS} stage marks in a call")
        if self.layout is not None and (col >= len(self.layout) or self.layout[col] != label):
            raise RuntimeError(f"{self.name}: mark {label!r} at {col}; the calls before took "
                               f"{self.layout}")
        self._seen.append(label)
        first = col == 0
        if self.device.type != "cuda":
            if first:
                self._new_row(replayed=False)
            self.ring[(self.calls - 1) % self.rows, col] = time.perf_counter_ns()
            return
        from smartedgesensor3dhumanpose_tpu_torch import _kernels

        captured = torch.cuda.is_current_stream_capturing()
        kernels = ctypes.c_longlong(-1)
        err = _kernels.library().ses3d_stage_mark(
            torch.cuda.current_stream(self.device).cuda_stream, self.ring.data_ptr(),
            self.count.data_ptr(), col, MAX_MARKS, self.rows, int(first),
            ctypes.byref(kernels) if captured else None)
        _kernels.check(err, f"{self.name}: stage mark {label!r}")
        if captured:
            self._counts.append(kernels.value)
        elif first:
            self._new_row(replayed=False)

    def _new_row(self, replayed: bool, parent=None) -> None:
        """The host's side of a row the device (or host) writes: its call
        number, and the span and request it belongs to while this ring's
        tracer records."""
        k = self.calls
        self.calls = k + 1
        tr = self.tracer
        if _ACTIVE is tr:
            if parent is None:
                parent = tr._open[-1] if tr._open else -1
            rid = tr._rid[parent] if parent >= 0 else -1
            self._assoc[k % self.rows] = (k, parent, rid, int(replayed))

    def replayed(self, parent=None) -> None:
        """A replay of a graph that holds this ring's marks (graphs.py)."""
        self._new_row(replayed=True, parent=parent)

    def read(self, rows: list, counters: list, to_host) -> None:
        """Append the spans of the rows written since the last read to
        `rows` (host ns) and this ring's capture counters to `counters`."""
        if self.layout is None:
            return
        ncol = len(self.layout)
        lo, hi = max(self.drained, self.calls - self.rows), self.calls
        if self.device.type == "cuda":
            done = int(self.count.item())
            if done != self.calls:
                raise RuntimeError(f"{self.name}: the device wrote {done} rows, the host "
                                   f"counted {self.calls}")
            ring = self.ring.cpu().numpy()
        else:
            ring = self.ring
        last = None
        for k in range(lo, hi):
            slot = k % self.rows
            t = ring[slot, :ncol]
            if self.device.type == "cuda":
                t = to_host(t)
            call, parent, rid, replayed = self._assoc[slot]
            if call != k:
                parent = rid = -1
                replayed = 0
            top = len(rows)
            rows.append((self.name, t[0], t[-1], parent, rid, True))
            for name, c0, c1, up in self._stages:
                rows.append((name, t[c0], t[c1], top if up < 0 else top + 1 + up, rid, True))
            last = (top, rid, bool(replayed))
        self.drained = hi
        # The loops' records hold the last call that ran the captured loops:
        # a replay (on the CPU, where nothing is captured, the call itself).
        if last is not None and (last[2] or self.device.type != "cuda"):
            self._read_loops(rows, last, to_host)
        if self.kernels is not None:
            for name, c0, c1, _ in self._stages:
                n = self.kernels[c1] - self.kernels[c0] - (c1 - c0)
                counters.append((f"{name}.kernels", n, self.name, -1))
            counters.append(("marks", ncol, self.name, -1))
        for name, value in self.notes or ():
            counters.append((name, value, self.name, -1))

    def _read_loops(self, rows: list, last: tuple, to_host) -> None:
        """The loops of the last replay as spans inside their stages."""
        top, rid, _ = last
        index = {name: top + 1 + i for i, (name, _, _, _) in enumerate(self._stages)}
        for lp in self.tracer.loops:
            if lp.marks is not self:
                continue
            trips = int(lp.trips.item())
            stamps = lp.stamps.cpu().numpy()
            t = to_host(stamps[:trips + 1]) if self.device.type == "cuda" else stamps
            parent = index.get(lp.stage, top)
            loop = len(rows)
            rows.append(("loop", t[0], t[trips], parent, rid, True))
            if lp.kind == "while":
                for i in range(1, trips + 1):
                    rows.append(("loop.trip", t[i - 1], t[i], loop, rid, True))


def _stages_of(layout: tuple) -> list:
    """(name, first column, last column, parent stage or -1) of each stage
    a call's mark labels describe: a plain label ends the open top-level
    stage and begins one, `+x` / `-x` open and close the child `x`."""
    stages, top, children = [], None, {}
    for col, label in enumerate(layout):
        if label.startswith("+"):
            children[label[1:]] = len(stages)
            stages.append([label[1:], col, None, top if top is not None else -1])
        elif label.startswith("-"):
            stages[children.pop(label[1:])][2] = col
        else:
            if top is not None:
                stages[top][2] = col
            top = None
            if label != END:
                top = len(stages)
                stages.append([label, col, None, -1])
    if children or top is not None or layout[-1] != END:
        raise RuntimeError(f"stage marks {layout} leave a stage open")
    return [tuple(s) for s in stages]


def stage(name: str) -> None:
    """End the open top-level stage of the traced call running now and
    begin `name`; nothing where no traced call runs."""
    if _MARKS is not None:
        _MARKS.mark(name)


def note(name: str, value: int) -> None:
    """Add the counter `<top-level stage>.<name>` = `value` to the traced
    call running now (StageMarks.notes keeps those of its capture); nothing
    where no traced call runs."""
    marks = _MARKS
    if marks is not None:
        marks._notes.append((f"{marks.top_stage()}.{name}", int(value)))


@contextlib.contextmanager
def child(name: str):
    """The block as the stage `name` inside the open one, in a traced call."""
    marks = _MARKS
    if marks is None:
        yield
        return
    marks.mark("+" + name)
    yield
    marks.mark("-" + name)
