"""Host-side N-way approximate-time synchronization.

Python face of the native C++ runtime (`native/runtime.cpp`, this package's
own copy) with a pure-Python mirror of the same algorithm: the ROS
ApproximateTime optimal-candidate search the reference generalizes to N
streams (my_message_filters/sync_policies/approximate_time_vec.h).

The native library is built with g++ ($CXX if set) at first use, from this
checkout's source only, into `_build/` next to this package (the name
carries a hash of the source, compiler and flags, so an edited source is
never served stale). The factories build native objects by default and
raise with the compiler's output when the build fails; the Python mirrors are made only when the caller asks for
them (`prefer_native=False`), as the tests do to use them as the oracle.

Payloads are opaque integer handles (indices into whatever host-side frame
store feeds the device); timestamps are int64 nanoseconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import deque
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from smartedgesensor3dhumanpose_tpu_torch._kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "native" / "runtime.cpp"
# The reference package's native/Makefile flags, plus -shared.
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
_NO_LIMIT = 2**62


def compiler() -> str:
    """The C++ compiler: $CXX, else g++."""
    return os.environ.get("CXX", "g++")


def build() -> Path:
    """Compile the runtime if this source state has no library yet; return
    the library path. Raises RuntimeError with the compiler's output when
    the build fails."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((compiler(),) + CXX_FLAGS).encode())
    out = BUILD_DIR / f"libses3d_runtime_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(
            [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {SOURCE.name} with {compiler()} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"{compiler()} failed on {SOURCE.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u32, i64, u64 = ctypes.c_uint32, ctypes.c_int64, ctypes.c_uint64
    p, pi64, pu64 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64)
    lib.ses3d_sync_create.restype = p
    lib.ses3d_sync_create.argtypes = [u32, u32, ctypes.c_double, i64]
    lib.ses3d_sync_destroy.restype = None
    lib.ses3d_sync_destroy.argtypes = [p]
    lib.ses3d_sync_set_lower_bound.restype = None
    lib.ses3d_sync_set_lower_bound.argtypes = [p, u32, i64]
    lib.ses3d_sync_push.restype = u32
    lib.ses3d_sync_push.argtypes = [p, u32, i64, u64]
    lib.ses3d_sync_pop.restype = ctypes.c_int
    lib.ses3d_sync_pop.argtypes = [p, pi64, pu64]
    lib.ses3d_sync_ready.restype = u32
    lib.ses3d_sync_ready.argtypes = [p]
    lib.ses3d_latest_create.restype = p
    lib.ses3d_latest_create.argtypes = [u32]
    lib.ses3d_latest_destroy.restype = None
    lib.ses3d_latest_destroy.argtypes = [p]
    lib.ses3d_latest_put.restype = None
    lib.ses3d_latest_put.argtypes = [p, pi64, pu64]
    lib.ses3d_latest_take.restype = ctypes.c_int
    lib.ses3d_latest_take.argtypes = [p, pi64, pu64]
    lib.ses3d_latest_dropped.restype = u64
    lib.ses3d_latest_dropped.argtypes = [p]
    return lib


_NATIVE = None
_NATIVE_LOCK = threading.Lock()


def native_lib() -> ctypes.CDLL:
    """The loaded runtime library (built on first call; raises if the build
    fails)."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is None:
            _NATIVE = _load(build())
        return _NATIVE


class NativeApproximateTimeSync:
    """ctypes wrapper over the C++ synchronizer."""

    def __init__(
        self,
        num_streams: int,
        queue_size: int,
        age_penalty: float = 0.1,
        max_interval_ns: int = 0,
        lower_bound_ns: int = 0,
    ):
        lib = native_lib()
        self._lib = lib
        self._n = num_streams
        self._ptr = lib.ses3d_sync_create(
            num_streams, queue_size, age_penalty, max_interval_ns
        )
        if lower_bound_ns:
            for i in range(num_streams):
                lib.ses3d_sync_set_lower_bound(self._ptr, i, lower_bound_ns)
        self._stamps = (ctypes.c_int64 * num_streams)()
        self._handles = (ctypes.c_uint64 * num_streams)()

    def push(self, stream: int, stamp_ns: int, handle: int) -> int:
        if not 0 <= stream < self._n:
            raise ValueError(f"stream {stream} outside [0, {self._n})")
        return self._lib.ses3d_sync_push(self._ptr, stream, stamp_ns, handle)

    def pop(self) -> Optional[Tuple[List[int], List[int]]]:
        if not self._lib.ses3d_sync_pop(self._ptr, self._stamps, self._handles):
            return None
        return list(self._stamps), list(self._handles)

    def ready(self) -> int:
        return self._lib.ses3d_sync_ready(self._ptr)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        ptr = getattr(self, "_ptr", None)
        if lib is not None and ptr:
            lib.ses3d_sync_destroy(ptr)


class NativeLatestSlot:
    """ctypes wrapper over the C++ latest-wins frame slot: the reference's
    sync-thread -> worker-thread handoff (skeleton_3d_triang_mult_node.cpp:
    999-1006,1017-1025): the producer overwrites, the consumer takes the
    newest frame, and backlog frames are dropped (counted)."""

    def __init__(self, num_streams: int):
        lib = native_lib()
        self._lib = lib
        self._n = num_streams
        self._ptr = lib.ses3d_latest_create(num_streams)
        self._stamps = (ctypes.c_int64 * num_streams)()
        self._handles = (ctypes.c_uint64 * num_streams)()

    def put(self, stamps: Sequence[int], handles: Sequence[int]) -> None:
        if len(stamps) != self._n or len(handles) != self._n:
            raise ValueError(f"put takes {self._n} stamps and handles")
        s = (ctypes.c_int64 * self._n)(*stamps)
        h = (ctypes.c_uint64 * self._n)(*handles)
        self._lib.ses3d_latest_put(self._ptr, s, h)

    def take(self) -> Optional[Tuple[List[int], List[int]]]:
        if not self._lib.ses3d_latest_take(self._ptr, self._stamps, self._handles):
            return None
        return list(self._stamps), list(self._handles)

    @property
    def dropped(self) -> int:
        return int(self._lib.ses3d_latest_dropped(self._ptr))

    def __del__(self):
        lib = getattr(self, "_lib", None)
        ptr = getattr(self, "_ptr", None)
        if lib is not None and ptr:
            lib.ses3d_latest_destroy(ptr)


class PyLatestSlot:
    """Pure-Python latest-wins slot (differential oracle)."""

    def __init__(self, num_streams: int):
        self._n = num_streams
        self._lock = threading.Lock()
        self._data: Optional[Tuple[List[int], List[int]]] = None
        self._dropped = 0

    def put(self, stamps: Sequence[int], handles: Sequence[int]) -> None:
        with self._lock:
            if self._data is not None:
                self._dropped += 1
            self._data = (list(stamps), list(handles))

    def take(self) -> Optional[Tuple[List[int], List[int]]]:
        with self._lock:
            data, self._data = self._data, None
            return data

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped


def make_latest_slot(num_streams: int, prefer_native: bool = True):
    """A native slot, or the Python mirror when `prefer_native` is False."""
    if prefer_native:
        return NativeLatestSlot(num_streams)
    return PyLatestSlot(num_streams)


class PyApproximateTimeSync:
    """Pure-Python mirror of the same algorithm (test oracle)."""

    def __init__(
        self,
        num_streams: int,
        queue_size: int,
        age_penalty: float = 0.1,
        max_interval_ns: int = 0,
        lower_bound_ns: int = 0,
    ):
        self.n = num_streams
        self.queue_size = queue_size
        self.age_penalty = age_penalty
        self.max_interval = max_interval_ns if max_interval_ns > 0 else _NO_LIMIT
        self.lower_bound = [lower_bound_ns] * num_streams
        self.deques: List[deque] = [deque() for _ in range(num_streams)]
        self.past: List[list] = [[] for _ in range(num_streams)]
        self.candidate: List[Optional[Tuple[int, int]]] = [None] * num_streams
        self.candidate_start = 0
        self.candidate_end = 0
        self.pivot: Optional[int] = None
        self.pivot_time = 0
        self.has_dropped = [False] * num_streams
        self.ready_sets: deque = deque()

    # -- helpers ----------------------------------------------------------
    def _all_nonempty(self) -> bool:
        return all(self.deques)

    def _boundary(self, latest: bool) -> Tuple[int, int]:
        idx, time = 0, self.deques[0][0][0]
        for i in range(1, self.n):
            t = self.deques[i][0][0]
            if (t < time) != latest:
                idx, time = i, t
        return idx, time

    def _virtual_time(self, i: int) -> int:
        if self.deques[i]:
            return self.deques[i][0][0]
        lb = self.past[i][-1][0] + self.lower_bound[i]
        return max(lb, self.pivot_time)

    def _virtual_boundary(self, latest: bool) -> Tuple[int, int]:
        idx, time = 0, self._virtual_time(0)
        for i in range(1, self.n):
            t = self._virtual_time(i)
            if (t < time) != latest:
                idx, time = i, t
        return idx, time

    def _move_front_to_past(self, i: int):
        self.past[i].append(self.deques[i].popleft())

    def _recover_all(self, i: int):
        while self.past[i]:
            self.deques[i].appendleft(self.past[i].pop())

    def _recover_n(self, i: int, k: int):
        for _ in range(k):
            self.deques[i].appendleft(self.past[i].pop())

    def _make_candidate(self):
        for i in range(self.n):
            self.candidate[i] = self.deques[i][0]
            self.past[i].clear()

    def _publish_candidate(self):
        self.ready_sets.append(list(self.candidate))
        self.pivot = None
        for i in range(self.n):
            self._recover_all(i)
            self.deques[i].popleft()

    # -- public API -------------------------------------------------------
    def push(self, stream: int, stamp_ns: int, handle: int) -> int:
        d = self.deques[stream]
        d.append((stamp_ns, handle))
        if len(d) == 1 and self._all_nonempty():
            self._process()
        if len(self.deques[stream]) + len(self.past[stream]) > self.queue_size:
            for j in range(self.n):
                self._recover_all(j)
            if self.deques[stream]:
                self.deques[stream].popleft()
            self.has_dropped[stream] = True
            if self.pivot is not None:
                self.pivot = None
                self._process()
        return len(self.ready_sets)

    def pop(self) -> Optional[Tuple[List[int], List[int]]]:
        if not self.ready_sets:
            return None
        s = self.ready_sets.popleft()
        return [m[0] for m in s], [m[1] for m in s]

    def ready(self) -> int:
        return len(self.ready_sets)

    def _process(self):
        while self._all_nonempty():
            end_index, end_time = self._boundary(True)
            start_index, start_time = self._boundary(False)
            for i in range(self.n):
                if i != end_index:
                    self.has_dropped[i] = False
            if self.pivot is None:
                if end_time - start_time > self.max_interval:
                    self.deques[start_index].popleft()
                    if not self.deques[start_index]:
                        return
                    continue
                if self.has_dropped[end_index]:
                    self.deques[start_index].popleft()
                    if not self.deques[start_index]:
                        return
                    continue
                self._make_candidate()
                self.candidate_start = start_time
                self.candidate_end = end_time
                self.pivot = end_index
                self.pivot_time = end_time
                self._move_front_to_past(start_index)
            else:
                growth = (end_time - self.candidate_end) * (1 + self.age_penalty)
                if growth >= (start_time - self.candidate_start):
                    self._move_front_to_past(start_index)
                else:
                    self._make_candidate()
                    self.candidate_start = start_time
                    self.candidate_end = end_time
                    self._move_front_to_past(start_index)
            if start_index == self.pivot:
                self._publish_candidate()
            elif (end_time - self.candidate_end) * (1 + self.age_penalty) >= (
                self.pivot_time - self.candidate_start
            ):
                self._publish_candidate()
            elif not self._all_nonempty():
                virtual_moves = [0] * self.n
                while True:
                    _, ve_time = self._virtual_boundary(True)
                    vs_index, vs_time = self._virtual_boundary(False)
                    vgrowth = (ve_time - self.candidate_end) * (
                        1 + self.age_penalty
                    )
                    if vgrowth >= (self.pivot_time - self.candidate_start):
                        self._publish_candidate()
                        break
                    if vgrowth < (vs_time - self.candidate_start):
                        for i in range(self.n):
                            self._recover_n(i, virtual_moves[i])
                        break
                    self._move_front_to_past(vs_index)
                    virtual_moves[vs_index] += 1


def make_synchronizer(
    num_streams: int,
    queue_size: Optional[int] = None,
    age_penalty: float = 2.0,
    lower_bound_ns: int = 20_000_000,
    prefer_native: bool = True,
):
    """The reference node's configuration: queue_size = max(3, 1 + N/4),
    inter-message lower bound 20 ms, age penalty 2.0
    (skeleton_3d_triang_mult_node.cpp:1218-1222). Native unless
    `prefer_native` is False."""
    if queue_size is None:
        queue_size = max(3, 1 + num_streams // 4)
    cls = NativeApproximateTimeSync if prefer_native else PyApproximateTimeSync
    return cls(num_streams, queue_size, age_penalty, 0, lower_bound_ns)
