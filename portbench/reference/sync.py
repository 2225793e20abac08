"""N-way approximate-time synchronization, plain Python: a frozen copy of
the port's Python mirror (`sync.py::PyApproximateTimeSync`) of the ROS
ApproximateTime optimal-candidate search the reference generalizes to N
streams (my_message_filters/sync_policies/approximate_time_vec.h), with
the reference node's settings (`synchronizer`).
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

_NO_LIMIT = 2**62


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


def synchronizer(num_streams: int) -> PyApproximateTimeSync:
    """The reference node's configuration: queue_size = max(3, 1 + N/4),
    inter-message lower bound 20 ms, age penalty 2.0
    (skeleton_3d_triang_mult_node.cpp:1218-1222)."""
    return PyApproximateTimeSync(num_streams, max(3, 1 + num_streams // 4), 2.0, 0, 20_000_000)
