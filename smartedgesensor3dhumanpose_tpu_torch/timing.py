"""Per-stage wall-time accounting bucketed by detection count.

Reproduces the reference's hand-rolled profiling: accumulator arrays indexed
by the number of detections, printed as averages at shutdown
(skeleton_3d_triang_mult_node.cpp:39-41,1076-1084,1234-1241;
pose_prior_mult_node.cpp:33-35,912-920). For deeper traces use
torch.profiler around the pipeline step.
"""

from __future__ import annotations

import time
from typing import Dict, List


class TimingBuckets:
    """Average wall time per frame, bucketed by detection count."""

    def __init__(self, name: str, max_buckets: int = 10):
        self.name = name
        self.max_buckets = max_buckets
        self.totals = [0.0] * max_buckets
        self.counts = [0] * max_buckets

    def add(self, seconds: float, num_detections: int) -> None:
        self.totals[0] += seconds
        self.counts[0] += 1
        if 0 < num_detections < self.max_buckets:
            self.totals[num_detections] += seconds
            self.counts[num_detections] += 1

    def report(self) -> str:
        """The reference's shutdown dump format: overall average plus one
        line per detection-count bucket."""
        lines: List[str] = []
        for i in range(self.max_buckets):
            if self.counts[i] > 0:
                prefix = f"{self.name}: "
                if i > 0:
                    prefix += f"{i} detections: "
                avg_ms = 1e3 * self.totals[i] / self.counts[i]
                lines.append(f"{prefix}avg runtime: {avg_ms:.3f}ms")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        out = {}
        for i in range(self.max_buckets):
            if self.counts[i] > 0:
                key = "all" if i == 0 else f"{i}_detections"
                out[key] = 1e3 * self.totals[i] / self.counts[i]
        return out


class StageTimer:
    """Context-manager stopwatch feeding a TimingBuckets."""

    def __init__(self, buckets: TimingBuckets, num_detections: int = 0):
        self.buckets = buckets
        self.num_detections = num_detections

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.buckets.add(time.perf_counter() - self._t0, self.num_detections)
        return False
