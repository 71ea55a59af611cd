"""Straggler detection: per-step heartbeats and robust outlier flags (the
port of ``repro/runtime/heartbeat.py``).

In a synchronous fleet the slowest worker sets the step time, so
stragglers must be detected (then evicted or replaced). Detection is
host-side: rolling median and MAD z-score over the reported step
durations, per worker. A worker whose beats stop for more than
``miss_limit`` steps is dead.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Deque, Dict, List, Optional

__all__ = ["HeartbeatMonitor", "StragglerReport"]


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    worker: int
    step: int
    duration: float
    median: float
    threshold: float


class HeartbeatMonitor:
    """Track per-worker step durations; flag stragglers.

    A worker is a straggler at a step if its duration exceeds
    ``max(factor × rolling-median, median + z × 1.4826 × MAD)``.
    Missing heartbeats beyond ``miss_limit`` steps mark the worker dead.
    """

    def __init__(self, n_workers: int, *, window: int = 32,
                 factor: float = 2.0, z: float = 6.0, miss_limit: int = 3):
        self.n_workers = n_workers
        self.window = window
        self.factor = factor
        self.z = z
        self.miss_limit = miss_limit
        self._history: Dict[int, Deque[float]] = {
            w: collections.deque(maxlen=window) for w in range(n_workers)}
        self._last_step: Dict[int, int] = {w: -1 for w in range(n_workers)}
        self.reports: List[StragglerReport] = []

    def beat(self, worker: int, step: int,
             duration: float) -> Optional[StragglerReport]:
        self._last_step[worker] = step
        hist = self._history[worker]
        all_durations = [d for dq in self._history.values() for d in dq]
        report = None
        if len(all_durations) >= max(8, self.n_workers):
            med = statistics.median(all_durations)
            mad = statistics.median([abs(d - med) for d in all_durations]) \
                or 1e-9
            threshold = max(self.factor * med, med + self.z * 1.4826 * mad)
            if duration > threshold:
                report = StragglerReport(worker, step, duration, med,
                                         threshold)
                self.reports.append(report)
        hist.append(duration)
        return report

    def dead_workers(self, current_step: int) -> List[int]:
        return [w for w, s in self._last_step.items()
                if current_step - s > self.miss_limit]
