"""Straggler detection and mitigation for synchronized geo-training.

Synchronous data parallelism runs at the speed of the slowest pod; over a
WAN (paper §2.1) transient slowdowns are routine (ECMP collisions, path
flaps).  This module tracks per-worker step times (EWMA + variance),
flags stragglers, and picks a mitigation:

* ``rebalance``   — re-chunk WAN flows (more QP channels, Algorithm 1
                    spreading) when slowness correlates with WAN time;
* ``local_sgd``   — drop to periodic sync (DiLoCo) when one pod is
                    persistently slow: it stops gating every step;
* ``exclude``     — declare the worker failed (hand to failure.py) when
                    slowness exceeds the dead threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class WorkerTiming:
    ewma_s: float = 0.0
    var: float = 0.0
    samples: int = 0

    def update(self, value: float, alpha: float = 0.2) -> None:
        if self.samples == 0:
            self.ewma_s = value
        else:
            delta = value - self.ewma_s
            self.ewma_s += alpha * delta
            self.var = (1 - alpha) * (self.var + alpha * delta * delta)
        self.samples += 1


@dataclasses.dataclass(frozen=True)
class StragglerReport:
    worker: str
    ratio: float  # worker ewma / median ewma
    action: str  # none | rebalance | local_sgd | exclude


class StragglerMonitor:
    def __init__(
        self,
        workers: List[str],
        *,
        slow_ratio: float = 1.5,
        persistent_ratio: float = 2.5,
        dead_ratio: float = 10.0,
        min_samples: int = 5,
    ):
        self.timings: Dict[str, WorkerTiming] = {w: WorkerTiming() for w in workers}
        self.slow_ratio = slow_ratio
        self.persistent_ratio = persistent_ratio
        self.dead_ratio = dead_ratio
        self.min_samples = min_samples

    def record(self, worker: str, step_seconds: float) -> None:
        self.timings[worker].update(step_seconds)

    def median_ewma(self) -> float:
        vals = [t.ewma_s for t in self.timings.values() if t.samples > 0]
        return float(np.median(vals)) if vals else 0.0

    def reports(self) -> List[StragglerReport]:
        med = self.median_ewma()
        out = []
        for w, t in self.timings.items():
            if t.samples < self.min_samples or med <= 0:
                continue
            ratio = t.ewma_s / med
            if ratio >= self.dead_ratio:
                action = "exclude"
            elif ratio >= self.persistent_ratio:
                action = "local_sgd"
            elif ratio >= self.slow_ratio:
                action = "rebalance"
            else:
                action = "none"
            if action != "none":
                out.append(StragglerReport(worker=w, ratio=ratio, action=action))
        return out

    def critical_path_s(self) -> float:
        vals = [t.ewma_s for t in self.timings.values() if t.samples > 0]
        return max(vals) if vals else 0.0

    def sync_efficiency(self) -> float:
        """median/max: fraction of time the fleet isn't waiting."""
        med, worst = self.median_ewma(), self.critical_path_s()
        return med / worst if worst > 0 else 1.0
