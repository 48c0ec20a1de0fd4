"""Straggler detection & mitigation hooks.

Port of ``repro/runtime/straggler.py`` (host numpy).

On a real multi-pod deployment each host reports per-step wall time; the
orchestrator flags hosts whose EWMA step time exceeds ``threshold`` x the
fleet median and triggers mitigation: (a) re-solve the FIN placement without
the slow tier (elastic re-placement — the paper's graph rebuild costs ~ms,
Table VII), or (b) shrink the data-parallel group (elastic scaling).  This
module implements the detection logic host-side; tests drive it with
synthetic timings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class StragglerDetector:
    n_workers: int
    alpha: float = 0.2            # EWMA smoothing
    threshold: float = 1.5        # x median => straggler
    warmup: int = 5
    ewma: Optional[np.ndarray] = None
    steps: int = 0

    def __post_init__(self):
        self.ewma = np.zeros(self.n_workers)

    def update(self, step_times: np.ndarray) -> List[int]:
        """Feed one step's per-worker times; returns straggler indices."""
        t = np.asarray(step_times, dtype=np.float64)
        assert t.shape == (self.n_workers,)
        if self.steps == 0:
            self.ewma = t.copy()
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * t
        self.steps += 1
        if self.steps < self.warmup:
            return []
        med = float(np.median(self.ewma))
        return [i for i in range(self.n_workers)
                if self.ewma[i] > self.threshold * med]


@dataclass
class ElasticPlan:
    """Mitigation outcome: which workers stay, and the re-placement hook."""
    keep: List[int]
    dropped: List[int]


def mitigate(detector: StragglerDetector, stragglers: List[int],
             *, min_workers: int = 1) -> ElasticPlan:
    keep = [i for i in range(detector.n_workers) if i not in stragglers]
    if len(keep) < min_workers:
        keep = list(range(detector.n_workers))
        stragglers = []
    return ElasticPlan(keep=keep, dropped=stragglers)
