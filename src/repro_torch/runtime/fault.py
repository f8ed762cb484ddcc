"""Fault tolerance primitives: straggler detection and failure injection
(a copy of ``repro/runtime/fault.py``, numpy only).

Hard node loss is handled by checkpoint/restart (``TrainLoop.run`` and
``checkpoint.restore_checkpoint``); slow hosts by a step-time detector
that flags hosts whose EWMA step time exceeds the fleet median by a
threshold, so a coordinator can evict them.  On one host the hosts are
simulated.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerDetector:
    n_hosts: int
    alpha: float = 0.2               # EWMA coefficient
    threshold: float = 1.8           # x median => straggler
    min_steps: int = 5

    def __post_init__(self):
        self._ewma = np.zeros(self.n_hosts)
        self._count = 0

    def observe(self, host_step_times: np.ndarray) -> List[int]:
        """Feed one step's per-host durations; returns flagged host ids."""
        t = np.asarray(host_step_times, float)
        if self._count == 0:
            self._ewma = t.copy()
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * t
        self._count += 1
        return self._flagged()

    def _flagged(self) -> List[int]:
        """Host ids whose EWMA exceeds threshold x fleet median; empty
        for the first ``min_steps`` observations, while start-up
        transients dominate the EWMA."""
        if self._count < self.min_steps:
            return []
        med = float(np.median(self._ewma))
        return [int(i) for i in np.nonzero(
            self._ewma > self.threshold * med)[0]]

    def healthy_hosts(self) -> List[int]:
        flagged = set(self._flagged())
        return [i for i in range(self.n_hosts) if i not in flagged]


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for resilience tests."""
    fail_at_steps: tuple = ()
    kind: str = "crash"              # crash | slow

    def check(self, step: int) -> Optional[str]:
        if step in self.fail_at_steps:
            return self.kind
        return None


class SimulatedCrash(RuntimeError):
    pass
