"""Baselines: random search, coordinate descent, exhaustive search."""
from __future__ import annotations

import numpy as np

from repro_torch.core.optimizers.base import BlackBoxOptimizer


class RandomSearch(BlackBoxOptimizer):
    """Uniform sampling WITH replacement — the paper's RS baseline ("we
    select B configurations at random (with replacement)")."""

    can_repeat = True

    def ask(self) -> int:
        return int(self.rng.integers(len(self.candidates)))


class ExhaustiveSearch(BlackBoxOptimizer):
    """Deterministic sweep of every candidate."""

    def __init__(self, candidates, encode=None, seed: int = 0):
        super().__init__(candidates, encode, seed)
        self._next = 0

    def ask(self) -> int:
        i = self._next % len(self.candidates)
        self._next += 1
        return i


class CoordinateDescent(BlackBoxOptimizer):
    """Greedy one-parameter-at-a-time descent over dict-configs.

    Starts at a random candidate; repeatedly sweeps the values of one
    coordinate (in random order) keeping the best.  Candidates must be dicts
    (inner single-provider domains) or (provider, dict) points, in which case
    the provider is treated as one more coordinate.
    """

    def __init__(self, candidates, encode=None, seed: int = 0):
        super().__init__(candidates, encode, seed)
        self._cur = int(self.rng.integers(len(self.candidates)))
        self._queue: list = []
        self._pending = self._cur

    def _as_dict(self, cand) -> dict:
        if isinstance(cand, tuple):
            prov, cfg = cand
            d = dict(cfg)
            d["__provider__"] = prov
            return d
        return dict(cand)

    def _neighbors(self, idx: int) -> list:
        base = self._as_dict(self.candidates[idx])
        out = []
        for j, cand in enumerate(self.candidates):
            if j == idx or j in self._evaluated:
                continue
            d = self._as_dict(cand)
            diff = [k for k in set(base) | set(d)
                    if base.get(k) != d.get(k)]
            if len(diff) == 1:
                out.append(j)
        return out

    def ask(self) -> int:
        if self._pending is not None:
            i, self._pending = self._pending, None
            return i
        if not self._queue:
            # re-center on the best point found so far, queue its neighbors
            best_point, _ = self.history.best()
            best_idx = self.candidates.index(best_point)
            self._queue = self._neighbors(best_idx)
            self.rng.shuffle(self._queue)
            if not self._queue:
                return self._random_unevaluated()
        return self._queue.pop()
