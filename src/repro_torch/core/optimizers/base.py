"""Ask/tell black-box optimizer interface over a finite candidate set.

All the paper's search methods are expressed against this API; CloudBandit
composes any of them as its per-arm component BBO ("arbitrary black-box
optimizer" — Algorithm 1, step 5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class History:
    """Evaluation log: (candidate, value) in evaluation order."""
    points: List[Any] = dataclasses.field(default_factory=list)
    values: List[float] = dataclasses.field(default_factory=list)

    def append(self, point, value: float) -> None:
        self.points.append(point)
        self.values.append(float(value))

    def __len__(self) -> int:
        return len(self.values)

    def best(self) -> Tuple[Any, float]:
        i = int(np.argmin(self.values))
        return self.points[i], self.values[i]

    def best_curve(self) -> np.ndarray:
        return np.minimum.accumulate(np.asarray(self.values))


class BlackBoxOptimizer:
    """Minimize over a finite candidate list.

    candidates : sequence of hashable-ish configs (dicts or (provider, dict))
    encode     : config -> feature vector (np.ndarray), for model-based BBOs
    """

    #: whether this optimizer may propose an already-evaluated candidate
    can_repeat: bool = False

    def __init__(self, candidates: Sequence, encode: Optional[Callable] = None,
                 seed: int = 0):
        self.candidates = list(candidates)
        self.encode = encode
        self.rng = np.random.default_rng(seed)
        self.history = History()
        self._evaluated: set = set()
        self._hist_idx: List[int] = []
        if encode is not None:
            self._X = np.stack([encode(c) for c in self.candidates])
        else:
            self._X = None

    # ------------------------------------------------------------------
    def _key(self, idx: int):
        return idx

    def remaining(self) -> List[int]:
        return [i for i in range(len(self.candidates))
                if i not in self._evaluated]

    def ask(self) -> int:
        """Return the index of the next candidate to evaluate."""
        raise NotImplementedError

    def tell(self, idx: int, value: float) -> None:
        self._evaluated.add(idx)
        self._hist_idx.append(int(idx))
        self.history.append(self.candidates[idx], float(value))

    def best(self) -> Tuple[Any, float]:
        return self.history.best()

    def step(self, objective: Callable[[Any], float]) -> float:
        """One ask/evaluate/tell iteration; returns the observed value."""
        idx = self.ask()
        val = float(objective(self.candidates[idx]))
        self.tell(idx, val)
        return val

    def run(self, objective: Callable[[Any], float], budget: int) -> History:
        for _ in range(budget):
            self.step(objective)
        return self.history

    # helpers for model-based subclasses ------------------------------
    def _observed_indices(self) -> Optional[List[int]]:
        """Candidate indices of the evaluation history (repeats kept), or
        None when a subclass bypassed :meth:`tell` and the log is out of
        step with the history."""
        if self._X is not None and len(self._hist_idx) == len(self.history):
            return self._hist_idx
        return None

    def _observed_xy(self) -> Tuple[np.ndarray, np.ndarray]:
        """Encoded history -> (X, y).  Indexes the precomputed candidate
        encodings when possible; falls back to re-encoding the history
        points (bit-identical — ``encode`` is deterministic)."""
        idxs = self._observed_indices()
        if idxs is not None:
            X = self._X[idxs]
        else:
            X = np.stack([self.encode(p) for p in self.history.points])
        y = np.asarray(self.history.values, float)
        return X, y

    #: SMAC-style incumbent seeding: model-based optimizers evaluate the
    #: domain's first candidate (by convention, the incumbent/default
    #: configuration) before random init points.
    seed_incumbent: bool = True

    def _random_unevaluated(self) -> int:
        if self.seed_incumbent and not self.history.points \
                and 0 not in self._evaluated:
            return 0
        rem = self.remaining()
        if not rem:
            return int(self.rng.integers(len(self.candidates)))
        return int(self.rng.choice(rem))
