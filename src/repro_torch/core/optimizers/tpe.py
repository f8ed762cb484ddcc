"""HyperOpt-style Tree-structured Parzen Estimator.

Models the hierarchical domain as a graph-structured generative process:
sample a provider from good/bad category densities, then its conditional
params from per-provider densities estimated over the *good* observations
(Bergstra et al., 2013).  Candidates are sampled generatively, so — like
HyperOpt, and unlike SMAC — TPE CAN repeat configurations (the paper calls
this out as the reason HyperOpt trails SMAC).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.domain import Domain
from repro_torch.core.optimizers.base import BlackBoxOptimizer


class TPE(BlackBoxOptimizer):
    can_repeat = True

    def __init__(self, candidates, encode=None, seed: int = 0, *,
                 domain: Domain, gamma: float = 0.25, n_samples: int = 24,
                 n_init: int = 5):
        super().__init__(candidates, encode, seed)
        self.domain = domain
        self.gamma = gamma
        self.n_samples = n_samples
        self.n_init = n_init
        # candidate index lookup
        self._index: Dict = {self._freeze(c): i
                             for i, c in enumerate(candidates)}

    @staticmethod
    def _freeze(point):
        prov, cfg = point
        return (prov, tuple(sorted(cfg.items())))

    # ------------------------------------------------------------------
    def _split(self):
        y = np.asarray(self.history.values)
        n_good = max(1, int(np.ceil(self.gamma * len(y))))
        order = np.argsort(y)
        good = [self.history.points[i] for i in order[:n_good]]
        bad = [self.history.points[i] for i in order[n_good:]] or good
        return good, bad

    @staticmethod
    def _cat_density(values: List, observed: List, alpha: float = 1.0):
        counts = {v: alpha for v in values}
        for o in observed:
            if o in counts:
                counts[o] += 1.0
        total = sum(counts.values())
        return {v: c / total for v, c in counts.items()}

    def _sample_point(self, good):
        provs = self.domain.provider_names
        pd = self._cat_density(list(provs), [p for p, _ in good])
        prov = self.rng.choice(provs, p=[pd[v] for v in provs])
        cfg = {}
        good_cfgs = [c for p, c in good if p == prov]
        spaces = list(self.domain.provider(prov).params) + \
            list(self.domain.shared)
        for s in spaces:
            dens = self._cat_density(
                list(s.values),
                [c[s.name] for c in good_cfgs if s.name in c])
            vals = list(s.values)
            cfg[s.name] = vals[int(self.rng.choice(
                len(vals), p=[dens[v] for v in vals]))]
        return (prov, cfg)

    def _log_density(self, point, obs) -> float:
        prov, cfg = point
        pd = self._cat_density(list(self.domain.provider_names),
                               [p for p, _ in obs])
        lp = np.log(pd[prov])
        obs_cfgs = [c for p, c in obs if p == prov]
        spaces = list(self.domain.provider(prov).params) + \
            list(self.domain.shared)
        for s in spaces:
            dens = self._cat_density(
                list(s.values),
                [c[s.name] for c in obs_cfgs if s.name in c])
            lp += np.log(dens[cfg[s.name]])
        return float(lp)

    # ------------------------------------------------------------------
    def ask(self) -> int:
        if len(self.history) < self.n_init:
            return self._random_unevaluated()
        good, bad = self._split()
        best_idx, best_score = None, -np.inf
        for _ in range(self.n_samples):
            pt = self._sample_point(good)
            score = self._log_density(pt, good) - self._log_density(pt, bad)
            if score > best_score:
                best_score, best_idx = score, self._index[self._freeze(pt)]
        return best_idx

    def tell(self, idx: int, value: float) -> None:
        # repeats allowed: track history but do not exclude from the pool
        self.history.append(self.candidates[idx], float(value))
