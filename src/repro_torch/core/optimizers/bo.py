"""Bayesian optimization over a finite candidate set.

Configurations from the paper:
  * CherryPick [1]:  GP surrogate, Matern 5/2, EI acquisition.
  * Bilal et al. [3]: GP + LCB for the cost target; RF + PI for time.
  * gp-hedge: the scikit-optimize default used by Rising Bandits — per-ask
    probabilistic choice among {EI, LCB, PI} with gains updated from
    surrogate values at the chosen points.

Surrogates come from :mod:`repro_torch.core.surrogates` (vectorized, bit-identical
to the retained reference implementations).  Because every candidate's
encoding is precomputed by the base class, the GP path shares one
candidate x candidate squared-distance matrix per domain
(:func:`repro_torch.core.surrogates.grid_sqdist`): each refit slices it by the
observed history indices instead of recomputing O(n^2 d) distances.
"""
from __future__ import annotations

import numpy as np
from scipy.stats import norm

from repro_torch.core.optimizers.base import BlackBoxOptimizer
from repro_torch.core.surrogates import GP, RandomForest, grid_sqdist

_ACQS = ("ei", "lcb", "pi")

#: surrogates can legitimately return (near-)zero predictive std — e.g. an
#: RF whose trees all agree, or a GP on duplicated points; floor it before
#: dividing so EI/PI never emit NaN/inf scores
_SD_FLOOR = 1e-12


def acquisition(name: str, mu, sd, best, xi: float = 0.01, kappa: float = 1.96):
    """Return scores to MAXIMIZE (minimization objective)."""
    if name == "lcb":
        return -(mu - kappa * sd)
    imp = best - mu - xi
    z = imp / np.maximum(sd, _SD_FLOOR)
    if name == "ei":
        return imp * norm.cdf(z) + sd * norm.pdf(z)
    if name == "pi":
        return norm.cdf(z)
    raise ValueError(name)


class BO(BlackBoxOptimizer):
    def __init__(self, candidates, encode, seed: int = 0, *,
                 surrogate: str = "gp", acq: str = "ei", n_init: int = 3,
                 kappa: float = 1.96, xi: float = 0.01):
        super().__init__(candidates, encode, seed)
        self.surrogate_kind = surrogate
        self.acq = acq
        self.n_init = n_init
        self.kappa, self.xi = kappa, xi
        self._grid_sq = grid_sqdist(self._X) if self._X is not None else None
        # gp-hedge state
        self._gains = np.zeros(len(_ACQS))

    def _fit(self):
        X, y = self._observed_xy()
        if self.surrogate_kind == "gp":
            idxs = self._observed_indices()
            sq = self._grid_sq[np.ix_(idxs, idxs)] \
                if (idxs is not None and self._grid_sq is not None) else None
            return GP().fit(X, y, sqdist=sq)
        if self.surrogate_kind in ("rf", "et"):
            return RandomForest(
                extra=(self.surrogate_kind == "et"),
                seed=int(self.rng.integers(2**31))).fit(X, y)
        raise ValueError(self.surrogate_kind)

    def _predict(self, model, rem):
        idxs = self._observed_indices()
        if isinstance(model, GP) and idxs is not None \
                and self._grid_sq is not None:
            return model.predict(self._X[rem],
                                 sqdist=self._grid_sq[np.ix_(rem, idxs)])
        return model.predict(self._X[rem])

    def ask(self) -> int:
        if len(self.history) < self.n_init:
            return self._random_unevaluated()
        rem = self.remaining()
        if not rem:
            return int(self.rng.integers(len(self.candidates)))
        model = self._fit()
        mu, sd = self._predict(model, rem)
        best = min(self.history.values)
        if self.acq == "gp_hedge":
            probs = np.exp(self._gains - self._gains.max())
            probs /= probs.sum()
            pick = int(self.rng.choice(len(_ACQS), p=probs))
            # each acquisition is scored exactly once per ask: the picked
            # one proposes, and every argmax feeds the hedge gains update
            scores = [acquisition(a, mu, sd, best, self.xi, self.kappa)
                      for a in _ACQS]
            for i, s in enumerate(scores):
                self._gains[i] -= mu[int(np.argmax(s))]
            return rem[int(np.argmax(scores[pick]))]
        scores = acquisition(self.acq, mu, sd, best, self.xi, self.kappa)
        return rem[int(np.argmax(scores))]


def cherrypick(candidates, encode, seed: int = 0) -> BO:
    return BO(candidates, encode, seed, surrogate="gp", acq="ei")


def bilal(candidates, encode, seed: int = 0, *, target: str = "cost") -> BO:
    if target == "cost":
        return BO(candidates, encode, seed, surrogate="gp", acq="lcb")
    return BO(candidates, encode, seed, surrogate="rf", acq="pi")
