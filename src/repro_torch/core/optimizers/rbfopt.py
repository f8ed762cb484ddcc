"""RBFOpt-style radial-basis-function black-box optimizer.

Implements the metric-stochastic-response-surface (MSRSM) flavour of the RBF
method (Gutmann 2001; Costa & Nannicini 2018): a thin-plate-spline RBF
interpolant with a linear polynomial tail is fit to the observations, and the
next point maximizes a cyclic weighted combination of (surrogate quality,
distance-to-evaluated) — sweeping from exploration (w→0) to exploitation
(w→1).  The paper selects RBFOpt as CloudBandit's best component BBO.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.optimizers.base import BlackBoxOptimizer

_CYCLE = (0.3, 0.5, 0.8, 0.95)


def _tps(r: np.ndarray) -> np.ndarray:
    out = np.zeros_like(r)
    nz = r > 1e-12
    out[nz] = r[nz] ** 2 * np.log(r[nz])
    return out


class RBFOpt(BlackBoxOptimizer):
    def __init__(self, candidates, encode, seed: int = 0, n_init: int = 3):
        super().__init__(candidates, encode, seed)
        self.n_init = n_init
        self._t = 0

    def _fit_predict(self, Xq: np.ndarray) -> np.ndarray:
        X = np.stack([self.encode(p) for p in self.history.points])
        y = np.asarray(self.history.values, float)
        mu, sd = y.mean(), y.std() + 1e-12
        y = (y - mu) / sd
        n, d = X.shape
        r = np.sqrt(np.maximum(
            np.sum((X[:, None] - X[None]) ** 2, -1), 0))
        Phi = _tps(r)
        Ptail = np.concatenate([X, np.ones((n, 1))], axis=1)
        A = np.block([[Phi + 1e-8 * np.eye(n), Ptail],
                      [Ptail.T, np.zeros((d + 1, d + 1))]])
        rhs = np.concatenate([y, np.zeros(d + 1)])
        try:
            sol = np.linalg.solve(A, rhs)
        except np.linalg.LinAlgError:
            sol = np.linalg.lstsq(A, rhs, rcond=None)[0]
        lam, c = sol[:n], sol[n:]
        rq = np.sqrt(np.maximum(
            np.sum((Xq[:, None] - X[None]) ** 2, -1), 0))
        pred = _tps(rq) @ lam + Xq @ c[:-1] + c[-1]
        return pred * sd + mu

    def ask(self) -> int:
        if len(self.history) < self.n_init:
            return self._random_unevaluated()
        rem = self.remaining()
        if not rem:
            return int(self.rng.integers(len(self.candidates)))
        Xq = self._X[rem]
        pred = self._fit_predict(Xq)
        # normalized surrogate score (lower pred better)
        ps = (pred - pred.min()) / (np.ptp(pred) + 1e-12)
        # distance to closest evaluated point (larger = more exploratory)
        Xe = np.stack([self.encode(p) for p in self.history.points])
        dmin = np.sqrt(np.maximum(
            np.sum((Xq[:, None] - Xe[None]) ** 2, -1), 0)).min(axis=1)
        ds = 1.0 - (dmin - dmin.min()) / (np.ptp(dmin) + 1e-12)
        w = _CYCLE[self._t % len(_CYCLE)]
        self._t += 1
        score = w * ps + (1 - w) * ds          # minimize
        return rem[int(np.argmin(score))]
