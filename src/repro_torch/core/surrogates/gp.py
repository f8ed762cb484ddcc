"""Vectorized Gaussian-process regression (Matern 5/2) for BO surrogates.

Bit-identical to :class:`repro_torch.core.surrogates.reference.GPReference`
(same lengthscale selection, same posterior), restructured around two
facts of the BO hot loop:

* the pairwise squared-distance matrix is computed **once per fit** and
  reused across the median heuristic, every point of the lengthscale MLL
  grid, and the final kernel (the reference recomputes the O(n^2 d)
  distances 7x per fit);
* history points and query points are all rows of the fixed candidate
  grid that :class:`repro_torch.core.optimizers.base.BlackBoxOptimizer`
  precomputes, so callers can pass slices of one cached candidate-grid
  distance matrix (:func:`grid_sqdist`) and a fit touches no O(d) work at
  all — just indexing + Cholesky.

The lengthscale grid's kernels are built as one stacked ``(g, n, n)``
tensor and factorized with numpy's batched Cholesky (bit-identical to
scipy's ``cho_factor`` — both call LAPACK ``dpotrf``), with a per-slice
fallback so a single non-PD lengthscale degrades to ``-inf`` MLL exactly
like the reference's per-lengthscale try/except.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.linalg import cho_factor, cho_solve


def pairwise_sqdist(X1: np.ndarray, X2: np.ndarray) -> np.ndarray:
    """Squared euclidean distances, same reduction order as the reference
    kernel (so slices of a larger grid matrix are bit-identical)."""
    return np.sum((X1[:, None] - X2[None]) ** 2, -1)


def matern52(X1: np.ndarray, X2: np.ndarray, ls: float) -> np.ndarray:
    d = np.sqrt(np.maximum(pairwise_sqdist(X1, X2), 1e-30)) / ls
    s5 = np.sqrt(5.0) * d
    return (1 + s5 + 5.0 * d * d / 3.0) * np.exp(-s5)


def _matern52_from_r(r_over_ls: np.ndarray) -> np.ndarray:
    """Matern 5/2 from precomputed ``sqrt(max(sqdist, 1e-30)) / ls``."""
    s5 = np.sqrt(5.0) * r_over_ls
    return (1 + s5 + 5.0 * r_over_ls * r_over_ls / 3.0) * np.exp(-s5)


# ---------------------------------------------------------------------------
# candidate-grid distance cache: one matrix per domain, shared by every BO
# instance (method x seed x budget) searching that grid
# ---------------------------------------------------------------------------
_GRID_CACHE: dict = {}
_GRID_CACHE_MAX = 32


def grid_sqdist(X: np.ndarray) -> np.ndarray:
    """Full candidate x candidate squared-distance matrix, memoized on the
    grid's contents.  Grids are small (<= 88 x ~25 features) so the cache
    holds complete matrices; it is bounded and cleared wholesale if a
    pathological caller churns through too many distinct grids."""
    X = np.ascontiguousarray(X)
    key = (X.shape, X.tobytes())
    hit = _GRID_CACHE.get(key)
    if hit is None:
        if len(_GRID_CACHE) >= _GRID_CACHE_MAX:
            _GRID_CACHE.clear()
        hit = _GRID_CACHE[key] = pairwise_sqdist(X, X)
        hit.setflags(write=False)
    return hit


class GP:
    def __init__(self, noise: float = 1e-3, ls_grid: int = 5):
        self.noise = noise
        self.ls_grid = ls_grid
        self._fitted = False

    def fit(self, X: np.ndarray, y: np.ndarray, *,
            sqdist: Optional[np.ndarray] = None) -> "GP":
        """``sqdist``: optional precomputed pairwise squared distances of
        ``X`` against itself (e.g. a slice of :func:`grid_sqdist`)."""
        self.X = np.asarray(X, float)
        y = np.asarray(y, float)
        self.y_mean = y.mean()
        self.y_std = y.std() + 1e-12
        self.y = (y - self.y_mean) / self.y_std
        n = len(self.X)

        if sqdist is None:
            sqdist = pairwise_sqdist(self.X, self.X)
        # median-heuristic lengthscale (+ small MLL grid refinement)
        if n > 1:
            d = np.sqrt(np.maximum(sqdist, 0))
            med = np.median(d[d > 0]) if (d > 0).any() else 1.0
        else:
            med = 1.0
        r = np.sqrt(np.maximum(sqdist, 1e-30))

        ls_vec = med * np.logspace(-0.6, 0.6, self.ls_grid)
        Ks = _matern52_from_r(r[None] / ls_vec[:, None, None])
        ii = np.arange(n)
        Ks[:, ii, ii] += self.noise
        try:
            Ls = np.linalg.cholesky(Ks)
            ok = np.ones(self.ls_grid, dtype=bool)
        except np.linalg.LinAlgError:
            # some lengthscale is non-PD: factorize slice-by-slice so the
            # rest of the grid still competes (reference: -inf MLL)
            Ls = np.zeros_like(Ks)
            ok = np.zeros(self.ls_grid, dtype=bool)
            for g in range(self.ls_grid):
                try:
                    Ls[g] = np.linalg.cholesky(Ks[g])
                    ok[g] = True
                except np.linalg.LinAlgError:
                    pass
        best_g, best_mll, best_alpha = None, -np.inf, None
        for g in range(self.ls_grid):
            if not ok[g]:
                continue
            alpha = cho_solve((Ls[g], True), self.y)
            logdet = 2 * np.sum(np.log(Ls[g][ii, ii]))
            mll = float(-0.5 * self.y @ alpha - 0.5 * logdet)
            if mll > best_mll:
                best_g, best_mll, best_alpha = g, mll, alpha
        if best_g is None:
            # every grid point failed; mirror the reference exactly — it
            # falls back to ls=med and lets cho_factor raise (or succeed)
            self.ls = float(med)
            K = _matern52_from_r(r / med)
            K[ii, ii] += self.noise
            self._chol = cho_factor(K, lower=True)
            self._alpha = cho_solve(self._chol, self.y)
        else:
            self.ls = float(ls_vec[best_g])
            self._chol = (Ls[best_g], True)
            self._alpha = best_alpha
        self._fitted = True
        return self

    def predict(self, Xq: np.ndarray, *,
                sqdist: Optional[np.ndarray] = None):
        """-> (mean, std) in the original y units.  ``sqdist``: optional
        precomputed query x train squared distances."""
        Xq = np.asarray(Xq, float)
        if sqdist is None:
            sqdist = pairwise_sqdist(Xq, self.X)
        Kq = _matern52_from_r(np.sqrt(np.maximum(sqdist, 1e-30)) / self.ls)
        mu = Kq @ self._alpha
        v = cho_solve(self._chol, Kq.T)
        var = np.maximum(1.0 + self.noise - np.sum(Kq.T * v, axis=0), 1e-12)
        return (mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std)
