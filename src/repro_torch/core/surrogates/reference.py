"""Reference (pre-vectorization) surrogate implementations.

These are the scalar GP and random-forest regressors exactly as they stood
before the vectorized rewrite in :mod:`repro_torch.core.surrogates.gp` /
:mod:`repro_torch.core.surrogates.rf` — kept verbatim as the ground truth the
fast paths are tested bit-identical against (``tests/test_surrogates.py``),
mirroring the ``build_dataset_reference`` pattern.  They are also the
baseline side of the ``benchmarks/surrogates.py`` microbenchmarks, so the
recorded speedups stay measured against the real historical code rather
than a drifting approximation.

Do not "improve" anything here: slowness is the point.
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import cho_factor, cho_solve


# ---------------------------------------------------------------------------
# GP (Matern 5/2), scalar: recomputes pairwise distances on every kernel
# evaluation — 7x per fit (median heuristic + 5-point MLL grid + final).
# ---------------------------------------------------------------------------
def matern52_reference(X1: np.ndarray, X2: np.ndarray, ls: float) -> np.ndarray:
    d = np.sqrt(np.maximum(
        np.sum((X1[:, None] - X2[None]) ** 2, -1), 1e-30)) / ls
    s5 = np.sqrt(5.0) * d
    return (1 + s5 + 5.0 * d * d / 3.0) * np.exp(-s5)


class GPReference:
    def __init__(self, noise: float = 1e-3, ls_grid: int = 5):
        self.noise = noise
        self.ls_grid = ls_grid
        self._fitted = False

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GPReference":
        self.X = np.asarray(X, float)
        y = np.asarray(y, float)
        self.y_mean = y.mean()
        self.y_std = y.std() + 1e-12
        self.y = (y - self.y_mean) / self.y_std

        # median-heuristic lengthscale (+ small MLL grid refinement)
        if len(X) > 1:
            d = np.sqrt(np.maximum(
                np.sum((self.X[:, None] - self.X[None]) ** 2, -1), 0))
            med = np.median(d[d > 0]) if (d > 0).any() else 1.0
        else:
            med = 1.0
        best_ls, best_mll = med, -np.inf
        for f in np.logspace(-0.6, 0.6, self.ls_grid):
            ls = med * f
            mll = self._mll(ls)
            if mll > best_mll:
                best_ls, best_mll = ls, mll
        self.ls = best_ls
        K = matern52_reference(self.X, self.X, self.ls)
        K[np.diag_indices_from(K)] += self.noise
        self._chol = cho_factor(K, lower=True)
        self._alpha = cho_solve(self._chol, self.y)
        self._fitted = True
        return self

    def _mll(self, ls: float) -> float:
        K = matern52_reference(self.X, self.X, ls)
        K[np.diag_indices_from(K)] += self.noise
        try:
            c = cho_factor(K, lower=True)
        except np.linalg.LinAlgError:
            return -np.inf
        alpha = cho_solve(c, self.y)
        logdet = 2 * np.sum(np.log(np.diag(c[0])))
        return float(-0.5 * self.y @ alpha - 0.5 * logdet)

    def predict(self, Xq: np.ndarray):
        """-> (mean, std) in the original y units."""
        Kq = matern52_reference(np.asarray(Xq, float), self.X, self.ls)
        mu = Kq @ self._alpha
        v = cho_solve(self._chol, Kq.T)
        var = np.maximum(1.0 + self.noise - np.sum(Kq.T * v, axis=0), 1e-12)
        return (mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std)


# ---------------------------------------------------------------------------
# Random forest, scalar: recursive build with a per-threshold Python loop
# (O(n^2) SSE scans per feature) and a per-row/per-tree predict loop.
# ---------------------------------------------------------------------------
class _Tree:
    __slots__ = ("feature", "thresh", "left", "right", "value")

    def __init__(self):
        self.feature = -1
        self.value = 0.0


def _build(X, y, rng, *, max_depth, min_leaf, n_feats, extra):
    tree = _Tree()
    if max_depth == 0 or len(y) < 2 * min_leaf or np.ptp(y) < 1e-12:
        tree.value = float(y.mean())
        return tree
    d = X.shape[1]
    feats = rng.choice(d, size=min(n_feats, d), replace=False)
    best = (None, None, np.inf)
    for f in feats:
        col = X[:, f]
        lo, hi = col.min(), col.max()
        if hi <= lo:
            continue
        if extra:
            threshes = [rng.uniform(lo, hi)]
        else:
            vals = np.unique(col)
            threshes = (vals[:-1] + vals[1:]) / 2
        for t in threshes:
            m = col <= t
            nl, nr = m.sum(), (~m).sum()
            if nl < min_leaf or nr < min_leaf:
                continue
            sse = (y[m].var() * nl + y[~m].var() * nr)
            if sse < best[2]:
                best = (f, t, sse)
    if best[0] is None:
        tree.value = float(y.mean())
        return tree
    f, t, _ = best
    m = X[:, f] <= t
    tree.feature, tree.thresh = int(f), float(t)
    tree.left = _build(X[m], y[m], rng, max_depth=max_depth - 1,
                       min_leaf=min_leaf, n_feats=n_feats, extra=extra)
    tree.right = _build(X[~m], y[~m], rng, max_depth=max_depth - 1,
                        min_leaf=min_leaf, n_feats=n_feats, extra=extra)
    return tree


def _predict_one(tree: _Tree, x: np.ndarray) -> float:
    while tree.feature >= 0:
        tree = tree.left if x[tree.feature] <= tree.thresh else tree.right
    return tree.value


class RandomForestReference:
    def __init__(self, n_trees: int = 30, max_depth: int = 12,
                 min_leaf: int = 1, extra: bool = False, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.extra = extra
        self.rng = np.random.default_rng(seed)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestReference":
        X = np.asarray(X, float)
        y = np.asarray(y, float)
        n, d = X.shape
        n_feats = max(1, int(np.ceil(np.sqrt(d))))
        self.trees = []
        for _ in range(self.n_trees):
            idx = self.rng.integers(n, size=n) if not self.extra \
                else np.arange(n)
            self.trees.append(_build(
                X[idx], y[idx], self.rng, max_depth=self.max_depth,
                min_leaf=self.min_leaf, n_feats=n_feats, extra=self.extra))
        return self

    def predict(self, Xq: np.ndarray):
        Xq = np.asarray(Xq, float)
        preds = np.stack([
            np.array([_predict_one(t, x) for x in Xq])
            for t in self.trees])
        return preds.mean(0), preds.std(0) + 1e-9
