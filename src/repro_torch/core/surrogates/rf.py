"""Vectorized random-forest / extra-trees regressors (numpy, from scratch).

Drop-in replacement for the scalar implementation retained in
:mod:`repro_torch.core.surrogates.reference` — bit-identical fitted trees and
predictions (same rng consumption order, same ``<`` tie-breaking in the
split search), several times faster:

* **fit** — the per-threshold Python loop (an O(n) ``np.var`` scan per
  threshold) is replaced by a two-stage search.  Stage 1 *brackets* the
  minimum: columns are rank-encoded once per fit, and a node scores every
  threshold of every candidate feature at once from one ``bincount``
  over the dense ranks (counts, sum y, sum y^2 stacked) + prefix sums —
  no per-node sorting, O(node + features * ranks) total; small nodes use
  a pure-Python running-sum scan with zero numpy dispatch instead.
  Stage 2 makes the
  choice *reference-exact*: only candidates within a rigorous error-margin
  tolerance of the bracketed minimum are re-scored with the reference's
  own ``var``-based arithmetic in reference scan order (features as drawn,
  thresholds ascending, strict ``<``), so mathematical ties break exactly
  as the scalar loop breaks them; a single surviving candidate needs no
  re-score at all — outside the tolerance nothing can beat it.  Either
  way the tree recursion (and hence rng consumption) stays depth-first
  preorder, exactly like the reference.
* **predict** — fitted trees are flattened into contiguous
  ``(feature, thresh, left, right, value)`` arrays spanning the whole
  forest, and prediction is a batched level-synchronous descent over all
  (tree, query-row) pairs — no per-row Python loop.

Variance across trees provides the uncertainty estimate for EI/PI
acquisitions, exactly as before.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

#: shortlist tolerance scale: any candidate whose bracketing-scan SSE is
#: within ``_TIE_TOL * n * scale`` of the scan minimum is re-scored with
#: the reference arithmetic.  ~4e4 float64 ulps of headroom over the
#: worst-case cancellation error of either SSE formulation; over-inclusion
#: only costs an extra O(n) re-score, never correctness.
_TIE_TOL = 1e-11

#: nodes with at most this many rows run a pure-Python split search with
#: zero numpy dispatch — the scan uses running sums, and exact reference
#: arithmetic is recovered via :func:`_np_sum` / :func:`_np_var`, which
#: replay numpy's pairwise-summation kernel (sequential below 8 elements,
#: 8-accumulator blocks up to 128) bit-for-bit.  Must stay <= 128: beyond
#: that numpy switches to recursive halving and the replica diverges.
_PY_N = 24


def _np_sum(lst) -> float:
    """Bitwise replica of ``np.add.reduce`` over a 1-D float64 array of
    length <= 128 (``tests/test_surrogates.py`` guards the equivalence)."""
    n = len(lst)
    if n < 8:
        s = 0.0
        for v in lst:
            s += v
        return s
    r0, r1, r2, r3 = lst[0], lst[1], lst[2], lst[3]
    r4, r5, r6, r7 = lst[4], lst[5], lst[6], lst[7]
    i = 8
    lim = n - (n % 8)
    while i < lim:
        r0 += lst[i]
        r1 += lst[i + 1]
        r2 += lst[i + 2]
        r3 += lst[i + 3]
        r4 += lst[i + 4]
        r5 += lst[i + 5]
        r6 += lst[i + 6]
        r7 += lst[i + 7]
        i += 8
    res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7))
    while i < n:
        res += lst[i]
        i += 1
    return res


def _np_var(lst) -> float:
    """Bitwise replica of ``np.ndarray.var`` (ddof=0) for length <= 128."""
    n = len(lst)
    mean = _np_sum(lst) / n
    return _np_sum([(v - mean) * (v - mean) for v in lst]) / n


class RandomForest:
    def __init__(self, n_trees: int = 30, max_depth: int = 12,
                 min_leaf: int = 1, extra: bool = False, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.extra = extra
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        X = np.asarray(X, float)
        y = np.asarray(y, float)
        n, d = X.shape
        self._d = d
        self._n_feats = max(1, int(np.ceil(np.sqrt(d))))
        self._Xfit = X
        self._Xlist = X.T.tolist()    # per-column python floats (small path)
        # dense rank encoding, once per fit: the split scan works on
        # bincounts over ranks, so nodes never sort
        self._vals: List[np.ndarray] = []
        self._ranks = np.empty((d, n), dtype=np.intp)
        self._degen = np.zeros(d, dtype=bool)
        for f in range(d):
            v, inv = np.unique(X[:, f], return_inverse=True)
            self._vals.append(v)
            self._ranks[f] = inv
            # a midpoint can round up onto the upper value only for
            # 1-ulp-adjacent uniques (a >= 2-ulp gap always has a double
            # strictly below the upper value); any node-subset pair that
            # rounds up is therefore also adjacent here, so this per-fit
            # flag soundly gates the exact fallback for every node
            if len(v) > 1:
                self._degen[f] = bool(((v[:-1] + v[1:]) / 2 >= v[1:]).any())
        self._kmax = max(len(v) for v in self._vals)
        self._nf: List[int] = []      # feature per node (-1 = leaf)
        self._nt: List[float] = []    # threshold per node
        self._nl: List[int] = []      # left-child node id
        self._nr: List[int] = []      # right-child node id
        self._nv: List[float] = []    # leaf value
        roots = []
        for _ in range(self.n_trees):
            idx = self.rng.integers(n, size=n) if not self.extra \
                else np.arange(n)
            roots.append(self._build(idx, y[idx], self.max_depth))
        self._roots = np.asarray(roots, dtype=np.int64)
        self._feature = np.asarray(self._nf, dtype=np.int64)
        self._thresh = np.asarray(self._nt, dtype=np.float64)
        self._left = np.asarray(self._nl, dtype=np.int64)
        self._right = np.asarray(self._nr, dtype=np.int64)
        self._value = np.asarray(self._nv, dtype=np.float64)
        del self._nf, self._nt, self._nl, self._nr, self._nv
        del self._Xfit, self._Xlist, self._ranks, self._vals, self._degen
        return self

    def _emit_leaf_value(self, value: float) -> int:
        i = len(self._nf)
        self._nf.append(-1)
        self._nt.append(0.0)
        self._nl.append(i)
        self._nr.append(i)
        self._nv.append(value)
        return i

    def _emit_leaf(self, y: np.ndarray) -> int:
        return self._emit_leaf_value(float(y.mean()))

    # ------------------------------------------------------------------
    # small/medium nodes: pure-python replay of the reference search with
    # zero numpy dispatch.  Same two-stage structure as the numpy path:
    # a running-sum scan brackets the minimum, the near-minimal shortlist
    # is re-scored with exact reference arithmetic (here the _np_var
    # pairwise-summation replica) in reference scan order.
    # ------------------------------------------------------------------
    def _split_py(self, idx: List[int], y: List[float]):
        m = len(y)
        min_leaf = self.min_leaf
        toty = _np_sum(y)
        toty2 = _np_sum([v * v for v in y])
        cands = []                     # (f, col, t, sse) in scan order
        vmin = np.inf
        feats = self.rng.choice(
            self._d, size=min(self._n_feats, self._d), replace=False)
        for f in feats:
            colf = self._Xlist[f]
            col = [colf[i] for i in idx]
            lo, hi = min(col), max(col)
            if hi <= lo:
                continue
            if self.extra:
                t = self.rng.uniform(lo, hi)
                nl = sum(1 for c in col if c <= t)
                # nl == 0 / nl == m only with min_leaf=0 and a draw that
                # rounds onto hi: the reference scores the empty side as
                # NaN, which never survives its strict `<` — skip
                if nl < min_leaf or m - nl < min_leaf \
                        or nl == 0 or nl == m:
                    continue
                # single data-independent threshold: score exactly now
                yl = [v for c, v in zip(col, y) if c <= t]
                yr = [v for c, v in zip(col, y) if c > t]
                sse = _np_var(yl) * nl + _np_var(yr) * (m - nl)
                cands.append((int(f), col, t, sse))
                if sse < vmin:
                    vmin = sse
                continue
            pairs = sorted(zip(col, y))
            nl, sy, sy2 = 0, 0.0, 0.0
            for k in range(m - 1):
                cv, yv = pairs[k]
                nl += 1
                sy += yv
                sy2 += yv * yv
                nxt = pairs[k + 1][0]
                if nxt <= cv:          # not a value boundary
                    continue
                t = (cv + nxt) / 2
                if t >= nxt:
                    # midpoint rounded up onto the next value (1-ulp
                    # adjacent): the rank partition no longer models
                    # `col <= t` — replay this node with the exact scan
                    # (no rng consumed since `feats` was drawn)
                    return self._best_split_exact(
                        np.asarray(idx), np.asarray(y, float), feats)
                nr = m - nl
                if nl < min_leaf or nr < min_leaf:
                    continue
                ry = toty - sy
                ry2 = toty2 - sy2
                sse = (sy2 - sy * sy / nl) + (ry2 - ry * ry / nr)
                cands.append((int(f), col, t, sse))
                if sse < vmin:
                    vmin = sse
        if not cands:
            return None
        tol = _TIE_TOL * m * (toty2 + toty * toty / m + 1.0)
        short = [c for c in cands if c[3] <= vmin + tol]
        if len(short) == 1 and not self.extra:
            return short[0][0], short[0][2]
        best_f, best_t, best_sse = -1, 0.0, np.inf
        for f, col, t, sse in short:
            if not self.extra:         # re-score with reference arithmetic
                yl = [v for c, v in zip(col, y) if c <= t]
                yr = [v for c, v in zip(col, y) if c > t]
                sse = _np_var(yl) * len(yl) + _np_var(yr) * len(yr)
            if sse < best_sse:
                best_f, best_t, best_sse = f, t, sse
        return best_f, best_t

    def _build_py(self, idx: List[int], y: List[float], depth: int) -> int:
        m = len(y)
        if depth == 0 or m < 2 * self.min_leaf or max(y) - min(y) < 1e-12:
            return self._emit_leaf_value(_np_sum(y) / m)
        best = self._split_py(idx, y)
        if best is None:
            return self._emit_leaf_value(_np_sum(y) / m)
        best_f, best_t = best
        colf = self._Xlist[best_f]
        il, yl, ir, yr = [], [], [], []
        for i, v in zip(idx, y):
            if colf[i] <= best_t:
                il.append(i)
                yl.append(v)
            else:
                ir.append(i)
                yr.append(v)
        node = len(self._nf)
        self._nf.append(best_f)
        self._nt.append(float(best_t))
        self._nl.append(0)
        self._nr.append(0)
        self._nv.append(0.0)
        self._nl[node] = self._build_py(il, yl, depth - 1)
        self._nr[node] = self._build_py(ir, yr, depth - 1)
        return node

    def _best_split_exact(self, idx: np.ndarray, y: np.ndarray,
                          feats) -> Optional[Tuple[int, float]]:
        """Verbatim reference scan — the slow path for nodes that drew a
        feature with 1-ulp-adjacent unique values, where a between-values
        midpoint can round up onto the upper value and the rank-based
        bracketing scan no longer models the actual ``col <= t``
        partition.  Consumes no rng, so dispatching here is invisible to
        the consumption order."""
        min_leaf = self.min_leaf
        best = (None, 0.0, np.inf)
        for f in feats:
            col = self._Xfit[idx, f]
            lo, hi = col.min(), col.max()
            if hi <= lo:
                continue
            vals = np.unique(col)
            for t in (vals[:-1] + vals[1:]) / 2:
                msk = col <= t
                nl, nr = msk.sum(), (~msk).sum()
                if nl < min_leaf or nr < min_leaf:
                    continue
                sse = y[msk].var() * nl + y[~msk].var() * nr
                if sse < best[2]:
                    best = (int(f), float(t), sse)
        return None if best[0] is None else (best[0], best[1])

    def _best_split(self, idx: np.ndarray, y: np.ndarray,
                    feats: np.ndarray) -> Optional[Tuple[int, float]]:
        """Reference-identical (feature, thresh) minimizing the split SSE
        over the node's rows ``idx`` (original-row indices, repeats kept).
        """
        if self._degen[feats].any():
            return self._best_split_exact(idx, y, feats)
        m = len(y)
        min_leaf = self.min_leaf
        kmax = self._kmax
        nfe = len(feats)
        sub = self._ranks[feats[:, None], idx]               # (F, m)
        flat = (sub + (np.arange(nfe) * kmax)[:, None]).ravel()
        length = nfe * kmax
        # one bincount for (counts, sum y, sum y^2): stack three copies of
        # the rank keys with per-stat offsets and matching weights
        w = np.empty(3 * nfe * m)
        w[:nfe * m] = 1.0
        wy = np.broadcast_to(y, (nfe, m)).ravel()
        w[nfe * m:2 * nfe * m] = wy
        np.multiply(wy, wy, out=w[2 * nfe * m:])
        keys = np.concatenate(
            (flat, flat + length, flat + 2 * length))
        cnt, sy, sy2 = np.bincount(
            keys, weights=w, minlength=3 * length).reshape(3, nfe, kmax)
        nl = cnt.cumsum(axis=1)
        csy = sy.cumsum(axis=1)
        csy2 = sy2.cumsum(axis=1)
        nr = m - nl
        # a threshold follows every rank that is present in the node and
        # leaves at least one row on each side (>= 1 even when min_leaf
        # is 0: the reference only enumerates between-value midpoints)
        ml1 = min_leaf if min_leaf > 0 else 1
        valid = (cnt > 0) & (nl >= ml1) & (nr >= ml1)
        if not valid.any():
            return None
        tot_y = csy[:, -1:]
        tot_y2 = csy2[:, -1:]
        sse = np.where(
            valid,
            (csy2 - csy * csy / np.maximum(nl, 1))
            + ((tot_y2 - csy2)
               - (tot_y - csy) ** 2 / np.maximum(nr, 1)),
            np.inf)
        # tolerance scale from the bincount totals (no extra reductions);
        # bucket-order summation differences are far below the margin
        tol = _TIE_TOL * m * (
            float(tot_y2[0, 0]) + float(tot_y[0, 0]) ** 2 / m + 1.0)
        fi_arr, j_arr = np.nonzero(sse <= sse.min() + tol)

        def thresh(fi: int, j: int) -> float:
            # midpoint between this rank's value and the next rank
            # present in the node — bitwise what the reference gets from
            # np.unique of the node's column
            v = self._vals[feats[fi]]
            row = cnt[fi]
            j2 = j + 1
            while row[j2] == 0:
                j2 += 1
            return (v[j] + v[j2]) / 2

        if len(fi_arr) == 1:
            # unique bracketed minimum: nothing outside the tolerance can
            # beat it under reference arithmetic either
            fi, j = int(fi_arr[0]), int(j_arr[0])
            return int(feats[fi]), thresh(fi, j)
        # re-score the shortlist with the reference's arithmetic, in
        # reference scan order (np.nonzero is row-major: features as
        # drawn, thresholds ascending)
        best = (None, 0.0, np.inf)
        for fi, j in zip(fi_arr.tolist(), j_arr.tolist()):
            f = int(feats[fi])
            t = thresh(fi, j)
            msk = self._Xfit[idx, f] <= t
            nl2, nr2 = msk.sum(), (~msk).sum()
            if nl2 < ml1 or nr2 < ml1:    # defense: actual-mask counts
                continue
            sse_ref = y[msk].var() * nl2 + y[~msk].var() * nr2
            if sse_ref < best[2]:
                best = (f, t, sse_ref)
        return None if best[0] is None else (best[0], best[1])

    def _build(self, idx: np.ndarray, y: np.ndarray, depth: int) -> int:
        m = len(y)
        if m <= _PY_N:
            return self._build_py(idx.tolist(), y.tolist(), depth)
        if depth == 0 or m < 2 * self.min_leaf or y.max() - y.min() < 1e-12:
            return self._emit_leaf(y)
        feats = self.rng.choice(
            self._d, size=min(self._n_feats, self._d), replace=False)
        if self.extra:
            best = None
            best_sse = np.inf
            for f in feats:
                col = self._Xfit[idx, f]
                lo, hi = col.min(), col.max()
                if hi <= lo:
                    continue
                t = self.rng.uniform(lo, hi)
                msk = col <= t
                nl, nr = msk.sum(), (~msk).sum()
                if nl < self.min_leaf or nr < self.min_leaf:
                    continue
                sse = y[msk].var() * nl + y[~msk].var() * nr
                if sse < best_sse:
                    best, best_sse = (int(f), float(t)), sse
        else:
            best = self._best_split(idx, y, feats)
        if best is None:
            return self._emit_leaf(y)
        f, t = best
        mask = self._Xfit[idx, f] <= t
        inv = ~mask
        i = len(self._nf)
        self._nf.append(int(f))
        self._nt.append(float(t))
        self._nl.append(0)
        self._nr.append(0)
        self._nv.append(0.0)
        self._nl[i] = self._build(idx[mask], y[mask], depth - 1)
        self._nr[i] = self._build(idx[inv], y[inv], depth - 1)
        return i

    # ------------------------------------------------------------------
    # predict
    # ------------------------------------------------------------------
    def predict(self, Xq: np.ndarray):
        Xq = np.asarray(Xq, float)
        nq = Xq.shape[0]
        node = np.repeat(self._roots[:, None], nq, axis=1)  # (trees, nq)
        feat = self._feature[node]
        active = feat >= 0
        qcol = np.arange(nq)
        while active.any():
            f = np.where(active, feat, 0)
            go_left = Xq[qcol[None, :], f] <= self._thresh[node]
            nxt = np.where(go_left, self._left[node], self._right[node])
            node = np.where(active, nxt, node)
            feat = self._feature[node]
            active = feat >= 0
        preds = self._value[node]
        return preds.mean(0), preds.std(0) + 1e-9
