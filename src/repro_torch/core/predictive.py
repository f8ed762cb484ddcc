"""Predictive (model-based, non-search) baselines.

* :class:`LinearPredictor` — Ernest-style [31]: a linear scaling model
  per (provider, node-type) over features (1, 1/n, log n, n) of the cluster
  size, trained leave-one-out over cluster sizes (the paper's strictly
  best-case adaptation: full-dataset online evaluations).
* :class:`RFPredictor` — PARIS-style [33]: one RF per provider over
  configuration features + a workload fingerprint made of the target
  workload's measured expense on 2 reference configurations per provider
  (6 online evaluations total), trained offline on every OTHER workload.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.domain import Domain
from repro_torch.core.surrogates import RandomForest


def _ernest_feats(n: float) -> np.ndarray:
    return np.array([1.0, 1.0 / n, np.log(n), n])


class LinearPredictor:
    """objective(provider, config) is only used as the measurement source;
    predictions are leave-one-out over the shared 'nodes' parameter."""

    def __init__(self, domain: Domain, node_param: str = "nodes"):
        self.domain = domain
        self.node_param = node_param

    def recommend(self, objective: Callable[[str, dict], float]
                  ) -> Tuple[str, dict, float, int]:
        """-> (provider, config, predicted value, evaluations used)."""
        best = (None, None, np.inf)
        evals = 0
        for prov in self.domain.provider_names:
            cands = self.domain.inner_candidates(prov)
            # group by everything except node count
            groups: Dict[tuple, List[dict]] = {}
            for c in cands:
                key = tuple(sorted((k, v) for k, v in c.items()
                                   if k != self.node_param))
                groups.setdefault(key, []).append(c)
            for key, cfgs in groups.items():
                ys = {c[self.node_param]: objective(prov, c) for c in cfgs}
                evals += len(cfgs)
                for c in cfgs:
                    n = c[self.node_param]
                    train = [(m, v) for m, v in ys.items() if m != n]
                    X = np.stack([_ernest_feats(m) for m, _ in train])
                    y = np.array([v for _, v in train])
                    w, *_ = np.linalg.lstsq(X, y, rcond=None)
                    pred = float(_ernest_feats(n) @ w)
                    if pred < best[2]:
                        best = (prov, c, pred)
        return best[0], best[1], best[2], evals


class RFPredictor:
    def __init__(self, domain: Domain, *, n_refs: int = 2, seed: int = 0):
        self.domain = domain
        self.n_refs = n_refs
        self.rng = np.random.default_rng(seed)

    def recommend(
        self,
        target_objective: Callable[[str, dict], float],
        offline: Dict[int, Callable[[str, dict], float]],
    ) -> Tuple[str, dict, float, int]:
        """offline: other-workload objectives (the offline dataset).

        -> (provider, config, predicted value, online evaluations used)
        """
        online_evals = 0
        best = (None, None, np.inf)
        for prov in self.domain.provider_names:
            cands = self.domain.inner_candidates(prov)
            enc = self.domain.inner_encoder(prov)
            refs = [cands[i] for i in
                    self.rng.choice(len(cands), self.n_refs, replace=False)]
            # target workload fingerprint (online evaluations)
            fp_t = np.array([target_objective(prov, r) for r in refs])
            online_evals += self.n_refs
            fp_t = np.log1p(fp_t)
            # grid encodings are workload-independent: encode once, tile a
            # fingerprint block per offline workload
            enc_c = enc.encode_many(cands)
            Xs, ys = [], []
            for wid, obj in offline.items():
                fp = np.log1p(np.array([obj(prov, r) for r in refs]))
                Xs.append(np.hstack([enc_c, np.tile(fp, (len(cands), 1))]))
                ys.append(np.log1p(np.array([obj(prov, c) for c in cands])))
            model = RandomForest(n_trees=30, seed=int(
                self.rng.integers(2 ** 31))).fit(
                    np.vstack(Xs), np.concatenate(ys))
            Xq = np.hstack([enc_c, np.tile(fp_t, (len(cands), 1))])
            mu, _ = model.predict(Xq)
            i = int(np.argmin(mu))
            pred = float(np.expm1(mu[i]))
            if pred < best[2]:
                best = (prov, cands[i], pred)
        return best[0], best[1], best[2], online_evals
