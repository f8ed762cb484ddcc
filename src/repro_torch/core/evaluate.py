"""Experiment harness: the paper's evaluation protocol (Figs. 2-4).

Methods are evaluated against an offline dataset task (table-lookup
objective), for budgets B = 11..88, over many seeds; compared by *regret*
(relative distance of the best-found value to the true minimum) and by
production *savings* vs a random configuration (Sec. IV-E):

    S = (N·R_rand − (C_opt + N·R_opt)) / (N·R_rand)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.cloudbandit import CloudBandit, b1_for_budget
from repro_torch.core.domain import Domain
from repro_torch.core.drivers import drive
from repro_torch.core.optimizers import (
    BO, RBFOpt, RandomSearch, SMACLike, TPE, cherrypick, bilal,
    CoordinateDescent, ExhaustiveSearch)
from repro_torch.core.optimizers.base import History
from repro_torch.core.predictive import LinearPredictor, RFPredictor
from repro_torch.core.registry import get_method, method_names
from repro_torch.core.rising_bandits import RisingBandits
from repro_torch.multicloud.dataset import OfflineDataset, Task

#: every registered search method, in registration (paper) order — the
#: single source of truth is the method registry; this module attribute
#: is kept for the many callers/tests that import it
SEARCH_METHODS = method_names(tag="search")
PREDICTIVE_METHODS = ("linear", "rf_paris")


def _point_objective(task: Task):
    return lambda point: task.objective(point[0], point[1])


def _run_flat(opt_cls, task: Task, domain: Domain, budget: int, seed: int,
              encode=None, **kw) -> History:
    """Reference inline loop for flat methods (see run_search_reference)."""
    cands = domain.all_candidates()
    encode = encode or domain.flat_encoder().encode
    opt = opt_cls(cands, encode, seed=seed, **kw)
    return opt.run(_point_objective(task), budget)


def _run_independent(factory, task: Task, domain: Domain, budget: int,
                     seed: int, attr: bool = False) -> History:
    """'x3' adaptation: K independent optimizers, budget split equally
    (reference inline loop; see run_search_reference)."""
    from repro_torch.multicloud.providers import attr_encode_config
    rng = np.random.default_rng(seed)
    hist = History()
    provs = domain.provider_names
    share = budget // len(provs)
    extra = budget - share * len(provs)
    for i, prov in enumerate(provs):
        b = share + (1 if i < extra else 0)
        cands = domain.inner_candidates(prov)
        if attr:
            enc = lambda c, _p=prov: attr_encode_config(_p, c)  # noqa: E731
        else:
            enc = domain.inner_encoder(prov).encode
        opt = factory(cands, enc, seed=int(rng.integers(2 ** 31)))
        for _ in range(b):
            idx = opt.ask()
            val = task.objective(prov, opt.candidates[idx])
            opt.tell(idx, val)
            hist.append((prov, opt.candidates[idx]), val)
    return hist


def run_search(method: str, task: Task, domain: Domain, budget: int,
               seed: int) -> History:
    """Run one search method to completion against a task objective.

    Dispatch goes through the method registry: the registered driver
    factory builds a suspendable :class:`~repro_torch.core.drivers.SearchDriver`
    for this cell and :func:`~repro_torch.core.drivers.drive` closes the loop
    inline — bit-identical to :func:`run_search_reference`, the retained
    legacy inline-loop implementation.
    """
    spec = get_method(method)
    driver = spec.make_driver(domain, budget, seed, target=task.target)
    return drive(driver, task.objective)


def run_search_reference(method: str, task: Task, domain: Domain,
                         budget: int, seed: int) -> History:
    """The pre-driver closed-loop implementation (inline objective
    calls, if/elif dispatch), retained verbatim as the ground truth for
    the driver bit-identity suite (``tests/test_drivers.py``)."""
    target = task.target
    if method == "random":
        return _run_flat(RandomSearch, task, domain, budget, seed)
    if method == "cd":
        return _run_flat(CoordinateDescent, task, domain, budget, seed)
    if method == "exhaustive":
        return _run_flat(ExhaustiveSearch, task, domain,
                         min(budget, domain.size()), seed)
    if method == "cherrypick_x1":
        from repro_torch.multicloud.providers import attr_encode_point
        return _run_flat(BO, task, domain, budget, seed,
                         encode=attr_encode_point, surrogate="gp", acq="ei")
    if method == "cherrypick_x3":
        return _run_independent(cherrypick, task, domain, budget, seed,
                                attr=True)
    if method == "bilal_x1":
        from repro_torch.multicloud.providers import attr_encode_point
        kw = dict(surrogate="gp", acq="lcb") if target == "cost" else \
            dict(surrogate="rf", acq="pi")
        return _run_flat(BO, task, domain, budget, seed,
                         encode=attr_encode_point, **kw)
    if method == "bilal_x3":
        return _run_independent(
            lambda c, e, seed=0: bilal(c, e, seed, target=target),
            task, domain, budget, seed, attr=True)
    if method == "smac":
        return _run_flat(SMACLike, task, domain, budget, seed)
    if method == "hyperopt":
        cands = domain.all_candidates()
        enc = domain.flat_encoder()
        opt = TPE(cands, enc.encode, seed=seed, domain=domain)
        return opt.run(_point_objective(task), budget)
    if method == "rb":
        rb = RisingBandits(domain, seed=seed)
        _, _, _, hist = rb.run(task.objective, budget)
        return hist
    if method in ("cb_cherrypick", "cb_rbfopt"):
        factory = cherrypick if method == "cb_cherrypick" else RBFOpt
        b1 = b1_for_budget(budget, len(domain.provider_names))
        cb = CloudBandit(domain, factory, b1=b1, seed=seed)
        return cb.run(task.objective).history
    raise ValueError(method)


def run_predictive(method: str, task: Task, dataset: OfflineDataset,
                   seed: int) -> Dict:
    domain = dataset.domain
    if method == "linear":
        prov, cfg, _pred, evals = LinearPredictor(domain).recommend(
            task.objective)
    elif method == "rf_paris":
        offline = dataset.offline_objectives(task.target, task.workload)
        prov, cfg, _pred, evals = RFPredictor(domain, seed=seed).recommend(
            task.objective, offline)
    else:
        raise ValueError(method)
    actual = task.objective(prov, cfg)
    return {"provider": prov, "config": cfg, "value": actual,
            "regret": task.regret(actual), "online_evals": evals}


# ---------------------------------------------------------------------------
# Aggregation (Figs. 2-3): mean regret over seeds × workloads per budget.
# Thin wrappers over the experiment engine (repro_torch.exp): units fan out over
# a process pool when workers > 1 and replay from the JSONL store when a
# store/store_path is given; workers=1 with no store reproduces the
# historical in-process serial behaviour bit-for-bit.
# ---------------------------------------------------------------------------
def regret_curves(dataset: OfflineDataset, methods: Sequence[str],
                  budgets: Sequence[int], seeds: Sequence[int],
                  target: str, workloads: Optional[Sequence[str]] = None,
                  *, workers: int = 1, store=None,
                  store_path: Optional[str] = None, engine=None,
                  granularity: str = "run") -> Dict[str, List[float]]:
    from repro_torch.exp import protocols
    return protocols.regret_curves(
        dataset, methods, budgets, seeds, target, workloads,
        workers=workers, store=store, store_path=store_path, engine=engine,
        granularity=granularity)


def predictive_regret(dataset: OfflineDataset, methods: Sequence[str],
                      seeds: Sequence[int], target: str,
                      workloads: Optional[Sequence[str]] = None,
                      *, workers: int = 1, store=None,
                      store_path: Optional[str] = None,
                      engine=None) -> Dict[str, float]:
    from repro_torch.exp import protocols
    return protocols.predictive_regret(
        dataset, methods, seeds, target, workloads,
        workers=workers, store=store, store_path=store_path, engine=engine)


# ---------------------------------------------------------------------------
# Savings analysis (Fig. 4)
# ---------------------------------------------------------------------------
def savings_from_values(task: Task, values: Sequence[float],
                        n_production: int) -> float:
    """The Sec. IV-E savings expression — the one place it is written.

    ``values`` is a search's raw evaluation trace (``History.values`` or
    an engine unit's stored ``result["values"]``).
    """
    c_opt = float(np.sum(values))               # one-time search expense
    r_opt = float(np.min(values))               # optimized per-run expense
    r_rand = task.mean_value()                  # expected random expense
    n = n_production
    return (n * r_rand - (c_opt + n * r_opt)) / (n * r_rand)


def savings_for_history(task: Task, hist: History, n_production: int
                        ) -> float:
    return savings_from_values(task, hist.values, n_production)


def savings_distribution(dataset: OfflineDataset, method: str, *,
                         budget: int = 33, n_production: int = 64,
                         seeds: Sequence[int] = (0,), target: str = "cost",
                         workloads: Optional[Sequence[str]] = None,
                         workers: int = 1, store=None,
                         store_path: Optional[str] = None,
                         engine=None, granularity: str = "run") -> np.ndarray:
    """Per-workload savings (averaged over seeds) — the Fig. 4 box plots."""
    from repro_torch.exp import protocols
    return protocols.savings_distribution(
        dataset, method, budget=budget, n_production=n_production,
        seeds=seeds, target=target, workloads=workloads,
        workers=workers, store=store, store_path=store_path, engine=engine,
        granularity=granularity)
