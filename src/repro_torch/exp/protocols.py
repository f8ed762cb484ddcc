"""Figure protocols decomposed into engine work units + thin aggregation.

Each protocol (Figs. 2-4) expands into independent cells, runs them
through an :class:`~repro_torch.exp.engine.ExperimentEngine`, and aggregates
the returned evaluation traces exactly as the legacy serial loops in
``repro_torch.core.evaluate`` did — same nesting order, same float reduction
order — so engine output is bit-identical to the historical path for
fixed seeds, at any worker count.

Two execution granularities (``granularity=``) produce bit-identical
aggregates:

``"run"``
    One work unit per (method, workload, target, seed, budget) cell;
    the unit runs the whole search inline in a worker (the historical
    behaviour).
``"eval"``
    The method's suspendable driver executes in this process and every
    batch of ``(provider, config)`` requests it yields is dispatched as
    ``eval`` work units through the engine (see
    :func:`repro_torch.exp.runners.drive_units`): single evaluations are
    memoized in the store and shared across methods, seeds, and the
    budget grid — on the offline dataset a warm store replays the whole
    fig2 grid with ``computed=0``, and on live objectives batched arm
    pulls fan out through the executor concurrently.

Method metadata (which methods exist, which are budget-coupled) comes
from the method registry (:mod:`repro_torch.core.registry`) — the former
``BUDGET_COUPLED`` frozenset literal here is now a live view of it.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.objectives import bind_objective
from repro_torch.core.registry import BUDGET_COUPLED, get_method
from repro_torch.exp.engine import ExperimentEngine, WorkUnit
from repro_torch.exp.executors import ExecutorSpec
from repro_torch.exp.runners import drive_units, search_runner
from repro_torch.exp.store import BaseResultStore, ResultStore, open_store

GRANULARITIES = ("run", "eval")


def experiment_engine(binding=None, *, dataset=None,
                      context: Optional[dict] = None,
                      workers: int = 1,
                      store: Optional[BaseResultStore] = None,
                      store_path: Optional[str] = None,
                      store_dir: Optional[str] = None,
                      executor: ExecutorSpec = None,
                      executor_kwargs: Optional[dict] = None,
                      unit_timeout_s: Optional[float] = None,
                      retries: int = 0,
                      mp_context: Optional[str] = None,
                      local_context: Optional[dict] = None,
                      runner=search_runner,
                      verbose: bool = False) -> ExperimentEngine:
    """THE engine factory — one construction path for every entrypoint.

    ``binding`` (optional) is an :class:`~repro_torch.core.objectives.
    ObjectiveBinding`: its code-relevant ``context()`` (e.g. the offline
    objective's ``dataset_seed``) is folded into every unit's content
    hash.  ``dataset`` is the offline-dataset convenience spelling of
    the same thing (contributes ``dataset_seed``).  ``context`` adds or
    overrides identity fields explicitly; ``local_context`` carries
    operational knobs runners need but which must not affect identity
    (``out_dir``, ``src_path``, ``objective_modules`` for custom
    objectives on process/remote workers).

    ``store_dir`` selects the sharded multi-writer layout; ``store_path``
    the single-file one; ``store`` injects any prebuilt store.
    ``unit_timeout_s``/``retries`` are the engine's fault-tolerance
    budget (operational too); ``executor_kwargs`` reaches the backend
    constructor (e.g. ``hosts=`` for the remote executor); ``runner``
    swaps the unit runner (e.g. ``dryrun_runner``).
    """
    ctx: dict = {}
    if dataset is not None:
        ctx["dataset_seed"] = int(dataset.seed)
    if binding is not None:
        ctx.update(binding.context())
    ctx.update(context or {})
    if store is None:
        store = open_store(store_dir) if store_dir else ResultStore(store_path)
    return ExperimentEngine(
        runner, context=ctx,
        store=store, workers=workers, executor=executor,
        executor_kwargs=executor_kwargs, unit_timeout_s=unit_timeout_s,
        retries=retries, mp_context=mp_context,
        local_context=local_context, verbose=verbose)


def make_objective_engine(**kwargs) -> ExperimentEngine:
    """Deprecated spelling of :func:`experiment_engine` (kept as a thin
    shim — identical construction, a ``DeprecationWarning``, nothing
    else)."""
    warnings.warn(
        "make_objective_engine() is deprecated; use "
        "repro_torch.exp.experiment_engine(...)",
        DeprecationWarning, stacklevel=2)
    return experiment_engine(**kwargs)


def make_engine(dataset, **kwargs) -> ExperimentEngine:
    """Deprecated spelling of ``experiment_engine(dataset=...)`` (thin
    shim with a ``DeprecationWarning``)."""
    warnings.warn(
        "make_engine(dataset) is deprecated; use "
        "repro_torch.exp.experiment_engine(dataset=dataset)",
        DeprecationWarning, stacklevel=2)
    return experiment_engine(dataset=dataset, **kwargs)


def _search_unit(method: str, workload: str, target: str, seed: int,
                 budget: int) -> WorkUnit:
    return WorkUnit.make("search", method=method, workload=workload,
                         target=target, seed=int(seed), budget=int(budget))


def _run_cells(engine: ExperimentEngine, dataset,
               cells: Sequence[Tuple[str, str, str, int, int]],
               granularity: str) -> List[List[float]]:
    """Execute search cells ``(method, workload, target, seed, budget)``
    at the requested granularity; returns each cell's raw evaluation
    trace, aligned with ``cells``."""
    if granularity not in GRANULARITIES:
        raise ValueError(f"granularity must be one of {GRANULARITIES}, "
                         f"got {granularity!r}")
    if granularity == "run":
        units = [_search_unit(m, w, t, s, b) for m, w, t, s, b in cells]
        results = engine.run(units)
        out = []
        for (m, w, _t, _s, _b), res in zip(cells, results):
            if res is None:
                raise RuntimeError(
                    f"unit failed for {m}/{w}: "
                    + "; ".join(engine.stats.errors[:3]))
            out.append(res["values"])
        return out
    driver_cells = [
        (get_method(m).make_driver(dataset.domain, b, s, target=t),
         bind_objective("offline", workload=w, target=t,
                        dataset_seed=int(dataset.seed)))
        for m, w, t, s, b in cells
    ]
    return [h.values for h in drive_units(engine, driver_cells)]


# ---------------------------------------------------------------------------
# Figs. 2-3: mean regret over seeds × workloads per budget
# ---------------------------------------------------------------------------
def regret_curves(dataset, methods: Sequence[str], budgets: Sequence[int],
                  seeds: Sequence[int], target: str,
                  workloads: Optional[Sequence[str]] = None, *,
                  engine: Optional[ExperimentEngine] = None,
                  workers: int = 1, store: Optional[BaseResultStore] = None,
                  store_path: Optional[str] = None,
                  store_dir: Optional[str] = None,
                  executor: ExecutorSpec = None,
                  granularity: str = "run") -> Dict[str, List[float]]:
    workloads = list(workloads or dataset.workloads)
    engine = engine or experiment_engine(dataset=dataset, workers=workers, store=store,
                                   store_path=store_path,
                                   store_dir=store_dir, executor=executor)
    max_b = max(budgets)
    cells: List[tuple] = []        # (method, workload, target, seed, budget)
    slots: List[tuple] = []        # (method, workload, fixed_budget|None)
    for method in methods:
        for w in workloads:
            for seed in seeds:
                if method in BUDGET_COUPLED:
                    for b in budgets:
                        cells.append((method, w, target, seed, int(b)))
                        slots.append((method, w, int(b)))
                else:
                    cells.append((method, w, target, seed, max_b))
                    slots.append((method, w, None))
    traces = _run_cells(engine, dataset, cells, granularity)

    per_budget = {(m, int(b)): [] for m in methods for b in budgets}
    for (method, w, b), values in zip(slots, traces):
        task = dataset.task(w, target)
        if b is not None:
            per_budget[(method, b)].append(task.regret(min(values)))
        else:
            curve = np.minimum.accumulate(np.asarray(values))
            for bb in budgets:
                per_budget[(method, int(bb))].append(
                    task.regret(curve[min(bb, len(curve)) - 1]))
    return {m: [float(np.mean(per_budget[(m, int(b))])) for b in budgets]
            for m in methods}


# ---------------------------------------------------------------------------
# Fig. 2 horizontal lines: predictive methods
# ---------------------------------------------------------------------------
def predictive_regret(dataset, methods: Sequence[str],
                      seeds: Sequence[int], target: str,
                      workloads: Optional[Sequence[str]] = None, *,
                      engine: Optional[ExperimentEngine] = None,
                      workers: int = 1,
                      store: Optional[BaseResultStore] = None,
                      store_path: Optional[str] = None,
                      store_dir: Optional[str] = None,
                      executor: ExecutorSpec = None) -> Dict[str, float]:
    workloads = list(workloads or dataset.workloads)
    engine = engine or experiment_engine(dataset=dataset, workers=workers, store=store,
                                   store_path=store_path,
                                   store_dir=store_dir, executor=executor)
    units = [
        WorkUnit.make("predictive", method=m, workload=w, target=target,
                      seed=int(seed))
        for m in methods for w in workloads for seed in seeds
    ]
    results = engine.run(units)
    out: Dict[str, float] = {}
    i = 0
    for m in methods:
        vals = []
        for _w in workloads:
            for _s in seeds:
                res = results[i]
                i += 1
                if res is None:
                    raise RuntimeError(f"predictive unit failed for {m}")
                vals.append(res["regret"])
        out[m] = float(np.mean(vals))
    return out


# ---------------------------------------------------------------------------
# Fig. 4: production savings distribution
# ---------------------------------------------------------------------------
def savings_distribution(dataset, method: str, *, budget: int = 33,
                         n_production: int = 64,
                         seeds: Sequence[int] = (0,), target: str = "cost",
                         workloads: Optional[Sequence[str]] = None,
                         engine: Optional[ExperimentEngine] = None,
                         workers: int = 1,
                         store: Optional[BaseResultStore] = None,
                         store_path: Optional[str] = None,
                         store_dir: Optional[str] = None,
                         executor: ExecutorSpec = None,
                         granularity: str = "run") -> np.ndarray:
    # lazy: keeps `import repro_torch.exp` light for workers/CLI processes
    from repro_torch.core.evaluate import savings_from_values
    workloads = list(workloads or dataset.workloads)
    engine = engine or experiment_engine(dataset=dataset, workers=workers, store=store,
                                   store_path=store_path,
                                   store_dir=store_dir, executor=executor)
    b = dataset.domain.size() if method == "exhaustive" else budget
    cells = [(method, w, target, seed, int(b))
             for w in workloads for seed in seeds]
    traces = _run_cells(engine, dataset, cells, granularity)
    out = []
    i = 0
    for w in workloads:
        task = dataset.task(w, target)
        vals = []
        for _s in seeds:
            # the Sec. IV-E formula lives in repro_torch.core.evaluate
            vals.append(savings_from_values(task, traces[i], n_production))
            i += 1
        out.append(float(np.mean(vals)))
    return np.asarray(out)
