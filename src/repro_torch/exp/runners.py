"""Work-unit runners: module-level callables the engine can fan out.

Every runner has the signature ``(kind, params, context) -> dict`` with
JSON-serializable inputs/outputs, and derives all randomness from the
unit's own seed — the engine's determinism guarantee rests on that.

Two granularities of search work unit share :func:`search_runner`:

``search``
    One whole (method, workload, target, seed, budget) run — the unit
    the protocols historically fanned out.
``eval``
    One objective evaluation ``(provider, config)`` against a
    registered objective (:mod:`repro_torch.core.objectives`) — the offline
    table by default, a compile measurement when the unit carries an
    ``objective`` field.  Emitted by :func:`drive_units`, the
    driver-runner that executes suspendable search drivers in-process
    and dispatches every batch of evaluation requests they yield
    through the engine — so identical evaluations are memoized across
    methods, seeds, and the budget grid, and a batch's requests fan out
    through whatever executor backend the engine is wired with.  Note
    the unit's content key has no method/seed/budget in it: that is
    what makes the cache shared.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import warnings
from typing import Any, Dict, List, Sequence, Tuple, Union

from repro_torch.core.objectives import ObjectiveBinding, bind_objective, \
    get_objective
from repro_torch.exp.engine import EngineStats, ExperimentEngine, WorkUnit


# ---------------------------------------------------------------------------
# Offline-dataset search/predictive units (Figs. 2-4 protocols)
# ---------------------------------------------------------------------------
def search_runner(kind: str, params: Dict[str, Any],
                  context: Dict[str, Any]) -> dict:
    """Execute one (method, workload, target, seed[, budget]) cell against
    the offline dataset, or one ``eval`` unit against whatever objective
    its content key names.  ``build_dataset`` is memoized, so each
    worker process pays the dataset build at most once (and forked
    workers inherit the parent's copy for free)."""
    if kind == "eval":
        # one objective evaluation, dispatched through the objective
        # registry.  Custom objectives register at import time, so the
        # operational ``objective_modules`` context hook lets process /
        # remote workers import their defining modules first.  A unit
        # without an ``objective`` field is an offline-table lookup —
        # the pre-registry content key, preserved bit-for-bit.
        for mod in context.get("objective_modules", ()) or ():
            importlib.import_module(mod)
        spec = get_objective(params.get("objective", "offline"))
        return spec.run(params, context)

    from repro_torch.core.evaluate import run_predictive, run_search
    from repro_torch.multicloud.dataset import build_dataset

    ds = build_dataset(int(context.get("dataset_seed", 0)))
    task = ds.task(params["workload"], params["target"])
    if kind == "search":
        hist = run_search(params["method"], task, ds.domain,
                          int(params["budget"]), int(params["seed"]))
        # the raw evaluation trace is the maximal sufficient statistic:
        # regret curves, best values and savings all derive from it
        return {"values": [float(v) for v in hist.values]}
    if kind == "predictive":
        out = run_predictive(params["method"], task, ds,
                             int(params["seed"]))
        return {"regret": float(out["regret"]),
                "value": float(out["value"]),
                "provider": out["provider"],
                "online_evals": int(out["online_evals"])}
    raise ValueError(f"unknown unit kind {kind!r}")


# ---------------------------------------------------------------------------
# Driver-runner: evaluation-granular execution of suspendable searches
# ---------------------------------------------------------------------------
def eval_unit(workload: str, target: str, provider: str,
              config: dict) -> WorkUnit:
    """Content-keyed unit for one offline-table evaluation.  The key is
    volatile-safe: it hashes only (workload, target, provider, canonical
    config) plus the engine context (dataset seed) — never the method,
    seed, or budget that happened to request it — so every search that
    touches the same point shares one stored record.

    Kept as the offline fast path; other objectives mint units through
    :meth:`repro_torch.core.objectives.ObjectiveBinding.unit`, which emits
    exactly this key shape for ``offline`` bindings.
    """
    return WorkUnit.make("eval", workload=workload, target=target,
                         provider=provider,
                         config=tuple(sorted(config.items())))


#: a drive_units cell: (driver, binding), or the legacy offline triple
#: (driver, workload, target)
DriveCell = Union[Tuple[Any, ObjectiveBinding], Tuple[Any, str, str]]


def _normalize_cells(engine: ExperimentEngine,
                     cells: Sequence[DriveCell]) -> List[Tuple[Any, Any]]:
    """Resolve every cell to (driver, binding).  Legacy
    (driver, workload, target) triples still resolve — to the offline
    objective at the engine's dataset seed — but are deprecated: the
    documented cell form is a (driver, binding) pair.  Each binding's
    required context must agree with the engine's — a mismatched
    dataset seed would silently key units against the wrong table."""
    out = []
    for cell in cells:
        if len(cell) == 3:
            warnings.warn(
                "drive_units (driver, workload, target) triples are "
                "deprecated; pass (driver, binding) pairs — e.g. "
                "bind_objective('offline', workload=w, target=t, "
                "dataset_seed=seed)",
                DeprecationWarning, stacklevel=3)
            drv, w, t = cell
            binding = bind_objective(
                "offline", workload=w, target=t,
                dataset_seed=int(engine.context.get("dataset_seed", 0)))
        else:
            drv, binding = cell
        for k, v in binding.context().items():
            have = engine.context.get(k, v)
            if have != v:
                raise ValueError(
                    f"objective binding {binding.describe()} requires "
                    f"context {k}={v!r} but engine has {k}={have!r}")
        out.append((drv, binding))
    return out


def _request_unit(binding: Any, req: Sequence) -> WorkUnit:
    """Mint the unit for one ask request.  Plain ``(provider, config)``
    requests go through ``binding.unit`` — the historical path, byte-
    identical keys.  Rung-tagged ``(provider, config, rung)`` requests
    (multi-fidelity drivers) need a :class:`~repro_torch.core.fidelity.
    LadderBinding`; tagging a flat binding is a driver/binding wiring
    bug and raises instead of silently evaluating ground truth."""
    if len(req) == 2:
        return binding.unit(req[0], req[1])
    prov, cfg, rung = req
    rung_unit = getattr(binding, "rung_unit", None)
    if rung_unit is None:
        raise TypeError(
            f"driver asked for fidelity rung {rung} but binding "
            f"{binding.describe()} is not a ladder; bind the objective "
            f"family via repro_torch.core.fidelity.bind_ladder")
    return rung_unit(rung, prov, cfg)


def drive_units(engine: ExperimentEngine,
                cells: Sequence[DriveCell], *,
                clock: Any = None, on_failure: str = "raise",
                observer: Any = None, scheduler: str = "pipeline",
                speculate: bool = True) -> List[Any]:
    """Run suspendable search drivers to completion at evaluation
    granularity.

    ``cells`` is a sequence of ``(driver, binding)`` pairs — any
    registered objective bound to concrete parameters, including a
    :class:`~repro_torch.core.fidelity.LadderBinding` for multi-fidelity
    drivers — or legacy ``(driver, workload, target)`` triples, which
    mean the offline table at the engine's dataset seed.  Each
    iteration gathers one ``ask_batch`` from every unfinished driver,
    submits the union as ``eval`` units through the engine — which
    dedups identical requests within the round, replays already-stored
    evaluations, and fans the rest out through its executor backend —
    then tells each driver its results in request order.  Driver state
    machines are deterministic, so histories are bit-identical to the
    inline closed loop regardless of executor, worker count, or store
    warmth.

    Ask requests are ``(provider, config)`` pairs, or ``(provider,
    config, rung)`` triples from fidelity-aware drivers — the rung
    indexes the ladder binding's rungs (0 = cheapest) and selects
    which objective evaluates the point.  Before the first ask, any
    driver exposing ``attach_ladder`` is told its binding's rung count
    (1 for flat bindings), so multi-fidelity drivers fail fast when
    wired to a flat objective.

    ``clock``, if given, is advanced (``clock.advance()``) once after
    every round — the dynamic-market time axis (:class:`repro_torch.
    multicloud.market.MarketClock`): one ask round = one market tick,
    with no search internals involved.

    Failure routing: a worker result carrying a truthy ``failed`` flag
    (the structured failed-result schema — provider outage, instance
    revocation) is *always* told to the driver as an
    :class:`~repro_torch.core.objectives.EvalFailure`; drivers define
    graceful degradation.  An engine-level failure (``None`` result:
    exhausted retry budget) raises by default, or with
    ``on_failure="tell"`` is downgraded to an ``EvalFailure`` tell as
    well — a sweep against a hostile environment completes either way.

    ``observer``, if given, is called as ``observer(cell_index, tick,
    batch, values)`` after each cell's round results are assembled and
    before they are told — the per-round trace hook fig5's dynamic
    regret is computed from.

    ``scheduler`` selects the execution strategy.  ``"pipeline"`` (the
    default) routes through :mod:`repro_torch.exp.sched`: units are packed
    onto executor slots longest-cost-first with cheap probes coalesced
    into in-process lanes, each driver is told (and re-asked) the
    moment its own batch resolves, and — without a clock — idle slots
    prefetch :meth:`~repro_torch.core.drivers.SearchDriver.peek` guesses
    (disable with ``speculate=False``).  Driver histories and store
    fingerprints are bit-identical to ``"barrier"``, the legacy
    round-synchronized loop kept as the reference baseline.

    Returns one :class:`~repro_torch.core.optimizers.base.History` per cell.
    On return ``engine.stats`` holds the totals accumulated over all
    rounds of this call (``engine.lifetime`` accumulates as usual).
    """
    if on_failure not in ("raise", "tell"):
        raise ValueError(
            f"on_failure must be 'raise' or 'tell', got {on_failure!r}")
    if scheduler not in ("pipeline", "barrier"):
        raise ValueError(
            f"scheduler must be 'pipeline' or 'barrier', got {scheduler!r}")
    pairs = _normalize_cells(engine, cells)
    # fidelity handshake: a driver exposing attach_ladder learns the
    # ladder shape before its first ask; against a flat binding it is
    # told n_rungs=1, so it fails loudly instead of silently flat
    for drv, binding in pairs:
        attach = getattr(drv, "attach_ladder", None)
        if attach is not None:
            attach(getattr(binding, "n_rungs", 1))
    if scheduler == "pipeline":
        # lazy: sched imports back from this module
        from repro_torch.exp.sched import PipelinedDriveSession
        return PipelinedDriveSession(
            engine, pairs, clock=clock, on_failure=on_failure,
            observer=observer, speculate=speculate).run()
    return _drive_barrier(engine, pairs, clock=clock,
                          on_failure=on_failure, observer=observer)


def _drive_barrier(engine: ExperimentEngine,
                   pairs: Sequence[Tuple[Any, Any]], *,
                   clock: Any = None, on_failure: str = "raise",
                   observer: Any = None) -> List[Any]:
    """The legacy round-synchronized loop: every active driver asks,
    the union runs as one barrier, every driver is told.  Kept as the
    reference baseline the pipelined scheduler must stay bit-identical
    to (benchmarks and CI diff against it)."""
    # lazy: keeps `import repro_torch.exp` light for workers/CLI processes
    from repro_torch.core.objectives import EvalFailure
    agg = EngineStats()
    pending: Dict[int, list] = {}
    active = [i for i, (drv, _b) in enumerate(pairs) if not drv.done]
    round_idx = 0
    while active:
        units: List[WorkUnit] = []
        for i in active:
            drv, binding = pairs[i]
            batch = drv.ask_batch()
            pending[i] = batch
            units.extend(_request_unit(binding, req) for req in batch)
        results = engine.run(units)
        agg.absorb(engine.stats)
        pos = 0
        still_active = []
        for i in active:
            drv, binding = pairs[i]
            batch = pending.pop(i)
            values = []
            for req in batch:
                prov = req[0]
                res = results[pos]
                pos += 1
                if res is None:
                    if on_failure == "raise":
                        raise RuntimeError(
                            f"eval unit failed for {binding.describe()}"
                            f"/{prov}: "
                            + "; ".join(engine.stats.errors[:3]))
                    values.append(EvalFailure(
                        reason=engine.stats.errors[-1]
                        if engine.stats.errors else "engine failure"))
                elif res.get("failed"):
                    values.append(EvalFailure(
                        reason=str(res.get("reason", "failed"))))
                else:
                    values.append(res["value"])
            if observer is not None:
                tick = clock.tick if clock is not None else round_idx
                observer(i, tick, batch, values)
            drv.tell_batch(values)
            if not drv.done:
                still_active.append(i)
        active = still_active
        if clock is not None:
            clock.advance()
        round_idx += 1
    engine.stats = agg
    return [drv.history for drv, _b in pairs]


def subprocess_timeout(context: Dict[str, Any],
                       default: float = 3600.0) -> float:
    """Wall-clock budget for a subprocess-spawning runner.

    The engine injects its ``unit_timeout_s`` config into every runner's
    context, so the CLI ``--timeout`` reaches subprocess runners through
    one path; the legacy ``context["timeout"]`` key is honored for old
    callers that set it directly.  Runners enforce this tightly
    themselves (a subprocess kill beats the engine watchdog's grace
    window and produces a richer error).
    """
    timeout = context.get("unit_timeout_s")
    if timeout is None:
        timeout = context.get("timeout", default)
    return float(timeout)


# ---------------------------------------------------------------------------
# Dry-run sweep units (one XLA compile cell per unit, via subprocess —
# each cell needs the 512-device XLA flag set before jax imports)
# ---------------------------------------------------------------------------
def dryrun_runner(kind: str, params: Dict[str, Any],
                  context: Dict[str, Any]) -> dict:
    if kind != "dryrun":
        raise ValueError(kind)
    arch, shape, mesh = params["arch"], params["shape"], params["mesh"]
    out_dir = context["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}.{shape}.{mesh}"
    out = os.path.join(out_dir, tag + ".json")
    err = os.path.join(out_dir, tag + ".err")
    if params.get("skip_reason"):
        rec = {"arch": arch, "shape": shape, "mesh": mesh,
               "skipped": params["skip_reason"]}
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)
        return rec
    # adopt cells completed before the engine store existed (legacy
    # sweeps): a valid per-cell JSON is the result, no recompute
    if os.path.exists(out):
        try:
            with open(out) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError):
            pass                        # corrupt/partial — re-run the cell
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if mesh == "multipod":
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env["PYTHONPATH"] = context.get("src_path", "src")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=subprocess_timeout(context),
                           env=env)
    except subprocess.TimeoutExpired:
        with open(err, "w") as f:
            f.write("TIMEOUT")
        raise RuntimeError(f"{tag}: timeout")
    if r.returncode != 0:
        with open(err, "w") as f:
            f.write(r.stdout[-4000:] + "\n--- stderr ---\n"
                    + r.stderr[-8000:])
        raise RuntimeError(f"{tag}: exit {r.returncode} (see {err})")
    if os.path.exists(err):
        os.remove(err)
    with open(out) as f:
        return json.load(f)
