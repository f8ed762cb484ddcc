"""Cost-aware pipelined scheduler with speculative ask-ahead.

:func:`repro_torch.exp.runners.drive_units` historically ran every ask round
as a synchronous barrier: gather one batch from every driver, push the
union through ``engine.run``, tell everyone, repeat.  Since objectives
grew fidelity ladders, one round legally mixes ~free analytic probes
with minutes-long ground-truth measurements — and the barrier idles the
whole fleet on the slowest unit.  This module replaces the barrier with
a pipelined dispatcher while keeping the *observable* behaviour frozen:

bit-identity contract
    Every driver receives exactly the tells it would have received from
    the barrier loop, in exactly the same order — driver histories are
    bit-identical.  Stores end bit-identical too (equal
    :meth:`~repro_torch.exp.store.BaseResultStore.fingerprint`): speculative
    results are parked in an in-memory staging cache and only promoted
    into the store when a real ask requests that exact content key, so
    a wrong guess never leaves a stored trace.

cost-aware packing
    Each unit gets a cost estimate from its objective's declared
    ``cost_class`` hint (:class:`~repro_torch.core.objectives.ObjectiveSpec.
    cost_class`; a fidelity rung is already a cost class because every
    rung is its own objective), refined by an EWMA over observed and
    stored unit timings for objectives without a hint.  Ready units are
    submitted longest-cost-first (LPT packing onto executor slots), and
    runs of cheap probe units are coalesced into a single in-process
    *lane* future — one slot executes the whole run instead of paying
    per-future dispatch overhead per ~ms probe — while expensive units
    own their slot.

pipelining
    Without a shared clock, cells are mutually independent: a driver is
    told its batch the moment its own units are resolved and asked
    again immediately — no cell ever waits on another cell's slow unit.
    With a ``clock`` (dynamic-market runs), rounds stay globally
    synchronized — the tick is part of every content key — so dispatch
    within the round is cost-aware but tells happen at the round
    boundary in cell order, exactly like the barrier (and speculation
    is disabled: a prefetched key would carry the wrong tick).

speculative ask-ahead
    While a batch is in flight, :meth:`~repro_torch.core.drivers.SearchDriver.
    peek` guesses the driver's probable next requests and idle executor
    slots prefetch them.  Guesses never displace real work (dispatched
    only into idle capacity, after the real queue), never produce tells
    (a failed speculative attempt is silently discarded — it can never
    surface as a spurious ``EvalFailure``), and never touch the store
    until adopted by a real ask.  ``EngineStats`` reports
    ``speculated`` / ``spec_hits`` / ``spec_wasted``.

Known, accepted divergences from the barrier loop (none observable in
histories, store fingerprints, or warm-replay ``computed`` counts):
``unique``/``cached`` counters aggregate per ask batch rather than per
global round, retry attempt budgets are tracked per drive call rather
than per round, and ``errors`` ordering follows completion order.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.objectives import (
    DEFAULT_OBJECTIVE, EvalFailure, get_objective)
from repro_torch.exp.engine import EngineStats, ExperimentEngine, WorkUnit, _invoke
from repro_torch.exp.wire import RemoteTaskError

# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------
#: nominal seconds per declared cost class — the prior before any
#: timing is observed; EWMA overrides as soon as real timings exist
NOMINAL_COST_S: Dict[str, float] = {
    "table": 0.002,          # offline-table lookups (and the market view)
    "analytic": 0.005,       # roofline / traffic-model estimates
    "measure": 5.0,          # timed kernel runs
    "compile": 30.0,         # XLA compile + roofline scoring
    "subprocess": 600.0,     # full dryrun subprocess cells
}

#: prior for objectives with neither a cost_class nor observed timings
DEFAULT_NOMINAL_S = 1.0

#: estimated cost at or below which a unit counts as a cheap probe and
#: may be coalesced into an in-process lane
CHEAP_THRESHOLD_S = 0.05

#: cap on units per coalesced lane: a lane must comfortably finish
#: inside one *unit* timeout (the remote backend's hard deadline is
#: armed per task, and a lane is one task)
LANE_MAX = 16

#: EWMA smoothing for observed unit timings
_EWMA_ALPHA = 0.3


def cost_key(params: Dict[str, Any]) -> str:
    """The cost-class key for one eval unit's params: the objective's
    declared ``cost_class`` when it has one, else the objective name
    itself (each fidelity rung is its own objective, so a rung index is
    already a cost class), suffixed with the ``fidelity`` field for
    unregistered objectives where the name alone can't separate rungs.
    """
    name = str(params.get("objective", DEFAULT_OBJECTIVE))
    try:
        spec = get_objective(name)
    except KeyError:
        spec = None
    if spec is not None and spec.cost_class:
        return spec.cost_class
    fid = params.get("fidelity")
    return f"{name}@r{fid}" if fid is not None else name


class CostModel:
    """Per-cost-class runtime estimates: nominal priors from declared
    ``cost_class`` hints, refined by an EWMA over stored and observed
    unit timings (the measured fallback for flat objectives that
    declare nothing)."""

    def __init__(self, store: Any = None):
        self._ewma: Dict[str, float] = {}
        if store is not None:
            self.seed_from_store(store)

    def seed_from_store(self, store: Any) -> None:
        """Warm the model from stored unit timings — the same records
        ``python -m repro_torch.exp stat`` aggregates."""
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        try:
            records = store.records()
        except Exception:       # noqa: BLE001 — cost priors are optional
            return
        for rec in records:
            if rec.get("kind") != "eval":
                continue
            k = cost_key(rec.get("params") or {})
            sums[k] = sums.get(k, 0.0) + float(rec.get("elapsed_s", 0.0))
            counts[k] = counts.get(k, 0) + 1
        for k, n in counts.items():
            self._ewma.setdefault(k, sums[k] / n)

    def observe(self, unit: WorkUnit, elapsed_s: float) -> None:
        k = cost_key(unit.as_dict())
        prev = self._ewma.get(k)
        self._ewma[k] = float(elapsed_s) if prev is None else \
            _EWMA_ALPHA * float(elapsed_s) + (1.0 - _EWMA_ALPHA) * prev

    def estimate(self, unit: WorkUnit) -> float:
        params = unit.as_dict()
        k = cost_key(params)
        if k in self._ewma:
            return self._ewma[k]
        return NOMINAL_COST_S.get(k, DEFAULT_NOMINAL_S)

    def is_cheap(self, unit: WorkUnit) -> bool:
        return self.estimate(unit) <= CHEAP_THRESHOLD_S


# ---------------------------------------------------------------------------
# Coalesced cheap-probe lanes
# ---------------------------------------------------------------------------
def _lane_job(runner: Any, tasks: Sequence[Sequence[Any]],
              context: Dict[str, Any], timeout: Optional[float],
              grace: float) -> List[dict]:
    """Execute a run of cheap units as ONE executor task.

    ``tasks`` is ``[(kind, params), ...]`` (JSON-serializable, so the
    lane travels over the remote wire like any unit).  Each member runs
    through :func:`repro_torch.exp.engine._invoke` with the per-unit timeout;
    a member's failure is captured as a structured outcome so one bad
    probe never poisons its lane-mates.  Module-level and
    primitives-only by design — picklable for the process pool,
    wire-refable for the remote backend.
    """
    out: List[dict] = []
    for task in tasks:
        kind, params = task[0], task[1]
        try:
            result, dt = _invoke(runner, kind, params, context,
                                 timeout, grace)
            out.append({"ok": True, "result": result,
                        "elapsed_s": float(dt)})
        except BaseException as exc:    # noqa: BLE001 — per-unit outcome
            out.append({"ok": False, "error_type": type(exc).__name__,
                        "error": str(exc)})
    return out


def executor_slots(ex: Any) -> int:
    """Usable parallel slots of an executor backend — the capacity the
    LPT packing and the speculation budget are sized against."""
    try:
        return max(1, int(ex.slots))
    except (AttributeError, TypeError, ValueError):
        return max(1, int(getattr(ex, "workers", 1) or 1))


# ---------------------------------------------------------------------------
# The pipelined drive session
# ---------------------------------------------------------------------------
_UNSET = object()


class _Cell:
    """One (driver, binding) cell's in-flight state."""

    __slots__ = ("index", "drv", "binding", "batch", "results",
                 "unresolved", "round_idx", "peeked")

    def __init__(self, index: int, drv: Any, binding: Any):
        self.index = index
        self.drv = drv
        self.binding = binding
        self.batch: Optional[list] = None
        self.results: List[Any] = []
        self.unresolved = 0
        self.round_idx = 0
        self.peeked = False


class _Inflight:
    """One distinct content key currently queued or executing."""

    __slots__ = ("key", "unit", "speculative", "was_spec", "attempts",
                 "waiters")

    def __init__(self, key: str, unit: WorkUnit, speculative: bool):
        self.key = key
        self.unit = unit
        self.speculative = speculative
        self.was_spec = speculative
        self.attempts = 0
        #: (cell, slot index) pairs awaiting this key's result
        self.waiters: List[Tuple[_Cell, int]] = []


class PipelinedDriveSession:
    """One ``drive_units`` call executed through the cost-aware
    pipelined dispatcher.  See the module docstring for the contract;
    construction wires the session to the engine's store, executor and
    retry budget, :meth:`run` drives every cell to completion."""

    def __init__(self, engine: ExperimentEngine,
                 pairs: Sequence[Tuple[Any, Any]], *,
                 clock: Any = None, on_failure: str = "raise",
                 observer: Any = None, speculate: bool = True):
        self.engine = engine
        self.clock = clock
        self.on_failure = on_failure
        self.observer = observer
        # a prefetched key would carry the wrong market tick, so
        # speculation is structurally off under a clock
        self.speculate = bool(speculate) and clock is None
        self.cost = CostModel(engine.store)
        self.cells = [_Cell(i, drv, binding)
                      for i, (drv, binding) in enumerate(pairs)]
        self.stats = EngineStats()
        self._inflight: Dict[str, _Inflight] = {}
        #: speculative results awaiting adoption: key -> (result dict,
        #: elapsed_s, attempts).  Never written to the store unless a
        #: real ask arrives for the key.
        self._staged: Dict[str, Tuple[dict, float, int]] = {}
        self._submit_q: List[str] = []      # real keys awaiting dispatch
        self._spec_q: List[str] = []        # speculative keys, idle-only
        #: future -> ("unit", key) | ("lane", [keys])
        self._futures: Dict[Any, Tuple[str, Any]] = {}
        self._ex: Any = None
        self._slots = 1
        self._speculated = 0
        self._spec_hits = 0

    # -- top level ------------------------------------------------------
    def run(self) -> List[Any]:
        t0 = time.time()
        eng = self.engine
        eng.stats = self.stats          # _record/_fail mutate in place
        self._ex, ephemeral = eng._resolve_executor()
        self._slots = executor_slots(self._ex)
        try:
            if self.clock is None:
                self._run_pipelined()
            else:
                self._run_rounds()
        finally:
            if ephemeral:
                self._ex.shutdown()
            self._ex = None
        self.stats.speculated = self._speculated
        self.stats.spec_hits = self._spec_hits
        self.stats.spec_wasted = self._speculated - self._spec_hits
        self.stats.elapsed_s = time.time() - t0
        eng.lifetime.absorb(self.stats)
        return [c.drv.history for c in self.cells]

    # -- fully pipelined (no clock): cells never wait on each other ----
    def _run_pipelined(self) -> None:
        active = [c for c in self.cells if not c.drv.done]
        for cell in active:
            self._ask(cell)
        active = self._flush_ready(active)
        while active:
            self._dispatch()
            self._speculate(active)
            if not self._futures:
                if self._submit_q:
                    continue            # a failed submit queued retries
                raise RuntimeError(
                    "pipelined scheduler stalled: unresolved batches "
                    "with nothing queued or in flight")
            self._on_complete(self._wait_one())
            active = self._flush_ready(active)

    def _flush_ready(self, active: List[_Cell]) -> List[_Cell]:
        """Tell every cell whose batch is fully resolved and re-ask it
        immediately; loop until no cell can advance (a re-ask may
        itself resolve instantly from the store)."""
        progress = True
        while progress:
            progress = False
            for cell in list(active):
                if cell.batch is None or cell.unresolved:
                    continue
                self._deliver(cell)
                if cell.drv.done:
                    active.remove(cell)
                else:
                    self._ask(cell)
                progress = True
        return active

    # -- round-synchronized (clock): barrier tells, pipelined dispatch -
    def _run_rounds(self) -> None:
        active = [c for c in self.cells if not c.drv.done]
        while active:
            for cell in active:
                self._ask(cell)
            while any(c.unresolved for c in active):
                self._dispatch()
                if not self._futures:
                    if self._submit_q:
                        continue
                    raise RuntimeError(
                        "pipelined scheduler stalled mid-round")
                self._on_complete(self._wait_one())
            # tells at the round boundary, in cell order — exactly the
            # barrier loop's sequence (observer order included)
            for cell in active:
                self._deliver(cell)
            self.clock.advance()
            active = [c for c in active if not c.drv.done]

    # -- ask / resolve --------------------------------------------------
    def _ask(self, cell: _Cell) -> None:
        from repro_torch.exp.runners import _request_unit
        batch = cell.drv.ask_batch()
        cell.batch = batch
        cell.results = [_UNSET] * len(batch)
        cell.unresolved = len(batch)
        cell.peeked = False
        self.stats.total += len(batch)
        distinct: Dict[str, List[int]] = {}
        units: Dict[str, WorkUnit] = {}
        for i, req in enumerate(batch):
            unit = _request_unit(cell.binding, req)
            key = self.engine.key_for(unit)
            distinct.setdefault(key, []).append(i)
            units[key] = unit
        self.stats.unique += len(distinct)
        for key, slots in distinct.items():
            rec = self.engine.store.get(key)
            if rec is not None:
                self.stats.cached += 1
                self.stats.unit_elapsed_s += float(rec.get("elapsed_s", 0.0))
                self._resolve(cell, slots, rec["result"])
                continue
            if key in self._staged:
                # a speculative guess landed before the real ask: adopt
                # it — promote the staged result into the store exactly
                # as if it had just been computed
                result, dt, attempts = self._staged.pop(key)
                self.engine._record(key, units[key], result, dt, attempts)
                self.cost.observe(units[key], dt)
                self._spec_hits += 1
                self.stats.unit_elapsed_s += dt
                self._resolve(cell, slots, result)
                continue
            ent = self._inflight.get(key)
            if ent is not None:
                # coalesce onto the in-flight computation (another
                # cell's request, or a speculative prefetch — adopted:
                # from here on it is real work with a fresh retry
                # budget, and its result will be stored)
                if ent.speculative:
                    ent.speculative = False
                    ent.attempts = 0
                    if key in self._spec_q:
                        # not yet dispatched: promote to real work — it
                        # never ran speculatively, so it counts neither
                        # as speculated nor (via was_spec) as a hit
                        self._spec_q.remove(key)
                        self._submit_q.append(key)
                        ent.was_spec = False
                ent.waiters.extend((cell, i) for i in slots)
                continue
            ent = _Inflight(key, units[key], speculative=False)
            ent.waiters.extend((cell, i) for i in slots)
            self._inflight[key] = ent
            self._submit_q.append(key)

    def _resolve(self, cell: _Cell, slots: Sequence[int],
                 result: Optional[dict]) -> None:
        for i in slots:
            if cell.results[i] is _UNSET:
                cell.results[i] = result
                cell.unresolved -= 1

    # -- deliver --------------------------------------------------------
    def _deliver(self, cell: _Cell) -> None:
        """Assemble the batch's values (the barrier loop's exact
        failure routing) and tell the driver."""
        batch, cell.batch = cell.batch, None
        values: List[Any] = []
        for req, res in zip(batch, cell.results):
            if res is None:
                if self.on_failure == "raise":
                    raise RuntimeError(
                        f"eval unit failed for "
                        f"{cell.binding.describe()}/{req[0]}: "
                        + "; ".join(self.stats.errors[:3]))
                values.append(EvalFailure(
                    reason=self.stats.errors[-1]
                    if self.stats.errors else "engine failure"))
            elif res.get("failed"):
                values.append(EvalFailure(
                    reason=str(res.get("reason", "failed"))))
            else:
                values.append(res["value"])
        if self.observer is not None:
            tick = self.clock.tick if self.clock is not None \
                else cell.round_idx
            self.observer(cell.index, tick, batch, values)
        cell.drv.tell_batch(values)
        cell.round_idx += 1
        cell.results = []

    # -- dispatch -------------------------------------------------------
    def _dispatch(self) -> None:
        """Submit everything ready: real units longest-cost-first, runs
        of cheap probes coalesced into lanes, then speculative guesses
        into whatever capacity is left idle."""
        if self._submit_q:
            keys, self._submit_q = self._submit_q, []
            cheap = [k for k in keys
                     if self.cost.is_cheap(self._inflight[k].unit)]
            costly = [k for k in keys if k not in set(cheap)]
            items: List[Tuple[float, str, Any]] = [
                (self.cost.estimate(self._inflight[k].unit), "unit", k)
                for k in costly]
            if len(cheap) == 1:
                items.append((self.cost.estimate(
                    self._inflight[cheap[0]].unit), "unit", cheap[0]))
            else:
                for i in range(0, len(cheap), LANE_MAX):
                    lane = cheap[i:i + LANE_MAX]
                    items.append((sum(self.cost.estimate(
                        self._inflight[k].unit) for k in lane),
                        "lane", lane))
            # LPT: longest first — FIFO backends start them first, so
            # the expensive tail overlaps everything else
            items.sort(key=lambda t: -t[0])
            for _cost, kind, payload in items:
                self._submit(kind, payload)
        # speculation never displaces real work: only into idle slots,
        # only once the real queue is drained
        while self._spec_q and len(self._futures) < self._slots:
            key = self._spec_q.pop(0)
            ent = self._inflight.get(key)
            if ent is None or not ent.speculative:
                continue                # dropped or adopted while queued
            self._speculated += 1
            self._submit("unit", key)

    def _submit(self, kind: str, payload: Any) -> None:
        eng = self.engine
        ctx = eng._runner_context
        try:
            if kind == "unit":
                ent = self._inflight[payload]
                fut = self._ex.submit(
                    _invoke, eng.runner, ent.unit.kind, ent.unit.as_dict(),
                    ctx, eng.unit_timeout_s, eng.timeout_grace_s)
            else:
                tasks = [(self._inflight[k].unit.kind,
                          self._inflight[k].unit.as_dict())
                         for k in payload]
                fut = self._ex.submit(
                    _lane_job, eng.runner, tasks, ctx,
                    eng.unit_timeout_s, eng.timeout_grace_s)
        except Exception as exc:        # noqa: BLE001 — broken backend
            keys = [payload] if kind == "unit" else list(payload)
            for k in keys:
                ent = self._inflight.get(k)
                if ent is not None:
                    self._unit_error(ent, exc)
            return
        self._futures[fut] = (kind, payload)

    def _wait_one(self) -> Any:
        """Block until one of *our* futures completes — scoped so a
        shared executor's other clients keep their own completions.
        Works on the lazy serial backend too: iterating its
        ``as_completed`` is what executes the queued unit."""
        gen = self._ex.as_completed(list(self._futures))
        try:
            return next(gen)
        except StopIteration:
            raise RuntimeError("executor yielded no completion for "
                               "outstanding futures") from None
        finally:
            gen.close()

    # -- completion -----------------------------------------------------
    def _on_complete(self, fut: Any) -> None:
        kind, payload = self._futures.pop(fut)
        if kind == "unit":
            ent = self._inflight.get(payload)
            if ent is None:
                return
            try:
                result, dt = fut.result()
            except Exception as exc:    # noqa: BLE001 — per-unit failure
                self._unit_error(ent, exc)
            else:
                self._unit_done(ent, result, float(dt))
            return
        # lane: one future carrying per-unit outcomes
        try:
            outcomes = fut.result()
        except Exception as exc:        # noqa: BLE001 — whole lane died
            for k in payload:
                ent = self._inflight.get(k)
                if ent is not None:
                    self._unit_error(ent, exc)
            return
        for k, out in zip(payload, outcomes):
            ent = self._inflight.get(k)
            if ent is None:
                continue
            if out.get("ok"):
                self._unit_done(ent, out["result"],
                                float(out.get("elapsed_s", 0.0)))
            else:
                self._unit_error(ent, RemoteTaskError(
                    str(out.get("error_type", "Error")),
                    str(out.get("error", ""))))

    def _unit_done(self, ent: _Inflight, result: dict, dt: float) -> None:
        self.cost.observe(ent.unit, dt)
        if ent.speculative:
            # park for adoption; never stored, never told — discarded
            # unused at session end (spec_wasted)
            self._staged[ent.key] = (result, dt, ent.attempts + 1)
            del self._inflight[ent.key]
            return
        ent.attempts += 1
        self.engine._record(ent.key, ent.unit, result, dt, ent.attempts)
        if ent.was_spec:
            self._spec_hits += 1
        self.stats.unit_elapsed_s += dt
        for cell, i in ent.waiters:
            self._resolve(cell, [i], result)
        del self._inflight[ent.key]

    def _unit_error(self, ent: _Inflight, exc: BaseException) -> None:
        ent.attempts += 1
        if ent.speculative:
            # a failed guess is silently discarded: no retry (it was
            # free work), no stats.failures entry, and — critically —
            # no EvalFailure tell can ever originate from it
            del self._inflight[ent.key]
            return
        if ent.attempts <= self.engine.retries:
            self.stats.retried += 1
            if self.engine.verbose:
                print(f"[exp] RETRY ({ent.attempts}/{self.engine.retries})"
                      f" {ent.unit.kind}{ent.unit.as_dict()}: "
                      f"{type(exc).__name__}: {exc}",
                      file=sys.stderr, flush=True)
            self._submit_q.append(ent.key)
            return
        self.engine._fail(ent.unit, exc, ent.attempts)
        for cell, i in ent.waiters:
            self._resolve(cell, [i], None)
        del self._inflight[ent.key]

    # -- speculation ----------------------------------------------------
    def _speculate(self, active: Sequence[_Cell]) -> None:
        """Queue peek() guesses from cells with a batch in flight; the
        dispatcher only submits them into idle capacity."""
        if not self.speculate:
            return
        if len(self._futures) >= self._slots:
            return                      # no idle slot to fill anyway
        from repro_torch.exp.runners import _request_unit
        for cell in active:
            if cell.batch is None or cell.peeked or not cell.unresolved:
                continue
            cell.peeked = True
            try:
                guesses = cell.drv.peek()
            except Exception:           # noqa: BLE001 — guesses are free
                continue
            for req in guesses or ():
                try:
                    unit = _request_unit(cell.binding, req)
                except Exception:       # noqa: BLE001 — bad guess shape
                    continue
                key = self.engine.key_for(unit)
                if (key in self.engine.store or key in self._staged
                        or key in self._inflight):
                    continue
                self._inflight[key] = _Inflight(key, unit, speculative=True)
                self._spec_q.append(key)
