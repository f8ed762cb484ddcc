"""Parallel, cached, resumable experiment engine.

The paper's evaluation protocol is embarrassingly parallel: every
(method, workload, target, seed, budget) cell is an independent
table-lookup search.  The engine decomposes a protocol into such
:class:`WorkUnit`\\ s, replays the ones already in the result store,
fans the missing ones out through a pluggable
:class:`~repro_torch.exp.executors.BaseExecutor` backend (serial, thread
pool, process pool, or any remote/batch backend implementing the same
``submit``/``as_completed``/``shutdown`` contract), and persists each
result as it completes — so crashes resume where they stopped and a
second invocation recomputes nothing.

Determinism: a unit's outcome depends only on (kind, params, context) —
each unit carries its own seed and runners derive all randomness from it
— so every executor backend at any worker count produces semantically
identical stores (equal :meth:`~repro_torch.exp.store.BaseResultStore.fingerprint`)
and byte-identical aggregations, because aggregation order is fixed by
the submitted unit list, never by completion order.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import (
    Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple)

from repro_torch.exp.executors import (
    BaseExecutor, ExecutorSpec, make_executor)
from repro_torch.exp.store import BaseResultStore, ResultStore, unit_key
from repro_torch.exp.wire import UnitTimeout

#: runner signature: (kind, params, context) -> JSON-serializable dict
Runner = Callable[[str, Dict[str, Any], Dict[str, Any]], dict]


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """One independent experiment cell.

    ``params`` is stored as a sorted (name, value) tuple so units are
    hashable (deduplicatable) and canonical for content hashing.
    """
    kind: str
    params: Tuple[Tuple[str, Any], ...]

    @classmethod
    def make(cls, kind: str, **params: Any) -> "WorkUnit":
        return cls(kind, tuple(sorted(params.items())))

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.params)


@dataclasses.dataclass
class EngineStats:
    total: int = 0          # slots requested (incl. duplicates)
    unique: int = 0         # distinct units after dedup
    cached: int = 0         # unique units replayed from the store
    computed: int = 0       # unique units actually executed
    failed: int = 0         # unique units whose budget was exhausted
    retried: int = 0        # retry attempts spent (beyond first tries)
    #: speculative ask-ahead counters (repro_torch.exp.sched): prefetches
    #: dispatched, prefetched results a later real ask actually used,
    #: and prefetches discarded unused (wrong guesses + failed attempts)
    speculated: int = 0
    spec_hits: int = 0
    spec_wasted: int = 0
    elapsed_s: float = 0.0  # wall time of this run() call
    #: sum of per-unit compute time as recorded when each unit was first
    #: executed — stable across store replays (unlike wall time)
    unit_elapsed_s: float = 0.0
    errors: List[str] = dataclasses.field(default_factory=list)
    #: one structured entry per budget-exhausted unit:
    #: {kind, params, attempts, error_type, error} — the machine-readable
    #: face of ``errors``, surfaced instead of raising mid-sweep
    failures: List[dict] = dataclasses.field(default_factory=list)

    def absorb(self, other: "EngineStats") -> None:
        """Accumulate another run's counters (engine lifetime totals).
        Field-driven so a future field cannot silently vanish from
        lifetime aggregation by being forgotten here."""
        for f in dataclasses.fields(self):
            cur = getattr(self, f.name)
            if isinstance(cur, list):
                cur.extend(getattr(other, f.name))
            else:
                setattr(self, f.name, cur + getattr(other, f.name))


def _invoke(runner: Runner, kind: str, params: Dict[str, Any],
            context: Dict[str, Any], timeout: Optional[float] = None,
            grace: float = 0.0) -> Tuple[dict, float]:
    """Top-level trampoline so a process pool only pickles primitives +
    a module-level runner reference (and the remote backend ships plain
    JSON + a callable ref).

    ``timeout`` arms an in-task watchdog: the runner executes on a
    daemon thread joined for ``timeout + grace`` seconds, after which
    :class:`~repro_torch.exp.wire.UnitTimeout` is raised.  The grace window
    lets runners that enforce the same budget themselves (e.g. a
    subprocess kill at exactly ``timeout``) fail first with their own,
    richer error.  A truly stuck runner leaks its daemon thread — which
    is precisely why hostile/hanging workloads belong on the ``remote``
    backend, where the controller additionally hard-kills the worker
    process.
    """
    t0 = time.time()
    if not timeout:
        return runner(kind, params, context), time.time() - t0
    box: Dict[str, Any] = {}

    def _call() -> None:
        try:
            box["result"] = runner(kind, params, context)
        except BaseException as exc:    # noqa: BLE001 — re-raised below
            box["exc"] = exc

    th = threading.Thread(target=_call, daemon=True, name="exp-unit-watchdog")
    th.start()
    th.join(float(timeout) + float(grace))
    if th.is_alive():
        raise UnitTimeout(
            f"unit exceeded {timeout}s wall clock: {kind}{params}")
    if "exc" in box:
        raise box["exc"]
    return box["result"], time.time() - t0


class ExperimentEngine:
    """Run work units through a runner with caching and parallelism.

    runner   : module-level callable ``(kind, params, context) -> dict``
               (must be picklable by reference for the process backend)
    context  : code-relevant parameters folded into every unit's content
               hash (e.g. ``{"dataset_seed": 0}``)
    local_context : operational parameters the runner needs but which must
               NOT affect identity — output dirs, timeouts, machine paths.
               Merged into the context passed to runners, excluded from
               the hash (so a re-run with a different ``--timeout`` or
               from another checkout still replays the store).
    store    : any :class:`~repro_torch.exp.store.BaseResultStore` (single-file
               or sharded); in-memory if omitted
    executor : backend spec — ``"serial"`` / ``"thread"`` / ``"process"``
               / ``"remote"``, a
               :class:`~repro_torch.exp.executors.BaseExecutor` instance, or
               ``None`` to pick from ``workers`` (serial at ``<= 1``, a
               process pool above — the historical behavior).  Named
               specs are instantiated fresh per :meth:`run` and shut
               down after it, except backends that declare themselves
               ``persistent`` (``remote`` — worker spawn is expensive):
               those are built once, kept for the engine's lifetime, and
               released by :meth:`close` (or the context manager / GC).
               Injected instances are caller-owned and left running.
    workers  : backend width (ignored by ``serial``)
    mp_context : multiprocessing start method for the process backend
               (default fork; also settable via ``REPRO_EXP_MP``)
    executor_kwargs : extra backend constructor arguments (e.g.
               ``hosts="local*2,ssh:gpu1*8"`` for ``remote``)
    unit_timeout_s : per-unit wall-clock budget.  Enforced in-task by a
               watchdog thread on every backend (plus a hard
               worker-kill deadline on ``remote``), and surfaced to
               runners as ``context["unit_timeout_s"]`` so
               subprocess-spawning runners can enforce it tightly
               themselves.  Operational, not identity: excluded from
               content hashes, so changing ``--timeout`` never
               invalidates a store.
    retries  : extra attempts per unit after the first failure
               (timeout or exception).  A unit that exhausts
               ``1 + retries`` attempts becomes a structured entry in
               ``stats.failures`` — never an exception mid-sweep.  The
               attempt count that produced each stored result is
               recorded on the record (volatile field, excluded from
               fingerprints and content hashes).  Caveat for in-process
               backends (serial/thread/process): a timed-out attempt is
               abandoned, not stopped, so its leaked thread may still be
               running while the retry executes — side-effecting runners
               that hang (rather than raise) belong on the ``remote``
               backend, whose workers are killed outright.
    timeout_grace_s : how long the in-task watchdog waits beyond
               ``unit_timeout_s`` before declaring the timeout itself
               (gives self-enforcing runners first claim on the error).
    """

    def __init__(self, runner: Runner,
                 context: Optional[Mapping[str, Any]] = None,
                 store: Optional[BaseResultStore] = None, workers: int = 1,
                 mp_context: Optional[str] = None,
                 executor: ExecutorSpec = None,
                 executor_kwargs: Optional[Mapping[str, Any]] = None,
                 local_context: Optional[Mapping[str, Any]] = None,
                 unit_timeout_s: Optional[float] = None, retries: int = 0,
                 timeout_grace_s: float = 5.0,
                 verbose: bool = False):
        self.runner = runner
        self.context = dict(context or {})
        self.local_context = dict(local_context or {})
        self.store = store if store is not None else ResultStore()
        self.workers = int(workers)
        self.mp_context = mp_context
        self.executor = executor
        self.executor_kwargs = dict(executor_kwargs or {})
        self.unit_timeout_s = unit_timeout_s
        self.retries = max(0, int(retries))
        self.timeout_grace_s = float(timeout_grace_s)
        self.verbose = verbose
        self.stats = EngineStats()
        #: cumulative stats across every run() of this engine (what the
        #: benchmark drivers report; per-run stats reset each call)
        self.lifetime = EngineStats()
        self._cached_executor: Optional[BaseExecutor] = None

    # ------------------------------------------------------------------
    def key_for(self, unit: WorkUnit) -> str:
        return unit_key(unit.kind, unit.as_dict(), self.context)

    @property
    def _runner_context(self) -> Dict[str, Any]:
        ctx = {**self.context, **self.local_context}
        if self.unit_timeout_s is not None:
            # operational, never part of the identity hash (which uses
            # self.context only): lets subprocess runners enforce the
            # budget tightly inside the watchdog's grace window
            ctx.setdefault("unit_timeout_s", self.unit_timeout_s)
        return ctx

    # -- executor lifecycle --------------------------------------------
    def _resolve_executor(self) -> Tuple[BaseExecutor, bool]:
        """Returns (executor, ephemeral): ephemeral executors are owned
        by the current run and shut down when it ends.

        Only engine-owned executors are configured with the engine's
        ``unit_timeout_s``.  A caller-injected instance is never mutated
        — it may be shared by several engines with different budgets, or
        carry its own deliberate configuration; the engine's in-task
        watchdog still enforces this engine's budget on every unit it
        submits, the injected backend's hard deadline follows the
        instance's own setting."""
        if isinstance(self.executor, BaseExecutor):
            return self.executor, False
        if self._cached_executor is not None:
            ex = self._cached_executor
        else:
            ex = make_executor(self.executor, workers=self.workers,
                               mp_context=self.mp_context,
                               **self.executor_kwargs)
            if getattr(ex, "persistent", False):
                self._cached_executor = ex
            else:
                ex.unit_timeout_s = self.unit_timeout_s
                return ex, True
        ex.unit_timeout_s = self.unit_timeout_s
        return ex, False

    def close(self) -> None:
        """Release a persistent engine-owned executor (remote workers).
        Idempotent; caller-injected executors are never touched."""
        ex, self._cached_executor = self._cached_executor, None
        if ex is not None:
            ex.shutdown()

    def __enter__(self) -> "ExperimentEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:          # pragma: no cover — GC backstop
        try:
            self.close()
        except Exception:               # noqa: BLE001 — interpreter exit
            pass

    def run(self, units: Sequence[WorkUnit]) -> List[Optional[dict]]:
        """Execute (or replay) units; returns one result payload per
        slot, aligned with ``units`` (``None`` for failed units)."""
        t0 = time.time()
        keys = [self.key_for(u) for u in units]
        todo: Dict[str, WorkUnit] = {}
        for k, u in zip(keys, units):
            if k not in self.store and k not in todo:
                todo[k] = u
        self.stats = EngineStats(total=len(units),
                                 unique=len(set(keys)),
                                 cached=len(set(keys)) - len(todo))
        if todo:
            self._execute(todo)
        self.stats.elapsed_s = time.time() - t0
        out: List[Optional[dict]] = []
        seen = set()
        for k in keys:
            rec = self.store.get(k)
            out.append(rec["result"] if rec else None)
            if rec and k not in seen:
                seen.add(k)
                self.stats.unit_elapsed_s += float(rec.get("elapsed_s", 0.0))
        self.lifetime.absorb(self.stats)
        return out

    # ------------------------------------------------------------------
    def _record(self, key: str, unit: WorkUnit, result: dict,
                elapsed: float, attempts: int) -> None:
        # "attempts" rides along as an operational field (like
        # elapsed_s): volatile, excluded from content hashes and store
        # fingerprints — a unit that needed a retry is not a different
        # unit
        self.store.put(key, {
            "kind": unit.kind, "params": unit.as_dict(),
            "context": self.context, "result": result,
            "elapsed_s": round(elapsed, 4), "attempts": attempts,
        })
        self.stats.computed += 1

    def _fail(self, unit: WorkUnit, exc: BaseException,
              attempts: int) -> None:
        """Budget exhausted: surface as structured data, never raise —
        one bad unit must not abort the rest of a long sweep."""
        self.stats.failed += 1
        msg = (f"{unit.kind}{unit.as_dict()}: {type(exc).__name__}: {exc}"
               f" (after {attempts} attempt{'s' if attempts != 1 else ''})")
        self.stats.errors.append(msg)
        self.stats.failures.append({
            "kind": unit.kind, "params": unit.as_dict(),
            "attempts": attempts, "error_type": type(exc).__name__,
            "error": str(exc),
        })
        if self.verbose:
            print(f"[exp] FAIL {msg}", file=sys.stderr, flush=True)

    def _execute(self, todo: Dict[str, WorkUnit]) -> None:
        """Fan ``todo`` out through the executor backend, persisting each
        result the moment it lands: a crash mid-sweep loses at most the
        in-flight units.  Failed units (exceptions, timeouts, dead
        workers) are resubmitted in retry rounds until they succeed or
        exhaust ``1 + retries`` attempts."""
        ex, ephemeral = self._resolve_executor()
        try:
            ctx_arg = self._runner_context
            attempts: Dict[str, int] = {}
            round_todo = dict(todo)
            while round_todo:
                pending: Dict[Any, Tuple[str, WorkUnit]] = {}
                for key, unit in round_todo.items():
                    try:
                        fut = ex.submit(_invoke, self.runner, unit.kind,
                                        unit.as_dict(), ctx_arg,
                                        self.unit_timeout_s,
                                        self.timeout_grace_s)
                    except Exception as exc:    # noqa: BLE001
                        # a broken backend (e.g. BrokenProcessPool after
                        # a worker segfault) must surface as per-unit
                        # structured failures, never abort the sweep
                        attempts[key] = attempts.get(key, 0) + 1
                        self._fail(unit, exc, attempts[key])
                        continue
                    pending[fut] = (key, unit)
                retry: Dict[str, WorkUnit] = {}
                # scope completion to our own futures: a shared
                # (injected) executor may serve other engines
                # concurrently
                for fut in ex.as_completed(list(pending)):
                    key, unit = pending.pop(fut)
                    attempts[key] = attempts.get(key, 0) + 1
                    try:
                        result, dt = fut.result()
                    except Exception as exc:    # noqa: BLE001
                        if attempts[key] <= self.retries:
                            retry[key] = unit
                            self.stats.retried += 1
                            if self.verbose:
                                print(f"[exp] RETRY "
                                      f"({attempts[key]}/{self.retries})"
                                      f" {unit.kind}{unit.as_dict()}: "
                                      f"{type(exc).__name__}: {exc}",
                                      file=sys.stderr, flush=True)
                        else:
                            self._fail(unit, exc, attempts[key])
                        continue
                    self._record(key, unit, result, dt, attempts[key])
                round_todo = retry
        finally:
            if ephemeral:
                ex.shutdown()


def __getattr__(name: str):  # pragma: no cover — import back-compat
    if name in ("_worker_init", "_resolve_mp_context"):
        import repro_torch.exp.executors as _ex
        return getattr(_ex, name)
    raise AttributeError(name)
