"""Multi-fidelity search: ladder bindings + fidelity-aware drivers.

The substrate (PR 6's objective registry) already holds natural
fidelity ladders — ``hlo_cost`` → ``compile_cost`` → ``dryrun``,
``offline_proxy`` → ``offline``, ``kernel_analytic`` → ``kernel_time``
(see :func:`repro_torch.core.objectives.fidelity_ladder`).  This module makes
them searchable:

:class:`LadderBinding`
    One binding per rung, presented to :func:`repro_torch.exp.runners.
    drive_units` as a single cell.  Plain ``(provider, config)``
    requests hit the top rung (ground truth — identical content keys
    to the flat single-fidelity world), while rung-tagged requests
    ``(provider, config, rung)`` hit a cheaper approximation whose
    units carry a ``fidelity`` key field.

:class:`SuccessiveHalvingDriver` (``mf_sh``)
    Sweeps the whole grid at the analytic bottom rung (that rung
    exists precisely because it is ~free), then promotes the best
    ``1/eta`` fraction up each rung until ``~budget/eta`` survivors
    are measured at the ground truth.  Each rung is one
    embarrassingly-parallel ask batch.

:class:`PrefilterDriver` (``mf_prefilter``)
    Wraps any flat driver: every inner ask is first probed at the
    bottom rung; only candidates whose probe beats a threshold get a
    real measurement, the rest are answered with a calibrated estimate
    (probe × median observed top/bottom ratio).  The inner driver
    keeps its acquisition logic; real spend collapses to the
    promising region.

Both are suspendable ask/tell state machines dispatching through
``drive_units``, so they inherit executors, fault tolerance and store
memoization for free — and because top-rung unit keys carry no
fidelity field, their real measurements are shared verbatim with every
flat method's cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.domain import Domain
from repro_torch.core.objectives import (
    EvalFailure, ObjectiveBinding, fidelity_ladder)
from repro_torch.core.optimizers.base import History
from repro_torch.core.drivers import SearchDriver
from repro_torch.core.registry import get_method, register_method


def bind_ladder(family: str, **params: Any) -> "LadderBinding":
    """Bind every rung of a fidelity family in one call.

    Each rung receives the subset of ``params`` its spec accepts
    (rungs legitimately differ: ``kernel_time`` takes ``reps``,
    ``kernel_analytic`` does not); a param no rung accepts is a typo
    and rejected loudly.
    """
    specs = fidelity_ladder(family)
    accepted = set()
    for s in specs:
        accepted.update(s.params)
    unknown = sorted(set(params) - accepted)
    if unknown:
        raise ValueError(
            f"ladder {family!r} got unknown param(s) {unknown}; rungs "
            f"accept: {sorted(accepted)}")
    rungs = tuple(
        s.bind(**{k: v for k, v in params.items() if k in s.params})
        for s in specs)
    return LadderBinding(rungs)


@dataclasses.dataclass(frozen=True)
class LadderBinding:
    """A full fidelity ladder as one drive_units cell.

    ``rungs`` are cheapest-first; the last rung is the ground truth.
    The binding protocol (``unit`` / ``context`` / ``make_domain`` /
    ``describe``) delegates to the top rung — a flat driver pointed at
    a LadderBinding behaves exactly as if bound to the ground truth —
    and :meth:`rung_unit` is the extra surface fidelity-aware drivers
    reach through.
    """
    rungs: Tuple[ObjectiveBinding, ...]

    def __post_init__(self):
        if len(self.rungs) < 2:
            raise ValueError("a fidelity ladder needs at least 2 rungs")
        families = {r.spec.family for r in self.rungs}
        if len(families) != 1 or None in families:
            raise ValueError(
                f"ladder rungs span families {sorted(map(str, families))}; "
                f"all rungs must share one family")
        if not self.rungs[-1].spec.is_top_rung:
            raise ValueError(
                f"last rung {self.rungs[-1].spec.name!r} is not the "
                f"family top (rung=None)")

    @property
    def n_rungs(self) -> int:
        return len(self.rungs)

    @property
    def top(self) -> ObjectiveBinding:
        return self.rungs[-1]

    def rung_unit(self, rung: int, provider: str, config, **extra: Any):
        """Content-keyed unit at one rung; rung indices are positions
        in :attr:`rungs` (0 = cheapest, ``n_rungs-1`` = ground truth)."""
        if not 0 <= rung < len(self.rungs):
            raise IndexError(
                f"rung {rung} out of range for {self.describe()}")
        return self.rungs[rung].unit(provider, config, **extra)

    # ---- binding protocol: the ladder acts as its own top rung ----
    def unit(self, provider: str, config, **extra: Any):
        return self.top.unit(provider, config, **extra)

    def context(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for r in self.rungs:
            for k, v in r.context().items():
                if k in out and out[k] != v:
                    raise ValueError(
                        f"ladder {self.describe()} rungs disagree on "
                        f"context {k}: {out[k]!r} vs {v!r}")
                out[k] = v
        return out

    def make_domain(self):
        return self.top.make_domain()

    def param(self, name: str) -> Any:
        for r in reversed(self.rungs):
            try:
                return r.param(name)
            except KeyError:
                continue
        raise KeyError(name)

    def describe(self) -> str:
        return "ladder[" + " -> ".join(
            r.spec.name for r in self.rungs) + "]"


# ---------------------------------------------------------------------------
# Successive halving over fidelity rungs
# ---------------------------------------------------------------------------
class SuccessiveHalvingDriver(SearchDriver):
    """Promote survivors up the fidelity ladder.

    ``budget`` keeps its flat meaning — the ground-truth evaluations a
    flat method would spend — and successive halving converts it into
    ``max(1, round(budget/eta))`` *actual* top-rung measurements: the
    bottom (analytic) rung sweeps the entire grid, intermediate rungs
    shrink by ``eta`` per promotion, so the spend saving is the whole
    point of the schedule.  Each rung is one ask batch — the requests
    are mutually independent, so the engine fans them out concurrently.

    Failure semantics: a candidate whose evaluation fails at any rung
    is dropped from the race (recorded in :attr:`failures`); an
    all-failed top rung raises at :meth:`result`.  Determinism: ties
    promote in candidate order, which is itself a seeded shuffle of
    the grid.
    """

    def __init__(self, domain: Domain, budget: int, *, seed: int = 0,
                 eta: float = 3.0):
        if eta <= 1.0:
            raise ValueError(f"eta must be > 1, got {eta}")
        self.budget = int(budget)
        self.eta = float(eta)
        cands = domain.all_candidates()
        order = np.random.default_rng(seed).permutation(len(cands))
        self._candidates: List[Tuple[str, dict]] = [cands[i] for i in order]
        self.n_rungs: Optional[int] = None
        self._counts: Optional[List[int]] = None
        self._rung = 0
        self._survivors = list(range(len(self._candidates)))
        self._history = History()
        self._top_best: Optional[Tuple[str, dict, float]] = None
        self.failures: List[dict] = []
        #: rung index -> evaluations spent there
        self.spend: Dict[int, int] = {}
        self._done = False
        self._pending: Optional[list] = None

    def attach_ladder(self, n_rungs: int) -> None:
        """drive_units hook: learn the ladder shape before the first
        ask.  The promotion schedule depends only on (grid size,
        budget, eta, n_rungs), so it is fixed here once."""
        if n_rungs < 2:
            raise ValueError(
                f"mf_sh needs a fidelity ladder (>=2 rungs), got "
                f"{n_rungs}; bind the objective via bind_ladder()")
        if self.n_rungs is not None and n_rungs != self.n_rungs:
            raise ValueError("ladder shape changed mid-search")
        self.n_rungs = int(n_rungs)
        G = len(self._candidates)
        n_top = max(1, min(G, int(round(self.budget / self.eta))))
        counts = [n_top]
        for _ in range(self.n_rungs - 2):
            counts.append(min(G, int(round(counts[-1] * self.eta))))
        counts.append(G)                # bottom rung sweeps the grid
        self._counts = counts[::-1]     # cheapest-first
        self.spend = {r: 0 for r in range(self.n_rungs)}

    @property
    def done(self) -> bool:
        return self._pending is None and self._done

    @property
    def history(self) -> History:
        """Ground-truth evaluations only — estimates never enter."""
        return self._history

    def ask_batch(self):
        self._begin_ask()
        if self._counts is None:
            raise RuntimeError(
                "mf_sh asked before a ladder was attached: run it "
                "through drive_units with a LadderBinding")
        take = self._survivors[:self._counts[self._rung]]
        self._pending = list(take)
        return [(self._candidates[i][0], self._candidates[i][1],
                 self._rung) for i in take]

    def peek(self):
        # the next batch is the next rung's survivor set — unknown
        # until the in-flight rung scores, so guess its quota from the
        # current racers in request order; promotion overlap makes a
        # useful fraction of the prefetches land (and the rest are
        # just discarded staging entries, never stored)
        if self._pending is None or self._counts is None or self._done:
            return None
        nxt = self._rung + 1
        if self.n_rungs is None or nxt >= self.n_rungs:
            return None
        guess = self._pending[:self._counts[nxt]]
        return [(self._candidates[i][0], self._candidates[i][1], nxt)
                for i in guess]

    def tell_batch(self, values: Sequence[float]) -> None:
        pending = self._take_pending(values)
        top = self._rung == self.n_rungs - 1
        scored: List[Tuple[float, int]] = []
        for pos, (i, raw) in enumerate(zip(pending, values)):
            val = self._tell_value(raw)
            prov, cfg = self._candidates[i]
            self.spend[self._rung] += 1
            if isinstance(val, EvalFailure):
                self.failures.append({
                    "provider": prov, "config": cfg, "rung": self._rung,
                    "reason": val.reason})
                continue
            scored.append((val, pos))
            if top:
                self._history.append((prov, cfg), val)
                if self._top_best is None or val < self._top_best[2]:
                    self._top_best = (prov, cfg, val)
        if top:
            self._done = True
            return
        # promote the next rung's quota: best values first, ties in
        # candidate (request) order — stable and deterministic
        scored.sort(key=lambda t: (t[0], t[1]))
        keep = self._counts[self._rung + 1]
        self._survivors = [pending[pos] for _v, pos in scored[:keep]]
        self._rung += 1
        if not self._survivors:         # everything failed this rung
            self._done = True

    def result(self) -> Tuple[str, dict, float, History]:
        self._check_done()
        if self._top_best is None:
            raise RuntimeError(
                "no successful ground-truth evaluations: every "
                "candidate failed or was eliminated before the top rung")
        prov, cfg, loss = self._top_best
        return prov, cfg, loss, self._history


# ---------------------------------------------------------------------------
# Low-fidelity prefilter around any flat driver
# ---------------------------------------------------------------------------
class PrefilterDriver(SearchDriver):
    """Screen a flat driver's asks through the bottom rung.

    Every inner ask batch is first evaluated at rung 0.  A candidate
    is *promoted* to a real ground-truth measurement when its probe
    beats ``ratio ×`` the best probe seen so far (or during the first
    ``warmup`` asks, which both calibrates the probe→truth scale and
    protects against a mis-ranked start); everything else is answered
    to the inner driver with a calibrated estimate — probe × the
    median observed truth/probe ratio — so its surrogate keeps
    learning the landscape while real spend concentrates.

    The wrapper's own :attr:`history` and :meth:`result` contain
    ground-truth measurements only; estimates live inside the inner
    driver.  A failed probe promotes (screening on a failure would be
    flying blind); a failed real measurement is forwarded to the inner
    driver as the :class:`EvalFailure` it is.
    """

    def __init__(self, inner: SearchDriver, *, ratio: float = 1.5,
                 warmup: int = 3):
        if ratio < 1.0:
            raise ValueError(f"ratio must be >= 1, got {ratio}")
        self.inner = inner
        self.ratio = float(ratio)
        self.warmup = int(warmup)
        self.n_rungs: Optional[int] = None
        self._history = History()
        self._best: Optional[Tuple[str, dict, float]] = None
        self.failures: List[dict] = []
        self.spend: Dict[int, int] = {}
        #: (probe, truth) pairs the estimate scale is calibrated from
        self._pairs: List[Tuple[float, float]] = []
        self._low_best = math.inf
        self._asks = 0
        self.screened = 0               # requests answered by estimate
        #: None | ("low", inner_batch) | ("high", entries)
        self._phase: Optional[tuple] = None
        self._pending: Optional[list] = None

    def attach_ladder(self, n_rungs: int) -> None:
        if n_rungs < 2:
            raise ValueError(
                f"mf_prefilter needs a fidelity ladder (>=2 rungs), "
                f"got {n_rungs}; bind the objective via bind_ladder()")
        if self.n_rungs is not None and n_rungs != self.n_rungs:
            raise ValueError("ladder shape changed mid-search")
        self.n_rungs = int(n_rungs)
        self.spend = {0: 0, self.n_rungs - 1: 0}

    @property
    def done(self) -> bool:
        return (self._pending is None and self._phase is None
                and self.inner.done)

    @property
    def history(self) -> History:
        """Ground-truth evaluations only, in measurement order."""
        return self._history

    def _scale(self) -> float:
        """Median truth/probe ratio over calibrated pairs — the
        deterministic estimate factor for screened-out requests."""
        if not self._pairs:
            return 1.0
        ratios = sorted(t / p for p, t in self._pairs if p > 0)
        if not ratios:
            return 1.0
        n = len(ratios)
        mid = n // 2
        return ratios[mid] if n % 2 else \
            0.5 * (ratios[mid - 1] + ratios[mid])

    def ask_batch(self):
        self._begin_ask()
        if self.n_rungs is None:
            raise RuntimeError(
                "mf_prefilter asked before a ladder was attached: run "
                "it through drive_units with a LadderBinding")
        if self._phase is None:
            batch = self.inner.ask_batch()
            self._phase = ("low", batch)
            self._pending = list(range(len(batch)))
            return [(p, c, 0) for p, c in batch]
        kind, entries = self._phase
        if kind != "high":
            raise RuntimeError(f"unexpected prefilter phase {kind!r}")
        self._pending = [e for e in entries if e["promote"]]
        return [(e["provider"], e["config"], self.n_rungs - 1)
                for e in self._pending]

    def peek(self):
        # during warmup every probe promotes, so while the low batch is
        # in flight the coming ground-truth batch is known exactly.
        # Past warmup the promoted subset depends on the probes, and
        # speculating ground truth would defeat the screening economy —
        # no guess.
        if self._phase is None or self.n_rungs is None:
            return None
        kind, payload = self._phase
        if kind == "low" and self._asks + 1 <= self.warmup:
            return [(p, c, self.n_rungs - 1) for p, c in payload]
        return None

    def tell_batch(self, values: Sequence[float]) -> None:
        pending = self._take_pending(values)
        kind, payload = self._phase
        if kind == "low":
            self._asks += 1
            entries = []
            for (prov, cfg), raw in zip(payload, values):
                val = self._tell_value(raw)
                e = {"provider": prov, "config": cfg, "low": None,
                     "promote": True}
                if isinstance(val, EvalFailure):
                    self.failures.append({
                        "provider": prov, "config": cfg, "rung": 0,
                        "reason": val.reason})
                else:
                    e["low"] = val
                    self._low_best = min(self._low_best, val)
                    if (self._asks > self.warmup
                            and val > self.ratio * self._low_best):
                        e["promote"] = False
                self.spend[0] += 1
                entries.append(e)
            if any(e["promote"] for e in entries):
                self._phase = ("high", entries)
            else:                       # whole batch screened out
                self._finish_round(entries)
            return
        # kind == "high": real measurements for the promoted subset
        results = iter(values)
        for e in pending:
            raw = self._tell_value(next(results))
            self.spend[self.n_rungs - 1] += 1
            if isinstance(raw, EvalFailure):
                self.failures.append({
                    "provider": e["provider"], "config": e["config"],
                    "rung": self.n_rungs - 1, "reason": raw.reason})
                e["truth"] = raw
                continue
            e["truth"] = raw
            self._history.append((e["provider"], e["config"]), raw)
            if self._best is None or raw < self._best[2]:
                self._best = (e["provider"], e["config"], raw)
            if e["low"] is not None:
                self._pairs.append((e["low"], raw))
        self._finish_round(payload)

    def _finish_round(self, entries: List[dict]) -> None:
        """Answer the inner driver, in its own request order."""
        scale = self._scale()
        tells = []
        for e in entries:
            if e["promote"]:
                tells.append(e["truth"])
            else:
                self.screened += 1
                tells.append(e["low"] * scale)
        self.inner.tell_batch(tells)
        self._phase = None

    def result(self) -> Tuple[str, dict, float, History]:
        self._check_done()
        if self._best is None:
            raise RuntimeError(
                "no successful ground-truth evaluations: every "
                "promoted measurement failed")
        prov, cfg, loss = self._best
        return prov, cfg, loss, self._history


# ---------------------------------------------------------------------------
# Registrations — outside the paper's closed SEARCH_METHODS set (like
# the drift variants), discoverable via the "fidelity" tag
# ---------------------------------------------------------------------------
@register_method("mf_sh", budget_coupled=True,
                 tags=("fidelity", "halving"))
def _make_mf_sh(domain, budget, seed, target):
    return SuccessiveHalvingDriver(domain, budget, seed=seed)


@register_method("mf_prefilter", budget_coupled=True,
                 tags=("fidelity", "prefilter"))
def _make_mf_prefilter(domain, budget, seed, target):
    inner = get_method("smac").make_driver(domain, budget, seed,
                                           target=target)
    return PrefilterDriver(inner)
