"""Drift-robust bandits: EWMA drift detection + re-exploring variants.

A frozen-world bandit commits hard: CloudBandit eliminates arms
permanently and Rising Bandits never revisits an arm whose extrapolated
bound lost.  Under a moving market (``repro_torch.multicloud.market``) that
commitment is exactly wrong — the winning provider can degrade after
elimination already happened.  This module adds:

:class:`DriftDetector`
    Per-arm fast/slow EWMA divergence test, the same idiom as
    :class:`repro_torch.runtime.fault.StragglerDetector` (EWMA vs a reference
    level, threshold ratio, warm-up guard).

:class:`CBDriftDriver` (``cb_drift``)
    CloudBandit whose detected drift on the *incumbent* arm restores
    every eliminated arm and re-ranks them with a short every-arm sweep
    on post-drift observations only; drift on a non-incumbent arm only
    re-windows that arm (a non-leader moving cannot change who leads).
    After the halving schedule completes it keeps exploiting the
    incumbent arm until the overall budget is spent, so detection keeps
    running for the whole run.

:class:`RBDriftDriver` (``rb_drift``)
    Rising Bandits whose detected drift un-eliminates every arm and
    resets the best-so-far curves — stale pre-drift minima would both
    shield a degraded arm and block a recovered one.

Both register through :func:`repro_torch.core.registry.register_method` as
budget-coupled methods; neither carries the ``search`` tag — the
paper's SEARCH_METHODS tuple is a closed set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cloudbandit import b1_for_budget
from repro_torch.core.drivers import (
    CloudBanditDriver, CloudBanditResult, EvalRequest, RisingBanditsDriver)
from repro_torch.core.objectives import EvalFailure
from repro_torch.core.optimizers import RBFOpt
from repro_torch.core.registry import register_method


@dataclasses.dataclass
class DriftDetector:
    """Fast/slow EWMA divergence test over one arm's observations.

    The fast EWMA tracks the current level, the slow one the historical
    level; drift is declared when they diverge by more than
    ``threshold`` relative to the slow level for ``patience``
    consecutive observations — a single exploration spike must never
    trigger re-exploration, a sustained market shift must.  Warm-up
    guard as in :class:`~repro_torch.runtime.fault.StragglerDetector`: no
    verdicts before ``min_obs`` observations.

    Callers feed *normalized* observations (the min of an arm's recent
    pulls over the arm's best-so-far — see :meth:`_DriftMixin.
    _drift_obs`) so one threshold works across workloads whose
    objective scales differ by orders of magnitude."""
    alpha_fast: float = 0.5
    alpha_slow: float = 0.06
    threshold: float = 0.7
    min_obs: int = 5
    patience: int = 3

    def __post_init__(self):
        self.reset()

    def reset(self) -> None:
        self._fast: Optional[float] = None
        self._slow: Optional[float] = None
        self._count = 0
        self._streak = 0

    def observe(self, value: float) -> bool:
        """Feed one observation; returns True when drift is detected."""
        v = float(value)
        if self._fast is None:
            self._fast = self._slow = v
        else:
            self._fast = (1 - self.alpha_fast) * self._fast \
                + self.alpha_fast * v
            self._slow = (1 - self.alpha_slow) * self._slow \
                + self.alpha_slow * v
        self._count += 1
        if self._diverged():
            self._streak += 1
        else:
            self._streak = 0
        return self.drifted()

    def _diverged(self) -> bool:
        if self._count < self.min_obs or self._slow is None:
            return False
        scale = max(abs(self._slow), 1e-12)
        return abs(self._fast - self._slow) > self.threshold * scale

    def drifted(self) -> bool:
        return self._streak >= self.patience


class _DriftMixin:
    """Per-arm drift bookkeeping shared by both drift-aware drivers:
    detectors, the post-drift ranking windows, and the normalized
    observation stream."""

    #: window for the drift observable: the min of this many recent
    #: pulls over the arm's incumbent.  Exploration produces isolated
    #: high pulls — the window min stays near 1; a market shift lifts
    #: every pull — the window min rises with it.
    _recent_window = 3

    def _init_drift(self, detector: Optional[dict]) -> None:
        kw = dict(detector or {})
        self.detectors = {k: DriftDetector(**kw) for k in self.arms}
        self.drift_events: List[dict] = []
        self._fresh = {k: 0 for k in self.arms}     # ranking window start
        self._recent: Dict[str, List[float]] = {k: [] for k in self.arms}

    def _fresh_best(self, k: str) -> float:
        """Fresh-window incumbent value of one arm (clamped to the most
        recent observation when nothing post-drift has been seen)."""
        h = self.opts[k].history
        if not len(h):
            return 1.0
        i0 = min(self._fresh[k], len(h) - 1)
        return float(min(h.values[i0:]))

    def _drift_obs(self, k: str, raw: float) -> float:
        buf = self._recent[k]
        buf.append(float(raw))
        del buf[:-self._recent_window]
        return min(buf) / max(abs(self._fresh_best(k)), 1e-12)

    def _strict_fresh(self) -> Dict[str, Tuple[Any, float]]:
        """Per-arm incumbents over arms that actually have post-drift
        observations.  The clamped window of :meth:`_fresh_best` is fine
        for steering exploration, but the *final* answer must never rank
        an arm by its last pre-drift pull — that price no longer
        exists."""
        out: Dict[str, Tuple[Any, float]] = {}
        for k in self.arms:
            h = self.opts[k].history
            i0 = self._fresh.get(k, 0)
            if len(h) > i0:
                j = i0 + int(np.argmin(h.values[i0:]))
                out[k] = (h.points[j], float(h.values[j]))
        return out

    def _observe_drift(self, pending, values) -> Optional[str]:
        fired = None
        for (k, _idx, _probe), raw in zip(pending, values):
            if isinstance(raw, EvalFailure):
                continue
            if self.detectors[k].observe(self._drift_obs(k, raw)) \
                    and fired is None:
                fired = k
        return fired

    def _reset_drift_state(self) -> None:
        for a in self.arms:
            self._fresh[a] = len(self.opts[a].history)
            self.detectors[a].reset()
            self._recent[a] = []


# ---------------------------------------------------------------------------
# cb_drift: CloudBandit + re-exploration on drift
# ---------------------------------------------------------------------------
class CBDriftDriver(_DriftMixin, CloudBanditDriver):
    """Successive halving that can take its eliminations back.

    Runs the normal CloudBandit schedule; every successful tell also
    feeds that arm's :class:`DriftDetector`.  On detection the response
    is scoped to what the fire can actually change:

    * incumbent arm fired — the leader itself moved, so the whole
      ranking is suspect: eliminated arms are restored, detectors and
      the per-arm ranking windows reset (post-drift observations only —
      the point of re-exploring is that the old observations no longer
      rank arms), and a short *sweep* pulls every arm once per round
      for ``sweep_rounds`` rounds before the driver goes back to
      exploiting the (re-ranked) incumbent.  The sweep is deliberately
      cheap: restarting the whole halving schedule would spend the
      remaining budget re-pulling arms the sweep already ranked out.
    * any other arm fired — a non-leader moving cannot change who
      leads, so only that arm's window resets; no sweep, no
      un-elimination.

    Once the schedule finishes with budget left, the driver exploits
    the incumbent arm one pull per round — so a drift arriving after
    convergence is still caught and handled.
    """

    def __init__(self, domain, bbo_factory, *, budget: int,
                 eta: float = 2.0, seed: int = 0,
                 sweep_rounds: int = 2,
                 detector: Optional[dict] = None):
        K = len(domain.provider_names)
        try:
            b1 = b1_for_budget(int(budget), K, eta)
        except ValueError:      # below the schedule minimum: smallest b1
            b1 = 1
        super().__init__(domain, bbo_factory, b1=b1, eta=eta, seed=seed)
        self.budget = int(budget)
        self.used = 0
        self._sweep = 0
        self._sweep_rounds = int(sweep_rounds)
        self._init_drift(detector)

    @property
    def done(self) -> bool:
        return self._pending is None and self.used >= self.budget

    def ask_batch(self) -> List[EvalRequest]:
        if self._m <= self.K:
            return super().ask_batch()
        # schedule finished (or abandoned by a drift), budget remains:
        # sweep every arm right after a drift, otherwise exploit the
        # incumbent arm; keep probing paused arms either way
        self._begin_ask()
        self._pending = []
        out: List[EvalRequest] = []
        if self._sweep > 0:
            pool = list(self.active)
        else:
            ranked = [k for k in self.active if k in self.best]
            pool = [min(ranked, key=lambda a: self.best[a][1])] \
                if ranked else []
        for k in pool:
            o = self.opts[k]
            idx = o.ask()
            self._pending.append((k, idx, False))
            out.append((k, o.candidates[idx]))
        for k in (a for a in self.arms if a in self.paused):
            o = self.opts[k]
            idx = o.ask()
            self._pending.append((k, idx, True))
            out.append((k, o.candidates[idx]))
        return out

    def tell_batch(self, values) -> None:
        pending = list(self._pending or ())
        if self._m <= self.K:
            super().tell_batch(values)
        else:
            self._tell_exploit(values)
            if self._sweep > 0:
                self._sweep -= 1
        self.used += len(values)
        fired = self._observe_drift(pending, values)
        if fired is not None:
            if fired == self._incumbent():
                self._on_drift(fired)
            else:
                self._local_drift(fired)

    def _incumbent(self) -> Optional[str]:
        ranked = [k for k in self.active if k in self.best]
        if not ranked:
            return None
        return min(ranked, key=lambda a: self.best[a][1])

    def _tell_exploit(self, values) -> None:
        pending = self._take_pending(values)
        for (k, idx, probe), raw in zip(pending, values):
            val = self._tell_value(raw)
            o = self.opts[k]
            cfg = o.candidates[idx]
            if isinstance(val, EvalFailure):
                self.failures.append({
                    "arm": k, "config": cfg, "reason": val.reason,
                    "round": self._m, "probe": probe})
                if not probe and k in self.active:
                    self.active.remove(k)
                    self.paused[k] = self._m
                continue
            if probe:
                self.paused.pop(k, None)
                self.active.append(k)
                self.active.sort(key=self.arms.index)
                self.resurrections.append((k, self._m))
            o.tell(idx, val)
            self._history.append((k, cfg), val)
            self.pulls[k] += 1
            self.best[k] = self._arm_best(k)

    def _arm_best(self, k: str) -> Tuple[Any, float]:
        h = self.opts[k].history
        i0 = min(self._fresh[k], len(h) - 1)
        vals = h.values[i0:]
        j = i0 + int(np.argmin(vals))
        return h.points[j], h.values[j]

    def _local_drift(self, arm: str) -> None:
        """A non-incumbent arm moved.  That cannot change who leads —
        only the mover's own ranking data went stale — so re-window and
        re-rank just that arm instead of paying for a full sweep (under
        pure-failure scenarios the revoked arm keeps firing; a global
        sweep there is budget spent re-confirming an unchanged leader)."""
        self.drift_events.append(
            {"arm": arm, "eval": self.used, "round": self._m,
             "scope": "arm"})
        self._fresh[arm] = len(self.opts[arm].history)
        self.detectors[arm].reset()
        self._recent[arm] = []
        if len(self.opts[arm].history):
            self.best[arm] = self._arm_best(arm)

    def _on_drift(self, arm: str) -> None:
        self.drift_events.append(
            {"arm": arm, "eval": self.used, "round": self._m,
             "scope": "global"})
        # flush any half-round buffer so no observation is lost from the
        # history, then forget pre-drift state
        for k in self.arms:
            for point, val in self._round_buf.get(k, ()):
                self._history.append(point, val)
        self._round_buf = {}
        self._j = 0
        for a, _m in self.eliminated:
            if a not in self.active and a not in self.paused:
                self.active.append(a)
        self.active.sort(key=self.arms.index)
        self.eliminated = []
        self._protected = set()
        self._reset_drift_state()
        # re-rank on the fresh window (which clamps to the most recent
        # observation until post-drift data arrives) — the driver must
        # stay able to report an incumbent even if the budget runs out
        # before the restarted schedule completes a round
        self.best = {a: self._arm_best(a) for a in self.arms
                     if len(self.opts[a].history)}
        # abandon the halving schedule: a short sweep re-ranks the arms
        # on post-drift data, then the exploit loop takes over — a full
        # schedule restart would eat the remaining budget
        self._m = self.K + 1
        self._sweep = self._sweep_rounds

    def result(self) -> CloudBanditResult:
        """Post-drift incumbent on strict fresh windows: only arms with
        observations after the last drift may win (a drift firing on the
        very last eval must not hand the answer to an arm last seen at
        pre-drift prices).  Without any drift this reduces to the base
        ranking."""
        self._check_done()
        fresh = self._strict_fresh()
        if not fresh:
            # drift fired on the very last eval: no post-drift data
            # anywhere, so the full history (as if the drift never
            # fired) is the least-stale ranking available
            fresh = {k: self.opts[k].best() for k in self.arms
                     if len(self.opts[k].history)}
        if not fresh:
            return super().result()     # raises: nothing ever succeeded
        k_star = min(fresh, key=lambda k: fresh[k][1])
        cfg_star, loss_star = fresh[k_star]
        return CloudBanditResult(
            provider=k_star, config=cfg_star, loss=loss_star,
            history=self._history, eliminated=self.eliminated,
            pulls=self.pulls)


# ---------------------------------------------------------------------------
# rb_drift: Rising Bandits + un-elimination on drift
# ---------------------------------------------------------------------------
class RBDriftDriver(_DriftMixin, RisingBanditsDriver):
    """Rising Bandits whose eliminations are revocable under drift.

    Every successful tell feeds the arm's :class:`DriftDetector`; on
    detection all non-paused arms re-enter the sweep and the per-arm
    best-so-far curves restart (post-drift observations only), which
    also re-arms the warm-up guard before the next elimination."""

    def __init__(self, domain, budget: int, *, seed: int = 0,
                 warmup: int = 3, slope_window: int = 3,
                 detector: Optional[dict] = None):
        super().__init__(domain, budget, seed=seed, warmup=warmup,
                         slope_window=slope_window)
        self._init_drift(detector)

    def tell_batch(self, values) -> None:
        pending = list(self._pending or ())
        super().tell_batch(values)
        fired = self._observe_drift(pending, values)
        if fired is not None:
            self._on_drift(fired)

    def _on_drift(self, arm: str) -> None:
        self.drift_events.append(
            {"arm": arm, "eval": self.used, "scope": "global"})
        self.active = [a for a in self.arms if a not in self.paused]
        for a in self.arms:
            self.curves[a] = []
        self._reset_drift_state()

    def result(self):
        """Post-drift incumbent on strict fresh windows (arms actually
        observed after the last drift); pre-drift-only arms are ranked
        only when no arm has fresh data at all."""
        self._check_done()
        fresh = self._strict_fresh()
        if not fresh:
            fresh = {k: self.opts[k].best() for k in self.arms
                     if len(self.opts[k].history)}
        if not fresh:
            raise RuntimeError(
                "no successful evaluations: every arm failed every pull")
        best_k = min(fresh, key=lambda k: fresh[k][1])
        best_cfg, best_loss = fresh[best_k]
        return best_k, best_cfg, float(best_loss), self._history


# ---------------------------------------------------------------------------
# registrations (deliberately NOT tagged "search": the paper's
# SEARCH_METHODS tuple is a closed set)
# ---------------------------------------------------------------------------
@register_method("cb_drift", budget_coupled=True,
                 tags=("robust", "bandit", "drift"))
def _make_cb_drift(domain, budget, seed, target):
    return CBDriftDriver(domain, RBFOpt, budget=budget, seed=seed)


@register_method("rb_drift", budget_coupled=True,
                 tags=("robust", "bandit", "drift"))
def _make_rb_drift(domain, budget, seed, target):
    return RBDriftDriver(domain, budget, seed=seed)
