"""Suspendable search drivers: every method as an ask/tell state machine.

In the paper each objective evaluation is a real cloud deployment — the
dominant expense — so the search loop must not own the objective call.
Every method here is inverted into a :class:`SearchDriver`: a
deterministic state machine that *yields* batches of ``(provider,
config)`` evaluation requests (:meth:`~SearchDriver.ask_batch`) and
consumes their results (:meth:`~SearchDriver.tell_batch`), instead of
calling ``objective(...)`` inline.  The engine layer can then dispatch
requests through any executor backend, memoize identical evaluations
across methods/seeds/budgets, and batch independent requests into real
wall-clock wins on live objectives.

Batch shapes mirror each method's intrinsic parallelism:

* flat methods (RS, CD, exhaustive, CherryPick x1, Bilal x1, SMAC, TPE)
  are inherently sequential — batch size 1;
* the "x3" adaptations run K independent per-provider streams — one
  request per stream with remaining budget;
* CloudBandit pulls every active arm of a round concurrently — one
  request per active arm, ``b_m`` rounds deep;
* Rising Bandits sweeps the active arms — one request per active arm
  per sweep.

Bit-identity contract: tells are replayed into the component optimizers
in the exact order of the retained reference loops
(``repro_torch.core.evaluate.run_search_reference``,
:meth:`repro_torch.core.cloudbandit.CloudBandit.run`,
:meth:`repro_torch.core.rising_bandits.RisingBandits.run`), and each driver's
``history`` reproduces the reference ``History`` — points and values —
bit for bit.  The bit-identity suite (``tests/test_drivers.py``)
enforces this for every registered method.

Failure semantics: a tell may be an :class:`~repro_torch.core.objectives.
EvalFailure` instead of a float (provider outage, instance revocation —
see :mod:`repro_torch.multicloud.market`).  Every driver defines graceful
degradation: flat and per-provider-stream methods penalize the failed
point and continue; the bandit drivers pause the dead arm, probe it
each round, and resurrect it with fresh exploration on recovery.  A
failure never enters a ``history`` or a surrogate, and non-finite float
tells (NaN/inf) are rejected loudly — the structured path is the *only*
way to report a failed evaluation.  On an all-success run the failure
machinery is inert and the bit-identity contract above is unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cloudbandit import CloudBanditResult, b1_for_budget
from repro_torch.core.domain import Domain
from repro_torch.core.objectives import EvalFailure
from repro_torch.core.optimizers import (
    BO, RBFOpt, RandomSearch, SMACLike, TPE, bilal, cherrypick,
    CoordinateDescent, ExhaustiveSearch)
from repro_torch.core.optimizers.base import BlackBoxOptimizer, History
from repro_torch.core.registry import register_method

#: one evaluation request: (provider name, config dict)
EvalRequest = Tuple[str, dict]


class SearchDriver:
    """Suspendable search: alternate :meth:`ask_batch` / :meth:`tell_batch`
    until :attr:`done`.

    The driver never calls the objective; the caller evaluates each
    yielded ``(provider, config)`` request however it likes (inline,
    through an executor pool, against a memoizing store) and replies
    with one value per request, in request order.
    """

    @property
    def done(self) -> bool:
        raise NotImplementedError

    @property
    def history(self) -> History:
        """Evaluation log in the reference loop's exact order (only
        complete once :attr:`done`)."""
        raise NotImplementedError

    def ask_batch(self) -> List[EvalRequest]:
        """Next batch of evaluation requests.  Only valid when not
        :attr:`done` and with no batch outstanding."""
        raise NotImplementedError

    def tell_batch(self, values: Sequence[float]) -> None:
        """Report results for the outstanding batch, in request order."""
        raise NotImplementedError

    def peek(self) -> Optional[List[EvalRequest]]:
        """Best guess at the *next* ``ask_batch``, without mutating any
        driver state.

        The pipelined scheduler's speculative ask-ahead
        (:mod:`repro_torch.exp.sched`) calls this while a batch is in flight
        and prefetches the guessed requests through idle executor
        slots; a wrong guess costs nothing but the prefetch itself —
        tells always replay in exact ask order, so histories stay
        bit-identical whether or not a guess was right.  Returns
        ``None`` when the driver has no useful guess (the default).
        Implementations must leave the driver's observable state
        untouched (work on copies) and may be called with or without
        an outstanding batch."""
        return None

    # ------------------------------------------------------------------
    def _begin_ask(self) -> None:
        """Protocol guard (raises, never asserts — must hold under -O):
        strict ask/tell alternation, no asks past completion."""
        if getattr(self, "_pending", None) is not None:
            raise RuntimeError("ask_batch with a batch already outstanding")
        if self.done:
            raise RuntimeError("ask_batch on a completed driver")

    def _check_done(self) -> None:
        if not self.done:
            raise RuntimeError("result() before the driver is done")

    def _take_pending(self, values: Sequence[float]) -> list:
        pending = getattr(self, "_pending", None)
        if pending is None:
            raise RuntimeError("tell_batch without a pending ask_batch")
        if len(values) != len(pending):
            raise ValueError(
                f"expected {len(pending)} values, got {len(values)}")
        self._pending = None
        return pending

    def _tell_value(self, raw):
        """Validate one told value: an :class:`EvalFailure` passes
        through (the structured failure path), anything else must be a
        finite float — a NaN/inf sentinel would silently poison the
        surrogates, so it is rejected loudly instead."""
        if isinstance(raw, EvalFailure):
            return raw
        v = float(raw)
        if not math.isfinite(v):
            raise ValueError(
                f"non-finite tell {v!r}: report failed evaluations as "
                f"EvalFailure, never as NaN/inf")
        return v

    @staticmethod
    def _penalty(observed: Sequence[float]) -> float:
        """Continue-after-failure value for methods without an arm to
        pause: decisively worse than anything observed (objectives are
        positive runtimes/costs), but finite — surrogates stay sane."""
        finite = [v for v in observed if math.isfinite(v)]
        return 10.0 * max(finite) if finite else 1e6


def _ghost_ask(opt: BlackBoxOptimizer) -> Optional[Any]:
    """``ask()`` on a deepcopy: the optimizer's next proposal assuming
    the outstanding tells don't change its mind — exact for
    history-blind proposers (RandomSearch's rng never sees tells), a
    plausible guess for surrogate-driven ones.  The real optimizer is
    never touched; any failure (e.g. an exhausted candidate set) just
    means "no guess"."""
    import copy
    try:
        ghost = copy.deepcopy(opt)
        return ghost.candidates[ghost.ask()]
    except Exception:           # noqa: BLE001 — a guess is best-effort
        return None


def drive(driver: SearchDriver,
          objective: Callable[[str, dict], float]) -> History:
    """Run a driver to completion against an inline objective — the
    closed-loop behaviour the drivers replaced, as a 4-line adapter."""
    while not driver.done:
        batch = driver.ask_batch()
        driver.tell_batch([objective(p, c) for p, c in batch])
    return driver.history


# ---------------------------------------------------------------------------
# Flat methods: one optimizer over the flattened domain, batch size 1
# ---------------------------------------------------------------------------
class FlatDriver(SearchDriver):
    """Wraps a :class:`BlackBoxOptimizer` whose candidates are full
    ``(provider, config)`` points; sequential by nature (ask t+1 depends
    on tell t), so batches are singletons."""

    def __init__(self, opt: BlackBoxOptimizer, budget: int):
        self.opt = opt
        self.budget = int(budget)
        self.failures: List[dict] = []
        self._pending: Optional[list] = None

    @property
    def done(self) -> bool:
        return self._pending is None and len(self.opt.history) >= self.budget

    @property
    def history(self) -> History:
        return self.opt.history

    def ask_batch(self) -> List[EvalRequest]:
        self._begin_ask()
        idx = self.opt.ask()
        self._pending = [idx]
        return [self.opt.candidates[idx]]

    def peek(self) -> Optional[List[EvalRequest]]:
        spent = len(self.opt.history) + len(self._pending or ())
        if spent >= self.budget:
            return None
        point = _ghost_ask(self.opt)
        return None if point is None else [point]

    def tell_batch(self, values: Sequence[float]) -> None:
        (idx,) = self._take_pending(values)
        v = self._tell_value(values[0])
        if isinstance(v, EvalFailure):
            # penalize-and-continue: no arm to pause, so the failed
            # point enters the history at a finite worst-case value
            penalty = self._penalty(self.opt.history.values)
            self.failures.append({
                "point": self.opt.candidates[idx], "reason": v.reason,
                "eval": len(self.opt.history), "penalty": penalty})
            v = penalty
        self.opt.tell(idx, v)


# ---------------------------------------------------------------------------
# "x3" adaptation: K independent per-provider streams, budget split equally
# ---------------------------------------------------------------------------
class IndependentDriver(SearchDriver):
    """One component optimizer per provider, each a sequential stream;
    streams are mutually independent, so every round yields one request
    per stream with remaining budget.  The history concatenates the
    per-stream logs in provider order — exactly the reference loop,
    which ran the streams one after another."""

    def __init__(self, factory: Callable[..., BlackBoxOptimizer],
                 domain: Domain, budget: int, seed: int,
                 attr: bool = False):
        from repro_torch.multicloud.providers import attr_encode_config
        rng = np.random.default_rng(seed)
        provs = domain.provider_names
        share = budget // len(provs)
        extra = budget - share * len(provs)
        #: per stream: [provider, optimizer, remaining budget, History]
        self._streams: List[list] = []
        for i, prov in enumerate(provs):
            b = share + (1 if i < extra else 0)
            cands = domain.inner_candidates(prov)
            if attr:
                enc = lambda c, _p=prov: attr_encode_config(_p, c)  # noqa: E731
            else:
                enc = domain.inner_encoder(prov).encode
            opt = factory(cands, enc, seed=int(rng.integers(2 ** 31)))
            self._streams.append([prov, opt, b, History()])
        self.failures: List[dict] = []
        self._pending: Optional[list] = None

    @property
    def done(self) -> bool:
        return self._pending is None and all(s[2] <= 0 for s in self._streams)

    @property
    def history(self) -> History:
        h = History()
        for _prov, _opt, _b, sh in self._streams:
            h.points.extend(sh.points)
            h.values.extend(sh.values)
        return h

    def ask_batch(self) -> List[EvalRequest]:
        self._begin_ask()
        self._pending = []
        out: List[EvalRequest] = []
        for stream in self._streams:
            prov, opt, b, _sh = stream
            if b <= 0:
                continue
            idx = opt.ask()
            self._pending.append((stream, idx))
            out.append((prov, opt.candidates[idx]))
        return out

    def peek(self) -> Optional[List[EvalRequest]]:
        asked = {id(s) for s, _i in (self._pending or ())}
        out: List[EvalRequest] = []
        for stream in self._streams:
            prov, opt, b, _sh = stream
            if b - (1 if id(stream) in asked else 0) <= 0:
                continue
            cfg = _ghost_ask(opt)
            if cfg is not None:
                out.append((prov, cfg))
        return out or None

    def tell_batch(self, values: Sequence[float]) -> None:
        pending = self._take_pending(values)
        for (stream, idx), raw in zip(pending, values):
            prov, opt, _b, sh = stream
            val = self._tell_value(raw)
            if isinstance(val, EvalFailure):
                # the stream still spends its budget: a dead provider
                # must not trap the driver in an endless retry loop
                penalty = self._penalty(opt.history.values)
                self.failures.append({
                    "provider": prov, "config": opt.candidates[idx],
                    "reason": val.reason, "penalty": penalty})
                val = penalty
            opt.tell(idx, val)
            sh.append((prov, opt.candidates[idx]), val)
            stream[2] -= 1


# ---------------------------------------------------------------------------
# CloudBandit (Algorithm 1): all active arms' pulls of a round, concurrently
# ---------------------------------------------------------------------------
class CloudBanditDriver(SearchDriver):
    """Successive-halving over provider arms.  Within a round every
    active arm takes ``b_m`` sequential pulls, but the arms are mutually
    independent — so pull ``j`` of the round yields one request per
    active arm.  The round's history is flushed in arm order (matching
    the reference loop, which ran arms one after another), then the
    worst arm is eliminated and the per-arm budget doubles.

    Failure semantics: an arm whose pull fails (provider outage) is
    *paused* — removed from the active set without counting as
    eliminated — and probed once per subsequent ask round; the first
    successful probe resurrects it into the active set, protected from
    elimination for the round it rejoins.  With no failures none of
    this machinery runs and histories stay bit-identical to the
    reference loop."""

    def __init__(self, domain: Domain, bbo_factory: Callable[..., Any], *,
                 b1: int = 1, eta: float = 2.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.arms = list(domain.provider_names)
        self.K = len(self.arms)
        self.eta = eta
        self.opts: Dict[str, BlackBoxOptimizer] = {}
        for k in self.arms:                 # seed draws in arm order
            self.opts[k] = bbo_factory(
                domain.inner_candidates(k), domain.inner_encoder(k).encode,
                seed=int(rng.integers(2 ** 31)))
        self.active = list(self.arms)
        self._history = History()
        self.eliminated: List[Tuple[str, int]] = []
        self.pulls = {k: 0 for k in self.arms}
        self.best: Dict[str, Tuple[Any, float]] = {}
        self.paused: Dict[str, int] = {}    # arm -> round it went dark
        self.failures: List[dict] = []
        self.resurrections: List[Tuple[str, int]] = []
        self._protected: set = set()        # resurrected this round
        self._m = 1                         # current round (1..K)
        self._b_m = int(b1)
        self._j = 0                         # pulls completed this round
        self._round_buf: Dict[str, list] = {}
        self._pending: Optional[list] = None

    @property
    def done(self) -> bool:
        return self._pending is None and self._m > self.K

    @property
    def history(self) -> History:
        return self._history

    def ask_batch(self) -> List[EvalRequest]:
        self._begin_ask()
        self._pending = []
        out: List[EvalRequest] = []
        for k in self.active:
            o = self.opts[k]
            idx = o.ask()
            self._pending.append((k, idx, False))
            out.append((k, o.candidates[idx]))
        # one recovery probe per paused arm per batch, after the active
        # pulls; arm order keeps the request sequence deterministic
        for k in (a for a in self.arms if a in self.paused):
            o = self.opts[k]
            idx = o.ask()
            self._pending.append((k, idx, True))
            out.append((k, o.candidates[idx]))
        return out

    def peek(self) -> Optional[List[EvalRequest]]:
        # next batch = the active arms' next pulls (same round or, if
        # the outstanding tell closes the round, the survivors' first
        # pulls of the next — at worst one eliminated arm is a wasted
        # guess).  Paused-arm probes are skipped: a dark arm's eval is
        # expected to fail, so prefetching it buys nothing.
        if self._m > self.K:
            return None
        out: List[EvalRequest] = []
        for k in self.active:
            cfg = _ghost_ask(self.opts[k])
            if cfg is not None:
                out.append((k, cfg))
        return out or None

    def tell_batch(self, values: Sequence[float]) -> None:
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
            if probe:       # recovered: rejoin, shielded this round
                self.paused.pop(k, None)
                self.active.append(k)
                self.active.sort(key=self.arms.index)
                self._protected.add(k)
                self.resurrections.append((k, self._m))
            o.tell(idx, val)
            self._round_buf.setdefault(k, []).append(((k, cfg), val))
            self.pulls[k] += 1
        self._j += 1
        if self._j >= self._b_m:
            self._finish_round()

    def _arm_best(self, k: str) -> Tuple[Any, float]:
        """Incumbent of one arm; drift-aware subclasses narrow this to a
        post-drift window."""
        return self.opts[k].best()

    def _finish_round(self) -> None:
        # flush the round's evaluations arm-by-arm: the reference loop
        # ran arm k's b_m pulls to completion before touching arm k+1.
        # Iterating self.arms (not self.active) keeps a just-paused
        # arm's partial round in the history; on an all-success run the
        # two orders coincide.
        for k in self.arms:
            if k not in self._round_buf and k not in self.active:
                continue
            for point, val in self._round_buf.get(k, ()):
                self._history.append(point, val)
            if len(self.opts[k].history):
                self.best[k] = self._arm_best(k)
        self._round_buf = {}
        # resurrected arms keep elimination immunity for the round they
        # rejoined; a round where every peer is protected skips
        # elimination rather than killing the sole survivor
        cands = [k for k in self.active
                 if k in self.best and k not in self._protected]
        if len(cands) > 1:
            worst = max(cands, key=lambda k: self.best[k][1])
            self.active.remove(worst)
            self.eliminated.append((worst, self._m))
        self._protected = set()
        self._b_m = int(round(self.eta * self._b_m))
        self._m += 1
        self._j = 0

    def result(self) -> CloudBanditResult:
        self._check_done()
        pool = [k for k in self.active if k in self.best] \
            or [k for k in self.arms if k in self.best]
        if not pool:
            raise RuntimeError(
                "no successful evaluations: every arm failed every pull")
        k_star = min(pool, key=lambda k: self.best[k][1])
        cfg_star, loss_star = self.best[k_star]
        return CloudBanditResult(
            provider=k_star, config=cfg_star, loss=loss_star,
            history=self._history, eliminated=self.eliminated,
            pulls=self.pulls)


# ---------------------------------------------------------------------------
# Rising Bandits: one request per active arm per sweep
# ---------------------------------------------------------------------------
class RisingBanditsDriver(SearchDriver):
    """Round-robin sweeps over the active arms with extrapolated-bound
    elimination after each sweep; a sweep's pulls are independent across
    arms, so each sweep is one batch (truncated at the budget).

    Failure semantics mirror :class:`CloudBanditDriver`: a failed pull
    pauses the arm (distinct from elimination), paused arms are probed
    once per sweep after the active arms, and a successful probe
    resurrects the arm.  Failed pulls still consume budget — a fully
    dark market must terminate, not spin."""

    def __init__(self, domain: Domain, budget: int, *, seed: int = 0,
                 warmup: int = 3, slope_window: int = 3):
        rng = np.random.default_rng(seed)
        self.budget = int(budget)
        self.warmup = warmup
        self.slope_window = slope_window
        self.arms = list(domain.provider_names)
        self.opts: Dict[str, BO] = {
            k: BO(domain.inner_candidates(k),
                  domain.inner_encoder(k).encode,
                  seed=int(rng.integers(2 ** 31)),
                  surrogate="gp", acq="gp_hedge")
            for k in self.arms
        }
        self.curves: Dict[str, List[float]] = {k: [] for k in self.arms}
        self.active = list(self.arms)
        self.paused: set = set()
        self.failures: List[dict] = []
        self.resurrections: List[Tuple[str, int]] = []
        self._history = History()
        self.used = 0
        self._pending: Optional[list] = None

    @property
    def done(self) -> bool:
        return self._pending is None and self.used >= self.budget

    @property
    def history(self) -> History:
        return self._history

    def ask_batch(self) -> List[EvalRequest]:
        self._begin_ask()
        # the reference sweep breaks out as soon as the budget is hit,
        # so a final partial sweep only covers the first few active
        # arms.  Paused arms are probed after the sweep (arm order),
        # inside the same budget truncation.
        order = list(self.active) + [k for k in self.arms
                                     if k in self.paused]
        sweep = order[:self.budget - self.used]
        self._pending = []
        out: List[EvalRequest] = []
        for k in sweep:
            o = self.opts[k]
            idx = o.ask()
            self._pending.append((k, idx, k in self.paused))
            out.append((k, o.candidates[idx]))
        return out

    def peek(self) -> Optional[List[EvalRequest]]:
        # next sweep over the currently-active arms, truncated at the
        # budget remaining once the outstanding batch lands
        rem = self.budget - self.used - len(self._pending or ())
        if rem <= 0:
            return None
        out: List[EvalRequest] = []
        for k in self.active[:rem]:
            cfg = _ghost_ask(self.opts[k])
            if cfg is not None:
                out.append((k, cfg))
        return out or None

    def tell_batch(self, values: Sequence[float]) -> None:
        pending = self._take_pending(values)
        for (k, idx, probe), raw in zip(pending, values):
            val = self._tell_value(raw)
            o = self.opts[k]
            cfg = o.candidates[idx]
            if isinstance(val, EvalFailure):
                self.failures.append({
                    "arm": k, "config": cfg, "reason": val.reason,
                    "eval": self.used, "probe": probe})
                self.used += 1          # failures still consume budget
                if not probe and k in self.active:
                    self.active.remove(k)
                    self.paused.add(k)
                continue
            if probe:
                self.paused.discard(k)
                self.active.append(k)
                self.active.sort(key=self.arms.index)
                self.resurrections.append((k, self.used))
            o.tell(idx, val)
            self._history.append((k, cfg), val)
            self.used += 1
            self.curves[k].append(min(val, self.curves[k][-1])
                                  if self.curves[k] else val)
        self._eliminate()

    def _eliminate(self) -> None:
        # verbatim from the reference loop: extrapolated confidence
        # bounds after every sweep once all active arms warmed up
        if len(self.active) > 1 and all(
                len(self.curves[k]) >= self.warmup for k in self.active):
            remaining = self.budget - self.used
            lower: Dict[str, float] = {}
            current: Dict[str, float] = {}
            for k in self.active:
                c = self.curves[k]
                w = min(self.slope_window, len(c) - 1)
                slope = (c[-1] - c[-1 - w]) / max(w, 1)  # ≤ 0
                lower[k] = c[-1] + slope * max(
                    remaining // max(len(self.active), 1), 1)
                current[k] = c[-1]
            best_current = min(current.values())
            for k in list(self.active):
                if len(self.active) > 1 and lower[k] > best_current:
                    self.active.remove(k)

    def result(self) -> Tuple[str, dict, float, History]:
        self._check_done()
        best_k = min(self.arms, key=lambda k: self.opts[k].best()[1]
                     if len(self.opts[k].history) else np.inf)
        cfg, loss = self.opts[best_k].best()
        return best_k, cfg, loss, self._history


# ---------------------------------------------------------------------------
# Built-in method registrations (registration order = the paper's
# SEARCH_METHODS order; repro_torch.core.evaluate derives its tuple from this)
# ---------------------------------------------------------------------------
def _flat(opt_cls, domain: Domain, budget: int, seed: int,
          encode=None, **kw) -> FlatDriver:
    cands = domain.all_candidates()
    encode = encode or domain.flat_encoder().encode
    return FlatDriver(opt_cls(cands, encode, seed=seed, **kw), budget)


@register_method("random", tags=("search", "baseline", "flat"))
def _make_random(domain, budget, seed, target):
    return _flat(RandomSearch, domain, budget, seed)


@register_method("cd", tags=("search", "baseline", "flat"))
def _make_cd(domain, budget, seed, target):
    return _flat(CoordinateDescent, domain, budget, seed)


@register_method("exhaustive", tags=("search", "baseline", "flat"))
def _make_exhaustive(domain, budget, seed, target):
    return _flat(ExhaustiveSearch, domain, min(budget, domain.size()), seed)


@register_method("cherrypick_x1", tags=("search", "sota", "flat"))
def _make_cherrypick_x1(domain, budget, seed, target):
    from repro_torch.multicloud.providers import attr_encode_point
    return _flat(BO, domain, budget, seed, encode=attr_encode_point,
                 surrogate="gp", acq="ei")


@register_method("cherrypick_x3", tags=("search", "sota", "independent"))
def _make_cherrypick_x3(domain, budget, seed, target):
    return IndependentDriver(cherrypick, domain, budget, seed, attr=True)


@register_method("bilal_x1", tags=("search", "sota", "flat"))
def _make_bilal_x1(domain, budget, seed, target):
    from repro_torch.multicloud.providers import attr_encode_point
    kw = dict(surrogate="gp", acq="lcb") if target == "cost" else \
        dict(surrogate="rf", acq="pi")
    return _flat(BO, domain, budget, seed, encode=attr_encode_point, **kw)


@register_method("bilal_x3", tags=("search", "sota", "independent"))
def _make_bilal_x3(domain, budget, seed, target):
    return IndependentDriver(
        lambda c, e, seed=0: bilal(c, e, seed, target=target),
        domain, budget, seed, attr=True)


@register_method("smac", tags=("search", "hierarchical", "flat"))
def _make_smac(domain, budget, seed, target):
    return _flat(SMACLike, domain, budget, seed)


@register_method("hyperopt", tags=("search", "hierarchical", "flat"))
def _make_hyperopt(domain, budget, seed, target):
    cands = domain.all_candidates()
    enc = domain.flat_encoder()
    return FlatDriver(TPE(cands, enc.encode, seed=seed, domain=domain),
                      budget)


@register_method("rb", budget_coupled=True,
                 tags=("search", "hierarchical", "bandit"))
def _make_rb(domain, budget, seed, target):
    return RisingBanditsDriver(domain, budget, seed=seed)


@register_method("cb_cherrypick", budget_coupled=True,
                 tags=("search", "hierarchical", "bandit"))
def _make_cb_cherrypick(domain, budget, seed, target):
    b1 = b1_for_budget(budget, len(domain.provider_names))
    return CloudBanditDriver(domain, cherrypick, b1=b1, seed=seed)


@register_method("cb_rbfopt", budget_coupled=True,
                 tags=("search", "hierarchical", "bandit"))
def _make_cb_rbfopt(domain, budget, seed, target):
    b1 = b1_for_budget(budget, len(domain.provider_names))
    return CloudBanditDriver(domain, RBFOpt, b1=b1, seed=seed)


# drift-robust variants (cb_drift / rb_drift) and the multi-fidelity
# drivers (mf_sh / mf_prefilter) register on import; they live in their
# own modules but are part of the builtin set the registry loads
# through this one
from repro_torch.core import drift as _drift      # noqa: E402,F401
from repro_torch.core import fidelity as _fidelity    # noqa: E402,F401
