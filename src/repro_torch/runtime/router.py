"""Search-backed config router — the serving stack's control plane.

Requests tagged with a workload are routed to the (provider, config) the
registered search driver currently believes best.  While the driver has
budget left, the router serves its outstanding ask batch as live traffic
(one "explore" decision per request slot); the observed latencies flow
back through :meth:`ConfigRouter.observe` and are told to the driver as a
normal ``tell_batch`` — online tells through the exact ask/tell +
:class:`~repro_torch.core.objectives.ObjectiveSpec` machinery the offline
searches use.  Once the batch is fully assigned (or the driver is done)
requests ride the incumbent ("exploit").

A :class:`~repro_torch.multicloud.market.MarketOverlay` + ``MarketClock`` can
degrade or outage a backend mid-run: unavailable explore targets are
answered with structured :class:`EvalFailure` tells (the driver's
penalize/pause machinery degrades gracefully), unavailable incumbents
fail over to the next-best available backend, and when the whole market
is dark the router still returns a best-effort "blind" decision — the
service never aborts.  The clock advances one tick per completed ask
round, mirroring ``drive_units(clock=)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.objectives import EvalFailure, ObjectiveBinding


@dataclasses.dataclass
class RouteDecision:
    """One routing verdict; pass it back to :meth:`ConfigRouter.observe`
    with the latency observed while serving on the chosen backend."""
    workload: str
    provider: str
    config: Dict[str, Any]
    kind: str                   # explore | exploit | failover | blind
    tick: int
    slot: Optional[int] = None  # outstanding-ask-batch index (explore only)


@dataclasses.dataclass
class _Entry:
    driver: Any
    binding: Optional[ObjectiveBinding]
    domain: Any
    batch: Optional[List[Any]] = None     # outstanding ask requests
    answers: Optional[List[Any]] = None   # per-slot observed values
    cursor: int = 0                       # next unassigned batch slot
    failovers: int = 0                    # decisions diverted by the market
    rounds: int = 0                       # completed ask/tell rounds
    observed: List[Tuple[RouteDecision, Any]] = \
        dataclasses.field(default_factory=list)


class ConfigRouter:
    """Route workload-tagged requests via a suspendable search driver.

    overlay/clock are optional: without them every backend is always
    available and ticks only count ask rounds.
    """

    def __init__(self, *, overlay=None, clock=None):
        self.overlay = overlay
        self.clock = clock
        self._entries: Dict[str, _Entry] = {}

    # ------------------------------------------------------------------
    def register(self, workload: str, driver, *,
                 binding: Optional[ObjectiveBinding] = None,
                 domain=None) -> None:
        """Attach a driver (and its binding/domain) to a workload tag."""
        if domain is None:
            if binding is None:
                raise ValueError("register() needs a binding or a domain")
            domain = binding.make_domain()
        self._entries[workload] = _Entry(driver, binding, domain)

    def workloads(self) -> Tuple[str, ...]:
        return tuple(self._entries)

    # ------------------------------------------------------------------
    def route(self, workload: str) -> RouteDecision:
        """Pick the backend for one incoming request.

        Serves the driver's outstanding ask batch first (explore), the
        incumbent otherwise (exploit/failover/blind).  Never raises on
        market conditions: dead explore targets become immediate
        ``EvalFailure`` tells and the request is re-routed.
        """
        e = self._entry(workload)
        drv = e.driver
        while not drv.done:
            tick = self._tick()
            if e.batch is None:
                e.batch = list(drv.ask_batch())
                e.answers = [None] * len(e.batch)
                e.cursor = 0
            while e.cursor < len(e.batch):
                i = e.cursor
                e.cursor += 1
                prov, cfg = e.batch[i][0], dict(e.batch[i][1])
                reason = self._unavailable(prov, cfg, tick)
                if reason is None:
                    return RouteDecision(workload, prov, cfg, "explore",
                                         tick, slot=i)
                # dead backend: structured failure tell, keep serving
                e.answers[i] = EvalFailure(reason=reason)
                e.failovers += 1
            if not self._maybe_tell(e):
                break       # batch awaiting live observations
        return self._exploit(workload, e, self._tick())

    def observe(self, decision: RouteDecision, latency) -> None:
        """Report the latency served on ``decision``'s backend.

        Explore observations answer their ask-batch slot; when the batch
        is complete it is told to the driver and the market clock
        advances one tick.  Exploit observations are logged (drivers
        accept tells only for their own asks).  ``latency`` may be an
        :class:`EvalFailure` (the backend died mid-request)."""
        e = self._entry(decision.workload)
        if not isinstance(latency, EvalFailure):
            latency = float(latency)
            if not math.isfinite(latency):
                raise ValueError(
                    f"observed latency must be finite or an EvalFailure, "
                    f"got {latency!r}")
        e.observed.append((decision, latency))
        if decision.kind == "explore" and e.batch is not None \
                and decision.slot is not None \
                and decision.slot < len(e.batch) \
                and e.answers[decision.slot] is None:
            e.answers[decision.slot] = latency
            self._maybe_tell(e)

    # ------------------------------------------------------------------
    def best(self, workload: str) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Current belief: the best (provider, config) observed so far."""
        ranked = self._ranked(self._entry(workload))
        return ranked[0] if ranked else None

    def stats(self, workload: str) -> Dict[str, Any]:
        e = self._entry(workload)
        return {
            "done": bool(e.driver.done),
            "rounds": e.rounds,
            "failovers": e.failovers,
            "observed": len(e.observed),
            "told": len(e.driver.history),
            "failures": len(getattr(e.driver, "failures", ())),
        }

    # ------------------------------------------------------------------
    def _entry(self, workload: str) -> _Entry:
        try:
            return self._entries[workload]
        except KeyError:
            raise KeyError(f"no driver registered for workload "
                           f"{workload!r}") from None

    def _tick(self) -> int:
        return int(self.clock.tick) if self.clock is not None else 0

    def _unavailable(self, provider: str, config, tick: int) -> Optional[str]:
        if self.overlay is None:
            return None
        return self.overlay.unavailable_reason(tick, provider, config)

    def _maybe_tell(self, e: _Entry) -> bool:
        if e.batch is None or any(a is None for a in e.answers):
            return False
        e.driver.tell_batch(e.answers)
        e.batch = None
        e.answers = None
        e.cursor = 0
        e.rounds += 1
        if self.clock is not None:
            self.clock.advance()            # tick = completed ask round
        return True

    def _ranked(self, e: _Entry) -> List[Tuple[str, Dict[str, Any]]]:
        """(provider, config) candidates, best observed value first,
        deduplicated; unevaluated points keep domain order at the tail."""
        h = e.driver.history
        scored = sorted(
            ((v, i) for i, v in enumerate(h.values)
             if isinstance(v, float) and math.isfinite(v)),
            key=lambda t: t[0])
        out: List[Tuple[str, Dict[str, Any]]] = []
        seen = set()

        def push(prov, cfg):
            key = (prov, tuple(sorted((k, str(v)) for k, v in cfg.items())))
            if key not in seen:
                seen.add(key)
                out.append((prov, dict(cfg)))

        for _, i in scored:
            prov, cfg = h.points[i]
            push(prov, cfg)
        for prov, cfg in e.domain.all_candidates():
            push(prov, cfg)
        return out

    def _exploit(self, workload: str, e: _Entry, tick: int) -> RouteDecision:
        ranked = self._ranked(e)
        for rank, (prov, cfg) in enumerate(ranked):
            if self._unavailable(prov, cfg, tick) is None:
                kind = "exploit" if rank == 0 else "failover"
                if kind == "failover":
                    e.failovers += 1
                return RouteDecision(workload, prov, cfg, kind, tick)
        # whole market dark: serve best-effort instead of aborting
        prov, cfg = ranked[0]
        return RouteDecision(workload, prov, cfg, "blind", tick)
