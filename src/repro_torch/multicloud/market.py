"""Dynamic-market overlay: the offline table through a hostile cloud.

The paper's protocol replays a frozen world; production clouds drift.
:class:`MarketOverlay` composes over the offline performance model a
seeded, deterministic time axis — per-provider geometric price walks,
scheduled price steps, runtime degradations, transient provider outages
and instance-type revocations — without touching the model itself.
Time advances one *tick* per ask round through the clock hook in
:func:`repro_torch.exp.runners.drive_units`, so no search internals change.

The event schedule reuses the :class:`repro_torch.runtime.fault.
FailureInjector` idiom — a deterministic, declarative spec string,
comma-separated events::

    outage:<provider>:<start>:<end>          provider down for [start, end)
    revoke:<provider>:<key>=<value>:<start>:<end>
                                             configs with key==value revoked
    step:<provider>:<factor>:<start>         price multiplier from start on
    slow:<provider>:<factor>:<start>:<end>   runtime degraded for [start, end)

Evaluating an unavailable point returns the structured failed-result
schema ``{"failed": True, "reason": ...}`` (see
:meth:`repro_torch.core.objectives.ObjectiveSpec.run`) — never ``inf``, never
an exception — which the engine stores content-keyed like any result
and drivers absorb as :class:`~repro_torch.core.objectives.EvalFailure`.

Determinism: every random draw derives from ``SeedSequence([seed,
_stable_hash(...)])`` exactly like the performance model's affinities,
so trajectories are bit-identical across processes, executors, and
store replays for a fixed (seed, horizon, walk_sigma, schedule).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.multicloud.perfmodel import _stable_hash

_EVENT_KINDS = ("outage", "revoke", "step", "slow")


@dataclasses.dataclass(frozen=True)
class MarketEvent:
    """One scheduled market event, half-open over ticks [start, end)."""
    kind: str                           # outage | revoke | step | slow
    provider: str
    start: int
    end: int                            # step events: end = infinity
    factor: float = 1.0                 # step/slow multiplier
    key: str = ""                       # revoke: config key ...
    value: str = ""                     # ... and string-compared value

    def active(self, tick: int) -> bool:
        return self.start <= tick < self.end


def parse_schedule(spec: str) -> Tuple[MarketEvent, ...]:
    """Parse a schedule spec string (see module docstring) into events.
    Deterministic, order-preserving; raises ``ValueError`` on malformed
    entries — a silently dropped event would fake robustness."""
    events: List[MarketEvent] = []
    for raw in (spec or "").split(","):
        item = raw.strip()
        if not item:
            continue
        parts = item.split(":")
        kind = parts[0]
        try:
            if kind == "outage" and len(parts) == 4:
                events.append(MarketEvent(
                    kind, parts[1], int(parts[2]), int(parts[3])))
            elif kind == "revoke" and len(parts) == 5:
                key, _, value = parts[2].partition("=")
                if not key or not value:
                    raise ValueError("revoke needs key=value")
                events.append(MarketEvent(
                    kind, parts[1], int(parts[3]), int(parts[4]),
                    key=key, value=value))
            elif kind == "step" and len(parts) == 4:
                events.append(MarketEvent(
                    kind, parts[1], int(parts[3]), np.iinfo(np.int64).max,
                    factor=float(parts[2])))
            elif kind == "slow" and len(parts) == 5:
                events.append(MarketEvent(
                    kind, parts[1], int(parts[3]), int(parts[4]),
                    factor=float(parts[2])))
            else:
                raise ValueError(
                    f"unknown kind {kind!r}" if kind not in _EVENT_KINDS
                    else "wrong field count")
        except ValueError as exc:
            raise ValueError(
                f"malformed market event {item!r}: {exc}") from None
        ev = events[-1]
        if ev.start < 0 or ev.end <= ev.start:
            raise ValueError(f"malformed market event {item!r}: empty or "
                             f"negative tick range")
        if ev.kind in ("step", "slow") and ev.factor <= 0:
            raise ValueError(f"malformed market event {item!r}: factor "
                             f"must be > 0")
    return tuple(events)


class MarketOverlay:
    """Seeded, deterministic market trajectory over the offline model.

    The overlay never mutates or re-queries the performance model: it
    maps a *base* objective value (the frozen table's) plus a tick to
    the current market value, and answers availability questions.  Ticks
    at or past ``horizon`` see the final tick's market (frozen), so a
    search that outlives the schedule still terminates meaningfully.
    """

    def __init__(self, seed: int = 0, horizon: int = 64,
                 walk_sigma: float = 0.0, schedule: str = ""):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self.seed = int(seed)
        self.horizon = int(horizon)
        self.walk_sigma = float(walk_sigma)
        self.schedule = schedule or ""
        self.events = parse_schedule(self.schedule)
        self._walks: Dict[str, np.ndarray] = {}

    # -- time ----------------------------------------------------------
    def _clamp(self, tick: int) -> int:
        if tick < 0:
            raise ValueError(f"tick must be >= 0, got {tick}")
        return min(int(tick), self.horizon - 1)

    # -- price walks ---------------------------------------------------
    def walk(self, provider: str) -> np.ndarray:
        """Per-tick multiplicative price-walk factors for one provider,
        length ``horizon``, starting at exactly 1.0 (tick 0 matches the
        frozen table).  Seeded per provider — identical no matter which
        process or call order materializes it."""
        w = self._walks.get(provider)
        if w is None:
            if self.walk_sigma <= 0:
                w = np.ones(self.horizon)
            else:
                rng = np.random.default_rng(np.random.SeedSequence(
                    [self.seed, _stable_hash(("market-walk", provider))]))
                inc = rng.normal(0.0, self.walk_sigma, self.horizon - 1)
                w = np.concatenate([[1.0], np.exp(np.cumsum(inc))])
            self._walks[provider] = w
        return w

    # -- event queries -------------------------------------------------
    def price_factor(self, tick: int, provider: str) -> float:
        t = self._clamp(tick)
        f = float(self.walk(provider)[t])
        for ev in self.events:
            if ev.kind == "step" and ev.provider == provider \
                    and ev.active(t):
                f *= ev.factor
        return f

    def slow_factor(self, tick: int, provider: str) -> float:
        t = self._clamp(tick)
        f = 1.0
        for ev in self.events:
            if ev.kind == "slow" and ev.provider == provider \
                    and ev.active(t):
                f *= ev.factor
        return f

    def unavailable_reason(self, tick: int, provider: str,
                           config: Optional[Mapping[str, Any]] = None
                           ) -> Optional[str]:
        """Why (provider, config) cannot be deployed at ``tick``, or
        ``None`` when it can.  Revocations compare config values as
        strings so JSON-round-tripped configs match their spec."""
        t = self._clamp(tick)
        for ev in self.events:
            if ev.provider != provider or not ev.active(t):
                continue
            if ev.kind == "outage":
                return f"provider {provider} outage [{ev.start},{ev.end})"
            if ev.kind == "revoke" and config is not None \
                    and str(config.get(ev.key)) == ev.value:
                return (f"instance type {ev.key}={ev.value} revoked on "
                        f"{provider} [{ev.start},{ev.end})")
        return None

    def available(self, tick: int, provider: str,
                  config: Optional[Mapping[str, Any]] = None) -> bool:
        return self.unavailable_reason(tick, provider, config) is None

    # -- valuation -----------------------------------------------------
    def value(self, tick: int, base: float, provider: str,
              target: str) -> float:
        """Current market value of a point whose frozen-table value is
        ``base``.  Degradations (``slow``) scale runtime and therefore
        both targets; price movements (walk + ``step``) scale cost
        only."""
        f = self.slow_factor(tick, provider)
        if target == "cost":
            f *= self.price_factor(tick, provider)
        return float(base * f)

    # -- ground truth for regret ---------------------------------------
    def grid_values(self, tick: int, base_table: Mapping[Tuple[str, tuple],
                                                         float],
                    target: str) -> Dict[Tuple[str, tuple], float]:
        """Current values of every *available* point of a frozen base
        table ``{(provider, canonical config tuple): base value}`` —
        the instantaneous ground truth fig5's dynamic regret is scored
        against."""
        out = {}
        for (prov, cfg), base in base_table.items():
            if self.available(tick, prov, dict(cfg)):
                out[(prov, cfg)] = self.value(tick, base, prov, target)
        return out

    def instant_optimum(self, tick, base_table, target) -> Optional[float]:
        vals = self.grid_values(tick, base_table, target)
        return min(vals.values()) if vals else None

    def instant_worst(self, tick, base_table, target) -> Optional[float]:
        vals = self.grid_values(tick, base_table, target)
        return max(vals.values()) if vals else None


@functools.lru_cache(maxsize=64)
def get_overlay(seed: int = 0, horizon: int = 64, walk_sigma: float = 0.0,
                schedule: str = "") -> MarketOverlay:
    """Memoized overlay per (seed, horizon, walk_sigma, schedule) — the
    worker-side cache, mirroring ``build_dataset``: each process pays
    schedule parsing and walk generation at most once per market."""
    return MarketOverlay(seed=seed, horizon=horizon, walk_sigma=walk_sigma,
                         schedule=schedule)


# ---------------------------------------------------------------------------
# The `market` objective: worker-importable evaluate fn
# ---------------------------------------------------------------------------
def eval_market(params: Dict[str, Any], context: Dict[str, Any]) -> dict:
    """One offline-table lookup seen through the market at the unit's
    ``tick``.  Unavailable points return the structured failed-result
    schema — stored content-keyed, replayed warm, and turned into
    :class:`~repro_torch.core.objectives.EvalFailure` tells by
    :func:`repro_torch.exp.runners.drive_units`."""
    from repro_torch.multicloud.dataset import build_dataset
    overlay = get_overlay(int(params["market_seed"]),
                          int(params["horizon"]),
                          float(params["walk_sigma"]),
                          str(params["schedule"] or ""))
    tick = int(params.get("tick", 0))
    provider = params["provider"]
    config = dict(params["config"])
    reason = overlay.unavailable_reason(tick, provider, config)
    if reason is not None:
        return {"failed": True, "reason": f"tick {tick}: {reason}"}
    ds = build_dataset(int(context.get("dataset_seed", 0)))
    task = ds.task(params["workload"], params["target"])
    base = float(task.objective(provider, config))
    return {"value": overlay.value(tick, base, provider, params["target"])}


# ---------------------------------------------------------------------------
# Clock + per-tick unit minting for drive_units
# ---------------------------------------------------------------------------
class MarketClock:
    """The time source a dynamic-market run shares between its binding
    and :func:`repro_torch.exp.runners.drive_units`: the runner advances it
    once per ask round, the binding stamps the current tick into every
    minted unit."""

    def __init__(self, tick: int = 0):
        self.tick = int(tick)

    def advance(self) -> int:
        self.tick += 1
        return self.tick


class TickedBinding:
    """An :class:`~repro_torch.core.objectives.ObjectiveBinding` wrapper that
    stamps a :class:`MarketClock`'s current tick into every eval unit —
    the same point at two market states becomes two distinct
    content-keyed records, so warm replays of a drift run stay exact."""

    def __init__(self, binding, clock: MarketClock):
        self.binding = binding
        self.clock = clock

    def unit(self, provider: str, config: Mapping[str, Any]):
        return self.binding.unit(provider, config, tick=self.clock.tick)

    def context(self) -> Dict[str, Any]:
        return self.binding.context()

    def make_domain(self):
        return self.binding.make_domain()

    def param(self, name: str) -> Any:
        return self.binding.param(name)

    def describe(self) -> str:
        return f"{self.binding.describe()}@tick={self.clock.tick}"
