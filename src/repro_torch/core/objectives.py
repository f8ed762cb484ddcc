"""Objective registry: every expensive black-box objective as a spec.

The paper's premise is that search methods are generic over an expensive
objective ``f(provider, config)``; this module makes the *objective* as
pluggable as the search method.  Symmetric to the method registry
(:mod:`repro_torch.core.registry`), each objective family registers an
:class:`ObjectiveSpec`:

name
    Registry key; also the ``objective`` field of evaluation-granular
    work-unit content keys (omitted for ``offline`` so every
    pre-registry store replays bit-identically).
evaluate
    A *worker-importable* ``module:qualname`` reference to a callable
    ``(params, context) -> {"value": float, ...}`` — never a closure or
    bound method, so the process/remote executors can resolve it by
    name, exactly like the engine's runner refs (:func:`repro_torch.exp.wire.
    fn_ref`).
domain_factory
    Builds the search :class:`~repro_torch.core.domain.Domain` for one
    concrete parameterization (the offline table's provider grid, the
    autotuner's strategy families for an (arch, shape), ...).
params / defaults / context_params
    The spec's JSON-canonical evaluation parameters.  ``context_params``
    are routed into the *engine context* instead of the unit params —
    ``offline``'s ``dataset_seed`` lives there so eval-unit content keys
    stay exactly what they were before the registry existed.
tags
    Free-form labels (``"table"``, ``"measured"``, ``"compile"``, ...)
    for filtering, mirroring method tags.
family / rung
    The fidelity axis.  Objectives sharing a ``family`` are *rungs of
    one ladder* — cheaper approximations of the same ground truth —
    ordered by integer ``rung`` (0 = cheapest), with exactly one spec
    per family registered at ``rung=None``: the *top rung*, the ground
    truth the ladder approximates.  Reduced-fidelity units carry a
    ``fidelity`` field in their content key; top-rung units (and any
    objective without a family) omit it, so a ladder's real
    measurements share content keys with the flat single-fidelity
    world — every pre-fidelity store replays bit-identically, and a
    multi-fidelity search's top-rung evaluations are cache hits for
    flat methods (and vice versa).

A spec bound to concrete parameters is an :class:`ObjectiveBinding`: it
mints content-keyed eval units, builds the domain, and contributes the
engine context — the one object ``drive_units`` needs to run any search
driver against any objective through the engine (store memoization,
executor fan-out, timeouts, retries).

The builtins registered here form three fidelity ladders plus the
dynamic market objective: ``offline_proxy`` → ``offline`` (noisy probe,
exact table, family ``offline``); ``hlo_cost`` → ``compile_cost`` →
``dryrun`` (analytic roofline estimate, roofline-scored trace on fake
DTensors, and the full ``python -m repro_torch.launch.dryrun``
subprocess — family ``sharding``); ``kernel_analytic`` → ``kernel_time``
(the config spaces of the port's CUDA kernels, :mod:`repro_torch.kernels.
bench`, family ``kernel``, keyed by device); and ``market`` (the offline
table under a dynamic market overlay with structured failures,
:mod:`repro_torch.multicloud.market`).
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

#: domain factory signature: (params dict) -> Domain
DomainFactory = Callable[[Dict[str, Any]], "object"]

#: evaluate signature: (unit params, runner context) -> result dict with
#: at least a "value" float
EvaluateFn = Callable[[Dict[str, Any], Dict[str, Any]], dict]

#: the default objective: bare (workload, target, provider, config) eval
#: units with no ``objective`` field — the pre-registry content keys
DEFAULT_OBJECTIVE = "offline"

_JSON_SCALARS = (str, int, float, bool, type(None))


@dataclasses.dataclass(frozen=True)
class EvalFailure:
    """Structured failure of one objective evaluation — the tell-side
    face of a worker result with a truthy ``failed`` flag (provider
    outage, instance revocation, exhausted engine retry budget).

    Deliberately *not* a float and *not* an exception: drivers receive
    it through ``tell_batch`` and define graceful degradation (penalize,
    pause the arm, ...) instead of crashing or poisoning surrogates with
    NaN/inf sentinels.
    """
    reason: str = ""

    def __bool__(self) -> bool:         # a failure is never a usable value
        return False


def _fn_ref(fn: Any) -> str:
    """``module:qualname`` for a module-level callable (reuses the wire
    protocol's importability rules without importing the exp layer)."""
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if not mod or not qual or "<" in qual or "." in qual:
        raise TypeError(
            f"objective evaluate fn must be a module-level callable "
            f"importable by name, got {fn!r}")
    return f"{mod}:{qual}"


def _resolve_ref(ref: str) -> Any:
    mod_name, _, qual = ref.partition(":")
    obj: Any = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    name: str
    evaluate: str                       # worker-importable module:qualname
    domain_factory: DomainFactory
    params: Tuple[str, ...] = ()
    defaults: Tuple[Tuple[str, Any], ...] = ()
    context_params: Tuple[str, ...] = ()
    tags: Tuple[str, ...] = ()
    #: fidelity ladder membership: None = no ladder (flat objective)
    family: Optional[str] = None
    #: rung within the family; None = the top rung (ground truth) —
    #: the only rung whose units omit the ``fidelity`` key field
    rung: Optional[int] = None
    #: scheduler cost hint (repro_torch.exp.sched): a coarse class name such
    #: as "table"/"analytic"/"compile"/"subprocess"/"measure" that seeds
    #: the cost model's nominal estimate before any timing is observed.
    #: Purely operational — never part of content keys or fingerprints.
    cost_class: Optional[str] = None

    @property
    def is_top_rung(self) -> bool:
        """True for ground truth: either no ladder at all, or the
        family's declared top (``rung=None``).  Only reduced-fidelity
        rungs stamp ``fidelity`` into content keys."""
        return self.family is None or self.rung is None

    def canonical_params(self, overrides: Mapping[str, Any]
                         ) -> Dict[str, Any]:
        """Validate + canonicalize one parameterization: defaults
        applied, unknown names rejected, values restricted to JSON
        scalars (content keys must survive a JSON round-trip bit-for-
        bit; a numpy int or a tuple would hash differently before and
        after the wire)."""
        unknown = sorted(set(overrides) - set(self.params))
        if unknown:
            raise ValueError(
                f"objective {self.name!r} got unknown param(s) "
                f"{unknown}; accepts: {list(self.params)}")
        out = dict(self.defaults)
        out.update(overrides)
        missing = sorted(set(self.params) - set(out))
        if missing:
            raise ValueError(
                f"objective {self.name!r} missing required param(s) "
                f"{missing}")
        for k, v in out.items():
            if not isinstance(v, _JSON_SCALARS):
                raise ValueError(
                    f"objective {self.name!r} param {k}={v!r} is not a "
                    f"JSON scalar (str/int/float/bool/None)")
        return {k: out[k] for k in sorted(out)}

    def bind(self, **params: Any) -> "ObjectiveBinding":
        return ObjectiveBinding(
            self, tuple(sorted(self.canonical_params(params).items())))

    def resolve(self) -> EvaluateFn:
        return _resolve_ref(self.evaluate)

    def run(self, unit_params: Dict[str, Any],
            context: Dict[str, Any]) -> dict:
        """Evaluate one unit worker-side; result must carry "value", or
        a truthy "failed" flag — the structured-failure schema
        (``{"failed": True, "reason": str}``), stored content-keyed like
        any result and replayed warm like any result."""
        result = self.resolve()(unit_params, context)
        if not isinstance(result, dict) or (
                "value" not in result and not result.get("failed")):
            raise TypeError(
                f"objective {self.name!r} evaluate must return a dict "
                f"with a 'value' field or a truthy 'failed' flag, got "
                f"{type(result).__name__}")
        return result


@dataclasses.dataclass(frozen=True)
class ObjectiveBinding:
    """A spec bound to one concrete parameterization — everything the
    driver-runner needs: unit minting, domain, engine context."""
    spec: ObjectiveSpec
    params: Tuple[Tuple[str, Any], ...]     # canonical (name, value) pairs

    def param(self, name: str) -> Any:
        return dict(self.params)[name]

    def unit_params(self) -> Dict[str, Any]:
        """Eval-unit identity params (``context_params`` excluded — they
        ride in the engine context, like ``offline``'s dataset seed
        always has)."""
        return {k: v for k, v in self.params
                if k not in self.spec.context_params}

    def context(self) -> Dict[str, Any]:
        """Code-relevant engine context this binding requires; the
        engine folds it into every unit's content hash."""
        return {k: v for k, v in self.params
                if k in self.spec.context_params}

    def unit(self, provider: str, config: Mapping[str, Any],
             **extra: Any):
        """Content-keyed eval unit for one (provider, config) request.

        The key carries (objective, objective params, provider,
        canonical config) — never the method, seed, or budget that
        requested it, so every search touching the same point shares
        one stored record.  For ``offline`` the ``objective`` field is
        omitted entirely: pre-registry stores replay bit-identically.

        Reduced-fidelity rungs of a ladder additionally carry a
        ``fidelity`` field (the spec's rung); top rungs and
        family-less objectives omit it, so ground-truth measurements
        keep the exact flat-world content keys — pre-fidelity stores
        replay with computed=0 and multi-fidelity searches share
        top-rung records with flat methods.

        ``extra`` adds identity-bearing per-request fields — e.g. the
        market clock's ``tick``, which makes the same point at two
        market states two distinct cached records.
        """
        from repro_torch.exp.engine import WorkUnit
        kw = self.unit_params()
        collide = sorted(set(extra) & (set(kw) | {"provider", "config",
                                                  "objective", "fidelity"}))
        if collide:
            raise ValueError(
                f"unit() extra field(s) {collide} collide with "
                f"{self.describe()} identity params")
        kw.update(extra)
        if self.spec.name != DEFAULT_OBJECTIVE:
            kw["objective"] = self.spec.name
        if not self.spec.is_top_rung:
            kw["fidelity"] = int(self.spec.rung)
        return WorkUnit.make("eval", provider=provider,
                             config=tuple(sorted(config.items())), **kw)

    def make_domain(self):
        return self.spec.domain_factory(dict(self.params))

    def describe(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self.params)
        return f"{self.spec.name}({inner})"


_REGISTRY: Dict[str, ObjectiveSpec] = {}    # insertion order preserved
_builtin_loaded = False


def _ensure_builtin() -> None:
    """Builtins register lazily, gated on a flag (not on registry
    non-emptiness) — an external ``register_objective`` call arriving
    first must not hide or collide with them at a later read site.
    Mirrors :func:`repro_torch.core.registry._ensure_builtin`."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        try:
            _register_builtins()
        except BaseException:
            _builtin_loaded = False
            raise


def register_objective(name: str,
                       evaluate: Optional[Any] = None, *,
                       domain_factory: DomainFactory,
                       params: Tuple[str, ...] = (),
                       defaults: Optional[Mapping[str, Any]] = None,
                       context_params: Tuple[str, ...] = (),
                       tags: Tuple[str, ...] = (),
                       family: Optional[str] = None,
                       rung: Optional[int] = None,
                       cost_class: Optional[str] = None) -> ObjectiveSpec:
    """Register an objective family.

    ``evaluate`` is a ``module:qualname`` string or a module-level
    callable (the ref is derived, same importability contract as the
    remote wire protocol).  Workers resolve the objective by *name*
    from this registry, so a custom objective's defining module must be
    importable worker-side — pass it via the engine's
    ``local_context["objective_modules"]`` for process/remote backends.

    ``family``/``rung`` place the objective on a fidelity ladder:
    ``rung=None`` declares the family's single top rung (ground
    truth); integer rungs are cheaper approximations, keyed with a
    ``fidelity`` field so their records never collide with real
    measurements.  A rung is meaningless without a family, and rung
    slots (including the top) are unique within a family.

    ``cost_class`` is a scheduler hint (see :mod:`repro_torch.exp.sched`):
    objectives sharing a class share one nominal/EWMA cost estimate.
    Omitted, the objective gets a per-name estimate learned from stored
    unit timings.  Operational only — never part of unit identity.
    """
    if callable(evaluate):
        evaluate = _fn_ref(evaluate)
    if not isinstance(evaluate, str) or ":" not in evaluate:
        raise TypeError(
            f"evaluate must be a module:qualname ref or module-level "
            f"callable, got {evaluate!r}")
    bad_ctx = sorted(set(context_params) - set(params))
    if bad_ctx:
        raise ValueError(f"context_params {bad_ctx} not in params")
    if rung is not None and family is None:
        raise ValueError(f"objective {name!r}: rung={rung} without a family")
    if rung is not None and (not isinstance(rung, int) or rung < 0):
        raise ValueError(
            f"objective {name!r}: rung must be a non-negative int or "
            f"None (the top rung), got {rung!r}")
    if family is not None:
        for other in _REGISTRY.values():
            if other.family == family and other.rung == rung:
                slot = "top rung" if rung is None else f"rung {rung}"
                raise ValueError(
                    f"objective {name!r}: family {family!r} already has "
                    f"its {slot} ({other.name!r})")
    if name in _REGISTRY:
        raise ValueError(f"objective {name!r} already registered")
    spec = ObjectiveSpec(
        name=name, evaluate=evaluate, domain_factory=domain_factory,
        params=tuple(params),
        defaults=tuple(sorted((defaults or {}).items())),
        context_params=tuple(context_params), tags=tuple(tags),
        family=family, rung=rung, cost_class=cost_class)
    _REGISTRY[name] = spec
    return spec


def get_objective(name: str) -> ObjectiveSpec:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown objective {name!r}; registered: "
            f"{', '.join(_REGISTRY)}") from None


def bind_objective(name: str, **params: Any) -> ObjectiveBinding:
    return get_objective(name).bind(**params)


def objective_names(tag: Optional[str] = None) -> Tuple[str, ...]:
    _ensure_builtin()
    return tuple(n for n, s in _REGISTRY.items()
                 if tag is None or tag in s.tags)


def objective_specs() -> Tuple[ObjectiveSpec, ...]:
    _ensure_builtin()
    return tuple(_REGISTRY.values())


def fidelity_ladder(family: str) -> Tuple[ObjectiveSpec, ...]:
    """The family's rungs, cheapest first, ground truth (``rung=None``)
    last.  A ladder is only usable once its top rung is registered —
    multi-fidelity search without a ground truth is unanswerable."""
    _ensure_builtin()
    members = [s for s in _REGISTRY.values() if s.family == family]
    if not members:
        raise KeyError(
            f"unknown objective family {family!r}; families: "
            f"{', '.join(sorted({s.family for s in _REGISTRY.values() if s.family}))}")
    members.sort(key=lambda s: (s.rung is None, s.rung or 0))
    if members[-1].rung is not None:
        raise ValueError(
            f"objective family {family!r} has no top rung (rung=None): "
            f"{[s.name for s in members]}")
    if len(members) < 2:
        raise ValueError(
            f"objective family {family!r} is a one-rung ladder "
            f"({members[0].name!r}); register a cheaper rung first")
    return tuple(members)


def objective_families() -> Tuple[str, ...]:
    """Registered fidelity families, in first-registration order."""
    _ensure_builtin()
    seen = []
    for s in _REGISTRY.values():
        if s.family is not None and s.family not in seen:
            seen.append(s.family)
    return tuple(seen)


# ---------------------------------------------------------------------------
# Builtin: offline — the paper's 30×88 lookup table
# ---------------------------------------------------------------------------
def eval_offline(params: Dict[str, Any], context: Dict[str, Any]) -> dict:
    """One table lookup.  Payload and identity are byte-for-byte the
    pre-registry ``eval`` unit's: ``{"value": float}``, keyed by
    (workload, target, provider, config) + the context's dataset seed."""
    from repro_torch.multicloud.dataset import build_dataset
    ds = build_dataset(int(context.get("dataset_seed", 0)))
    task = ds.task(params["workload"], params["target"])
    return {"value": float(task.objective(params["provider"],
                                          dict(params["config"])))}


def _offline_domain(params: Dict[str, Any]):
    from repro_torch.multicloud.providers import multicloud_domain
    return multicloud_domain()


# ---------------------------------------------------------------------------
# Builtin: offline_proxy — the offline table's low-fidelity rung
# ---------------------------------------------------------------------------
def eval_offline_proxy(params: Dict[str, Any],
                       context: Dict[str, Any]) -> dict:
    """Noisy-but-cheap probe of the offline table: the true value under
    deterministic multiplicative lognormal noise, the classic shape of
    a partial-execution estimate (run the workload briefly, extrapolate
    — "Fast and Low-cost Search for Efficient Cloud Configurations for
    HPC Workloads").  The noise draw is keyed by the full point
    identity, so the same probe replays bit-identically everywhere."""
    import hashlib

    import numpy as np

    base = eval_offline(params, context)
    ident = json.dumps([
        int(context.get("dataset_seed", 0)), params["workload"],
        params["target"], params["provider"],
        sorted(tuple(kv) for kv in params["config"])], sort_keys=True)
    digest = hashlib.sha256(ident.encode()).digest()
    rng = np.random.default_rng(
        int.from_bytes(digest[:8], "big", signed=False))
    noise = float(np.exp(float(params["proxy_sigma"]) * rng.standard_normal()))
    return {"value": float(base["value"]) * noise,
            "true_value": base["value"], "noise": noise}


# ---------------------------------------------------------------------------
# Builtin: compile_cost — roofline-scored XLA compile (seconds/eval)
# ---------------------------------------------------------------------------
def _sharding_domain(params: Dict[str, Any]):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.tuner.strategies import sharding_domain
    return sharding_domain(get_config(params["arch"]),
                           get_shape(params["shape"]))


def _kernel_domain(params: Dict[str, Any]):
    from repro_torch.kernels.bench import kernel_domain
    return kernel_domain(params["preset"])


# ---------------------------------------------------------------------------
# Builtin: dryrun — a full traced cell via the subprocess entry point
# (each cell lays its mesh on a process-wide fake process group of 512
# ranks, so it runs in a process of its own)
# ---------------------------------------------------------------------------
#: the ModelOpts knobs the dryrun CLI accepts; anything else in a config
#: would be silently dropped, so it is rejected instead
_DRYRUN_KNOBS = ("attn_chunk", "ce_chunk", "remat", "banded_local")


def dryrun_command(params: Dict[str, Any], out_path: str) -> list:
    """Pure command construction for one dryrun evaluation (split out so
    the mapping is testable without paying a compile)."""
    config = dict(params["config"])
    unknown = sorted(set(config) - set(_DRYRUN_KNOBS))
    if unknown:
        raise ValueError(
            f"dryrun objective got unknown config knob(s) {unknown}; "
            f"accepts: {list(_DRYRUN_KNOBS)}")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", params["arch"], "--shape", params["shape"],
           "--strategy", params["provider"], "--out", out_path]
    if params.get("mesh", "pod") == "multipod":
        cmd.append("--multi-pod")
    if "attn_chunk" in config:
        cmd += ["--attn-chunk", str(int(config["attn_chunk"]))]
    if "ce_chunk" in config:
        cmd += ["--ce-chunk", str(int(config["ce_chunk"]))]
    if "remat" in config:
        cmd += ["--remat", str(config["remat"])]
    if config.get("banded_local"):
        cmd.append("--banded-local")
    return cmd


def eval_dryrun(params: Dict[str, Any], context: Dict[str, Any]) -> dict:
    """Trace one (strategy, config) cell in a subprocess and score it by
    roofline step time — the most expensive fidelity."""
    from repro_torch.exp.runners import subprocess_timeout
    out_dir = context.get("out_dir") or os.path.join("results", "dryrun_evals")
    os.makedirs(out_dir, exist_ok=True)
    cfg_tag = "_".join(
        f"{k}-{v}" for k, v in sorted(dict(params["config"]).items()))
    tag = ".".join([params["arch"], params["shape"],
                    params.get("mesh", "pod"), params["provider"],
                    cfg_tag or "default"])
    out = os.path.join(out_dir, tag + ".json")
    cmd = dryrun_command(params, out)
    env = dict(os.environ)
    env["PYTHONPATH"] = context.get("src_path", "src")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=subprocess_timeout(context), env=env)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dryrun eval {tag}: timeout")
    if r.returncode != 0:
        raise RuntimeError(
            f"dryrun eval {tag}: exit {r.returncode}: {r.stderr[-2000:]}")
    with open(out) as f:
        report = json.load(f)
    if "skipped" in report:
        raise RuntimeError(f"dryrun eval {tag}: skipped cell "
                           f"({report['skipped']})")
    return {"value": float(report["t_step"]), "report": report}


def _register_builtins() -> None:
    # the "offline" ladder: cheap noisy probe -> exact table lookup.
    # The top rung is the pre-registry objective, byte-identical keys.
    register_objective(
        "offline", "repro_torch.core.objectives:eval_offline",
        domain_factory=_offline_domain,
        params=("workload", "target", "dataset_seed"),
        defaults={"dataset_seed": 0},
        context_params=("dataset_seed",),
        tags=("table", "paper"),
        family="offline", rung=None, cost_class="table")
    # the "sharding" ladder: analytic roofline estimate (~free) ->
    # roofline-scored XLA compile (seconds) -> full dryrun (minutes)
    register_objective(
        "compile_cost", "repro_torch.tuner.objective:eval_compile_cost",
        domain_factory=_sharding_domain,
        params=("arch", "shape", "mesh"),
        defaults={"mesh": "pod"},
        tags=("measured", "compile", "roofline"),
        family="sharding", rung=1, cost_class="compile")
    register_objective(
        "dryrun", "repro_torch.core.objectives:eval_dryrun",
        domain_factory=_sharding_domain,
        params=("arch", "shape", "mesh"),
        defaults={"mesh": "pod"},
        tags=("measured", "compile", "subprocess"),
        family="sharding", rung=None, cost_class="subprocess")
    # the offline table seen through a moving market: per-request units
    # additionally carry the clock tick (see MarketOverlay / drive_units'
    # clock hook), and an outage/revocation returns the structured
    # failed-result schema instead of a value
    register_objective(
        "market", "repro_torch.multicloud.market:eval_market",
        domain_factory=_offline_domain,
        params=("workload", "target", "dataset_seed", "market_seed",
                "horizon", "walk_sigma", "schedule"),
        defaults={"dataset_seed": 0, "market_seed": 0, "horizon": 64,
                  "walk_sigma": 0.0, "schedule": ""},
        context_params=("dataset_seed",),
        tags=("dynamic", "market"), cost_class="table")
    register_objective(
        "hlo_cost", "repro_torch.tuner.objective:eval_sharding_analytic",
        domain_factory=_sharding_domain,
        params=("arch", "shape", "mesh"),
        defaults={"mesh": "pod"},
        tags=("analytic", "roofline"),
        family="sharding", rung=0, cost_class="analytic")
    register_objective(
        "offline_proxy", "repro_torch.core.objectives:eval_offline_proxy",
        domain_factory=_offline_domain,
        params=("workload", "target", "dataset_seed", "proxy_sigma"),
        defaults={"dataset_seed": 0, "proxy_sigma": 0.25},
        context_params=("dataset_seed",),
        tags=("proxy", "paper"),
        family="offline", rung=0, cost_class="table")
    # the "kernel" ladder: analytic traffic/grid model -> measured
    # time of the port's kernels (repro_torch.kernels.bench).  ``device``
    # is part of every unit's identity, so a store never replays a CPU
    # timing on the card, or the reverse, nor a reference unit here
    register_objective(
        "kernel_analytic", "repro_torch.kernels.bench:eval_kernel_analytic",
        domain_factory=_kernel_domain,
        params=("preset", "device"),
        defaults={"preset": "small", "device": "cuda"},
        tags=("analytic", "kernel"),
        family="kernel", rung=0, cost_class="analytic")
    register_objective(
        "kernel_time", "repro_torch.kernels.bench:eval_kernel_time",
        domain_factory=_kernel_domain,
        params=("preset", "reps", "device"),
        defaults={"preset": "small", "reps": 5, "device": "cuda"},
        tags=("timing", "kernel"),
        family="kernel", rung=None, cost_class="measure")
