"""Method registry: one place that knows every search method.

Each of the paper's search methods registers a :class:`MethodSpec` whose
``driver_factory`` builds a suspendable :class:`~repro_torch.core.drivers.
SearchDriver` for a concrete ``(domain, budget, seed, target)`` cell.
Everything that used to hard-code method lists — ``run_search``'s
if/elif chain, the ``SEARCH_METHODS`` tuple in ``repro_torch.core.evaluate``,
the ``BUDGET_COUPLED`` literal in ``repro_torch.exp.protocols``, the figure
benchmarks, the CLIs — introspects this registry instead, so adding a
method is one ``register_method`` call.

``budget_coupled`` marks methods whose evaluation trajectory depends on
the *total* budget (successive-halving style schedules): the experiment
protocols run those once per (seed, budget) instead of reading one
max-budget curve.  ``tags`` are free-form labels (``"flat"``,
``"bandit"``, ``"sota"``, …) for filtering.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

#: driver factory signature: (domain, budget, seed, target) -> SearchDriver
DriverFactory = Callable[..., "object"]


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    name: str
    driver_factory: DriverFactory
    budget_coupled: bool = False
    tags: Tuple[str, ...] = ()

    def make_driver(self, domain, budget: int, seed: int,
                    target: str = "cost"):
        """Build a fresh suspendable driver for one search cell."""
        return self.driver_factory(domain=domain, budget=int(budget),
                                   seed=int(seed), target=target)


_REGISTRY: Dict[str, MethodSpec] = {}       # insertion order = paper order
_builtin_loaded = False


def _ensure_builtin() -> None:
    """The built-in methods register when :mod:`repro_torch.core.drivers` is
    imported; trigger that lazily so registry consumers never depend on
    import order.  Gated on a flag, not on the registry being non-empty:
    an external ``register_method`` call arriving first must not hide
    (or collide with) the builtins at some arbitrary later read site."""
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        try:
            import repro_torch.core.drivers  # noqa: F401 — registration side effect
        except BaseException:
            _builtin_loaded = False
            raise


def register_method(name: str, driver_factory: Optional[DriverFactory] = None,
                    *, budget_coupled: bool = False,
                    tags: Tuple[str, ...] = ()) -> Callable:
    """Register a search method; usable directly or as a decorator.

    The factory is called as ``factory(domain=..., budget=..., seed=...,
    target=...)`` and must return a driver whose replayed tells are
    bit-identical to the method's reference inline loop.
    """
    def _register(factory: DriverFactory) -> DriverFactory:
        if name in _REGISTRY:
            raise ValueError(f"method {name!r} already registered")
        _REGISTRY[name] = MethodSpec(name, factory, bool(budget_coupled),
                                     tuple(tags))
        return factory
    if driver_factory is None:
        return _register
    return _register(driver_factory)


def get_method(name: str) -> MethodSpec:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown search method {name!r}; registered: "
            f"{', '.join(_REGISTRY)}") from None


def method_names(tag: Optional[str] = None) -> Tuple[str, ...]:
    """Registered method names in registration (paper) order, optionally
    filtered by tag."""
    _ensure_builtin()
    return tuple(n for n, s in _REGISTRY.items()
                 if tag is None or tag in s.tags)


def method_specs() -> Tuple[MethodSpec, ...]:
    _ensure_builtin()
    return tuple(_REGISTRY.values())


def is_budget_coupled(name: str) -> bool:
    return get_method(name).budget_coupled


class _BudgetCoupledView:
    """Live set-like view of the budget-coupled method names.

    Kept as the ``BUDGET_COUPLED`` module constant for backward
    compatibility: unlike the frozenset literal it replaces, it can
    never go stale when a method is registered later.
    """

    def __contains__(self, name: object) -> bool:
        _ensure_builtin()
        spec = _REGISTRY.get(name)  # type: ignore[arg-type]
        return spec.budget_coupled if spec is not None else False

    def __iter__(self) -> Iterator[str]:
        _ensure_builtin()
        return iter(n for n, s in _REGISTRY.items() if s.budget_coupled)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __repr__(self) -> str:
        return f"BUDGET_COUPLED{{{', '.join(self)}}}"


BUDGET_COUPLED = _BudgetCoupledView()
