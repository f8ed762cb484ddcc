"""Sharding autotuner: registered search methods over registered objectives
(copy of ``repro/tuner/autotune.py`` without its ``__main__`` header, which
sets XLA's host device count: ``repro_torch.launch.mesh`` makes the fake
process group the port's meshes live on).

The paper's algorithm, applied to the framework itself: arms = strategy
families, pulls = compiles, objective = roofline step time.  The closed
loop runs through the registry/driver/engine stack
(:func:`repro_torch.exp.runners.drive_units`): the search method comes from the
method registry, the objective from the objective registry
(:mod:`repro_torch.core.objectives`), every evaluation is a content-keyed work
unit memoized in the result store (crash-resume, warm re-runs report
``computed=0``), and a CloudBandit round's batched arm pulls fan out
concurrently through whatever executor backend the engine is wired with
(``--executor thread``/``process``/``remote``).

:func:`autotune_reference` retains the pre-engine inline loop verbatim as
the bit-identity ground truth, the same pattern as
``repro_torch.core.evaluate.run_search_reference``.

CLI:
    PYTHONPATH=src python -m repro_torch.tuner.autotune --arch qwen1.5-4b \
        --shape train_4k [--budget 11] [--driver cb_rbfopt] [--multi-pod] \
        [--objective compile_cost] [--executor thread --workers 4] \
        [--store results/expstore/autotune.jsonl]
"""
import argparse      # noqa: E402
import json          # noqa: E402
import sys           # noqa: E402
from typing import Any, Optional, Tuple     # noqa: E402

from repro_torch.core.cloudbandit import total_budget           # noqa: E402
from repro_torch.core.objectives import ObjectiveBinding, bind_objective  # noqa: E402
from repro_torch.core.registry import get_method                # noqa: E402

#: the driver trio the paper benchmarks (any registered search method
#: works; these are the CLI-documented ones)
DRIVERS = ("cb_rbfopt", "cb_cherrypick", "smac", "random")


# ---------------------------------------------------------------------------
# Reference: the pre-engine inline closed loop, retained verbatim
# ---------------------------------------------------------------------------
def autotune_reference(domain, objective, *, budget: int = 11,
                       driver: str = "cb_rbfopt", seed: int = 0
                       ) -> Tuple[str, dict, float, Any]:
    """Bit-identity ground truth for :func:`autotune_search`: the legacy
    if/elif dispatch calling ``objective(provider, config)`` inline.
    Returns ``(best_provider, best_config, best_value, history)``."""
    from repro_torch.core.cloudbandit import CloudBandit, b1_for_budget
    from repro_torch.core.optimizers import (
        RBFOpt, SMACLike, RandomSearch, cherrypick)

    if driver.startswith("cb_"):
        factory = RBFOpt if driver == "cb_rbfopt" else cherrypick
        try:
            b1 = b1_for_budget(budget, len(domain.provider_names))
        except ValueError:
            b1 = 1        # clamp to CB's minimum schedule for K arms
        cb = CloudBandit(domain, factory, b1=b1, seed=seed)
        res = cb.run(objective)
        return res.provider, res.config, res.loss, res.history
    cls = {"smac": SMACLike, "random": RandomSearch}[driver]
    cands = domain.all_candidates()
    enc = domain.flat_encoder()
    opt = cls(cands, enc.encode, seed=seed)
    history = opt.run(lambda p: objective(p[0], p[1]), budget)
    (best_provider, best_config), best_value = opt.best()
    return best_provider, best_config, best_value, history


# ---------------------------------------------------------------------------
# Engine path: registry driver + drive_units
# ---------------------------------------------------------------------------
def make_tuner_driver(name: str, domain, budget: int, seed: int):
    """Build the method's driver, clamping budget-coupled schedules to
    their K-arm minimum (``b1=1``) when the requested budget is below it
    — exactly the legacy autotuner's ``b1 = 1`` fallback, expressed as
    the equivalent minimum total budget."""
    spec = get_method(name)
    try:
        return spec.make_driver(domain, budget, seed)
    except ValueError:
        if not spec.budget_coupled:
            raise
        minimum = total_budget(len(domain.provider_names), 1)
        return spec.make_driver(domain, minimum, seed)


def driver_best(drv) -> Tuple[str, dict, float]:
    """Best ``(provider, config, value)`` from a completed driver, by
    the same rule each reference loop used: bandit drivers report their
    surviving arm's incumbent, flat drivers their optimizer's argmin."""
    res = getattr(drv, "result", None)
    if res is not None:
        out = res()
        if hasattr(out, "provider"):            # CloudBanditResult
            return out.provider, out.config, float(out.loss)
        prov, cfg, loss, _hist = out            # RisingBandits tuple
        return prov, cfg, float(loss)
    opt = getattr(drv, "opt", None)
    if opt is not None:                         # FlatDriver
        (prov, cfg), val = opt.best()
        return prov, cfg, float(val)
    (prov, cfg), val = drv.history.best()       # generic fallback
    return prov, cfg, float(val)


def autotune_search(binding: ObjectiveBinding, *, budget: int = 11,
                    driver: str = "cb_rbfopt", seed: int = 0,
                    engine=None) -> dict:
    """Run one autotune cell — any registered method over any registered
    objective — through the engine.

    The driver's ask batches are dispatched as content-keyed ``eval``
    units: identical evaluations replay from the engine's store
    (``CompileCostObjective``'s private cache is gone — the store *is*
    the memoizer, and it persists across runs and methods), and each
    batch fans out concurrently through the engine's executor backend.
    The resulting history is bit-identical to
    :func:`autotune_reference` for the same (domain, budget, driver,
    seed) — driver state machines are deterministic and tells replay in
    request order.
    """
    from repro_torch.exp.protocols import experiment_engine
    from repro_torch.exp.runners import drive_units

    domain = binding.make_domain()
    drv = make_tuner_driver(driver, domain, budget, seed)
    owns_engine = engine is None
    if owns_engine:
        engine = experiment_engine(binding)
    try:
        (history,) = drive_units(engine, [(drv, binding)])
        best_provider, best_config, best_value = driver_best(drv)
        # the winning unit was already evaluated this run, so the
        # report re-read is a store hit — never a recompute
        best_payload = engine.run(
            [binding.unit(best_provider, best_config)])[0]
    finally:
        if owns_engine:
            engine.close()
    return {
        "objective": binding.spec.name,
        "objective_params": dict(binding.params),
        "driver": driver, "budget": budget, "seed": seed,
        "best_provider": best_provider, "best_config": best_config,
        "best_value": float(best_value),
        "best_report": (best_payload or {}).get("report"),
        "n_evals": len(history),
        "history": [
            {"provider": p[0], "config": p[1], "value": v}
            for p, v in zip(history.points, history.values)
        ],
    }


# ---------------------------------------------------------------------------
# Compile-cost convenience wrapper (the legacy entry point's shape)
# ---------------------------------------------------------------------------
def _mesh_name(mesh) -> str:
    if mesh is None:
        return "pod"
    if isinstance(mesh, str):
        return mesh
    # a concrete Mesh: the production multi-pod mesh carries a "pod" axis
    return "multipod" if "pod" in getattr(mesh, "shape", {}) else "pod"


def autotune(cfg, shape, mesh=None, *, budget: int = 11,
             driver: str = "cb_rbfopt", seed: int = 0,
             engine=None) -> dict:
    """Autotune the sharding of one (arch, shape) cell on the production
    mesh, returning the legacy result shape (``best_strategy`` /
    ``best_t_step`` / per-eval ``history`` rows) consumed by
    ``scripts/render_experiments.py``.

    ``cfg``/``shape`` are registry names or their config objects (the
    objective is re-resolved *by name* worker-side, so ad-hoc reduced
    configs need their own registered objective — see
    ``examples/autotune_mesh.py``); ``mesh`` is ``"pod"`` (default),
    ``"multipod"``, or a production mesh object.
    """
    arch = getattr(cfg, "name", cfg)
    shape_name = getattr(shape, "name", shape)
    binding = bind_objective("compile_cost", arch=arch, shape=shape_name,
                             mesh=_mesh_name(mesh))
    res = autotune_search(binding, budget=budget, driver=driver,
                          seed=seed, engine=engine)
    return {
        "arch": arch, "shape": shape_name, "driver": driver,
        "budget": budget,
        "best_strategy": res["best_provider"],
        "best_config": res["best_config"],
        "best_t_step": res["best_value"],
        "best_report": res["best_report"],
        "n_evals": res["n_evals"],
        "history": [
            {"strategy": h["provider"], "config": h["config"],
             "t": h["value"]}
            for h in res["history"]
        ],
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def _binding_from_args(args) -> ObjectiveBinding:
    if args.objective == "offline":
        if not args.workload or not args.target:
            raise SystemExit(
                "--objective offline requires --workload and --target")
        return bind_objective("offline", workload=args.workload,
                              target=args.target,
                              dataset_seed=args.dataset_seed)
    if not args.arch or not args.shape:
        raise SystemExit(
            f"--objective {args.objective} requires --arch and --shape")
    return bind_objective(args.objective, arch=args.arch, shape=args.shape,
                          mesh="multipod" if args.multi_pod else "pod")


def main() -> None:
    from repro_torch.core.objectives import objective_names
    from repro_torch.exp import add_engine_args, engine_from_args

    ap = argparse.ArgumentParser(
        description="Autotune one cell: any registered search method "
                    "over any registered objective, through the "
                    "experiment engine (memoized store, pluggable "
                    "executor, crash-resume).")
    ap.add_argument("--objective", default="compile_cost",
                    choices=objective_names())
    ap.add_argument("--arch", default=None,
                    help="arch name (compile_cost/dryrun objectives)")
    ap.add_argument("--shape", default=None,
                    help="shape name (compile_cost/dryrun objectives)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--workload", default=None,
                    help="workload 'task@dataset' (offline objective)")
    ap.add_argument("--target", default=None,
                    choices=(None, "cost", "time"),
                    help="optimization target (offline objective)")
    ap.add_argument("--dataset-seed", type=int, default=0)
    ap.add_argument("--budget", type=int, default=11)
    ap.add_argument("--driver", default="cb_rbfopt",
                    help=f"registered search method (e.g. "
                         f"{', '.join(DRIVERS)})")
    ap.add_argument("--seed", type=int, default=0)
    add_engine_args(ap)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    binding = _binding_from_args(args)
    engine = engine_from_args(args, binding)
    with engine:
        result = autotune_search(binding, budget=args.budget,
                                 driver=args.driver, seed=args.seed,
                                 engine=engine)
        lt = engine.lifetime
    # the machine-checkable resume line (same shape as the figure
    # benchmarks'): a warm store replays every evaluation => computed=0
    print(f"[exp] autotune: units={lt.total} unique={lt.unique} "
          f"cached={lt.cached} computed={lt.computed} failed={lt.failed} "
          f"failures={len(lt.failures)} retried={lt.retried} "
          f"speculated={lt.speculated} spec_hits={lt.spec_hits} "
          f"spec_wasted={lt.spec_wasted}",
          file=sys.stderr, flush=True)
    print(json.dumps({k: v for k, v in result.items() if k != "history"},
                     indent=2, default=str))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, default=str)


if __name__ == "__main__":
    main()
