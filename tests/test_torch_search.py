"""Parity of the port's search stack (``repro_torch.core``) with the
reference's (``repro.core``): the method and objective registries, every
registered method's search on the offline table, CloudBandit's arm
eliminations, and the multi-fidelity drivers on the offline ladder.
Both packages run the same numpy code on the same machine, so everything
here is held to exact equality.  The copies themselves are held to their
sources: they differ only in the import root."""
import functools
import importlib
import importlib.util
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF_SRC = ROOT / "src" / "repro"
PORT_SRC = ROOT / "src" / "repro_torch"

#: the reference's registered methods, in registration order
METHODS = ("random", "cd", "exhaustive", "cherrypick_x1", "cherrypick_x3",
           "bilal_x1", "bilal_x3", "smac", "hyperopt", "rb", "cb_cherrypick",
           "cb_rbfopt", "cb_drift", "rb_drift", "mf_sh", "mf_prefilter")
MULTI_FIDELITY = ("mf_sh", "mf_prefilter")
#: the ``sharding`` ladder, which the port registers once it has
#: ``tuner/`` and ``launch/dryrun``
SHARDING = ("compile_cost", "dryrun", "hlo_cost")
TASKS = (("xgboost@santander", "cost"), ("kmeans@buzz", "time"))
BUDGET = 11

#: modules of the port that differ from their source in more than the
#: import root; their differences are held by behaviour (the objective
#: registry here, the fork guard in tests/test_torch_exp.py)
EDITED = ("core/objectives.py", "exp/executors.py")
COPIED = sorted(
    str(p.relative_to(REF_SRC)) for sub in ("core", "exp", "multicloud")
    for p in (REF_SRC / sub).rglob("*.py")
    if str(p.relative_to(REF_SRC)) not in EDITED + ("core/__init__.py",))


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """``chip_smoke.py``, for the pick rule its search phase logs."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        registry=mod("core.registry"), objectives=mod("core.objectives"),
        fidelity=mod("core.fidelity"), drivers=mod("core.drivers"),
        cloudbandit=mod("core.cloudbandit"),
        optimizers=mod("core.optimizers"), evaluate=mod("core.evaluate"),
        exp=mod("exp"), runners=mod("exp.runners"),
        multicloud=mod("multicloud"))


@pytest.fixture(scope="module")
def pkgs():
    return {"port": _pkg("repro_torch"), "ref": _pkg("repro")}


def _body(text):
    """The source past its module docstring (which may name its source)."""
    return re.sub(r'^"""[\s\S]*?"""\n', "", text, count=1)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_differs_only_in_the_import_root(rel):
    port = (PORT_SRC / rel).read_text()
    assert "repro." not in re.sub(r"repro_torch\.", "", port), rel
    assert _body(port.replace("repro_torch.", "repro.")) == _body(
        (REF_SRC / rel).read_text())


def _own_methods(pkg, root, tag=None):
    """The methods a package registers itself: test modules of the
    reference register theirs beside them when they are imported."""
    return tuple(
        n for n in pkg.registry.method_names(tag=tag)
        if pkg.registry.get_method(n).driver_factory.__module__.startswith(
            root + "."))


def _own_objectives(pkg, root):
    return tuple(n for n in pkg.objectives.objective_names()
                 if pkg.objectives.get_objective(n).evaluate.startswith(
                     root + "."))


def test_method_names_equal_reference(pkgs):
    port = pkgs["port"].registry.method_names()
    assert port == _own_methods(pkgs["ref"], "repro") == METHODS
    for tag in ("search", "bandit", "flat"):
        assert (pkgs["port"].registry.method_names(tag=tag)
                == _own_methods(pkgs["ref"], "repro", tag))
    assert set(pkgs["port"].registry.BUDGET_COUPLED) == (
        set(pkgs["ref"].registry.BUDGET_COUPLED) & set(METHODS))


def test_objective_names_are_the_reference_less_sharding(pkgs):
    port = pkgs["port"].objectives.objective_names()
    ref = _own_objectives(pkgs["ref"], "repro")
    assert port == _own_objectives(pkgs["port"], "repro_torch")
    assert port == tuple(n for n in ref if n not in SHARDING)
    assert pkgs["port"].objectives.objective_families() == (
        "offline", "kernel")
    for name in port:
        mine = pkgs["port"].objectives.get_objective(name)
        theirs = pkgs["ref"].objectives.get_objective(name)
        assert mine.evaluate == theirs.evaluate.replace(
            "repro.", "repro_torch.", 1)
        assert (mine.family, mine.rung, mine.cost_class, mine.tags) == (
            theirs.family, theirs.rung, theirs.cost_class, theirs.tags)
        if mine.family == "kernel":
            # the device is one more identity field, defaulting to cuda
            assert mine.params == theirs.params + ("device",)
            assert dict(mine.defaults) == dict(theirs.defaults,
                                               device="cuda")
        else:
            assert (mine.params, mine.defaults, mine.context_params) == (
                theirs.params, theirs.defaults, theirs.context_params)


def _search(pkg, method, workload, target, seed=0, budget=BUDGET):
    """One method on one offline task, through the package's engine:
    (history, per-round trace, pick, driver)."""
    ds = pkg.multicloud.build_dataset(0)
    drv = pkg.registry.get_method(method).make_driver(
        ds.domain, budget, seed, target=target)
    kw = dict(workload=workload, target=target, dataset_seed=0)
    binding = (pkg.fidelity.bind_ladder("offline", **kw)
               if hasattr(drv, "attach_ladder")
               else pkg.objectives.bind_objective("offline", **kw))
    engine = pkg.exp.ExperimentEngine(
        pkg.runners.search_runner, context={"dataset_seed": 0},
        executor="serial")
    trace = []

    def observe(_cell, tick, batch, values):
        trace.append((tick, list(batch), list(values)))
    hist = pkg.runners.drive_units(engine, [(drv, binding)],
                                   observer=observe)[0]
    return hist, trace, _chip_smoke().driver_pick(drv), drv


@pytest.mark.parametrize("method", METHODS)
def test_search_history_equals_reference(pkgs, method):
    for workload, target in TASKS:
        port = _search(pkgs["port"], method, workload, target)
        ref = _search(pkgs["ref"], method, workload, target)
        hist, trace, pick, _drv = port
        assert hist.points == ref[0].points
        assert hist.values == ref[0].values
        assert trace == ref[1]
        assert pick == ref[2]
        assert 0 < len(hist.values) <= BUDGET


@pytest.mark.parametrize("method", METHODS[:12])
def test_run_search_equals_reference_loop(pkgs, method):
    """The port's ``run_search`` (driver, closed inline) equals the
    reference's retained inline loop, on another seed."""
    port, ref = pkgs["port"], pkgs["ref"]
    ds = port.multicloud.build_dataset(0)
    ref_ds = ref.multicloud.build_dataset(0)
    workload, target = TASKS[1]
    mine = port.evaluate.run_search(method, ds.task(workload, target),
                                    ds.domain, BUDGET, 5)
    theirs = ref.evaluate.run_search_reference(
        method, ref_ds.task(workload, target), ref_ds.domain, BUDGET, 5)
    assert (mine.points, mine.values) == (theirs.points, theirs.values)


@pytest.mark.parametrize("seed", [0, 1])
def test_cloudbandit_driver_equals_reference(pkgs, seed):
    """The quickstart's flow: CloudBandit over RBFOpt at B = 33, batch by
    batch, then its result (eliminated arms, pulls, pick)."""
    runs = {}
    for name, pkg in pkgs.items():
        ds = pkg.multicloud.build_dataset(0)
        task = ds.task("xgboost@santander", "cost")
        b1 = pkg.cloudbandit.b1_for_budget(33, K=3)
        cb = pkg.drivers.CloudBanditDriver(
            ds.domain, pkg.optimizers.RBFOpt, b1=b1, seed=seed)
        batches = []
        while not cb.done:
            batch = cb.ask_batch()
            values = [task.objective(p, c) for p, c in batch]
            batches.append((list(batch), values))
            cb.tell_batch(values)
        runs[name] = (batches, cb.result(), b1)
    (batches, res, b1), (ref_batches, ref_res, ref_b1) = (
        runs["port"], runs["ref"])
    assert b1 == ref_b1
    assert batches == ref_batches
    assert res.eliminated == ref_res.eliminated
    assert res.pulls == ref_res.pulls
    assert (res.provider, res.config, res.loss) == (
        ref_res.provider, ref_res.config, ref_res.loss)
    assert res.history.points == ref_res.history.points
    assert res.history.values == ref_res.history.values
    assert len(res.eliminated) == 2 and sum(res.pulls.values()) <= 33


@pytest.mark.parametrize("method", MULTI_FIDELITY)
@pytest.mark.parametrize("seed", [0, 1])
def test_multi_fidelity_on_the_offline_ladder(pkgs, method, seed):
    """``mf_sh`` / ``mf_prefilter`` at fig6's offline budget: the same
    requests at the same rungs, the same spend per rung, the same pick."""
    workload, target = TASKS[0]
    port = _search(pkgs["port"], method, workload, target, seed, budget=33)
    ref = _search(pkgs["ref"], method, workload, target, seed, budget=33)
    assert port[1] == ref[1]
    rungs = {len(req) == 3 and req[2] for _t, batch, _v in port[1]
             for req in batch}
    assert 0 in rungs                   # the proxy rung was used
    assert port[3].spend == ref[3].spend
    assert port[2] == ref[2]
    assert (port[0].points, port[0].values) == (ref[0].points,
                                                ref[0].values)
