"""The port's router (``repro_torch.runtime.router``, a copy of
``repro.runtime.router`` with ``repro.`` read as ``repro_torch.``) and
fig7's router leg (``benchmarks/fig7_serve.py:137-186``: ``cb_rbfopt``,
the aws outage schedule, the market clock) run through both packages:
the same decisions (kind, tick, provider, config of each) and equal
``stats`` and ``best``.  Both packages run the same numpy code, so the
comparison is exact."""
import importlib
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmarks import fig7_serve as fig7

ROOT = Path(__file__).resolve().parents[1]


def _body(text):
    return re.sub(r'^"""[\s\S]*?"""\n', "", text, count=1)


def test_router_is_a_copy():
    port = (ROOT / "src/repro_torch/runtime/router.py").read_text()
    ref = (ROOT / "src/repro/runtime/router.py").read_text()
    assert "repro." not in re.sub(r"repro_torch\.", "", port)
    assert _body(port.replace("repro_torch.", "repro.")) == _body(ref)


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        objectives=mod("core.objectives"), registry=mod("core.registry"),
        multicloud=mod("multicloud"), market=mod("multicloud.market"),
        router=mod("runtime.router"))


def _router_leg(root, quick):
    """fig7's ``run_router`` through one package, keeping each decision."""
    pkg = _pkg(root)
    ds = pkg.multicloud.build_dataset()
    w = ds.workloads[::fig7.ROUTER_WORKLOAD_STRIDE][0]
    task = ds.task(w, "cost")
    overlay = pkg.market.get_overlay(0, fig7.ROUTER_HORIZON, 0.0,
                                     fig7.ROUTER_SCHEDULE)
    router = pkg.router.ConfigRouter(overlay=overlay,
                                     clock=pkg.market.MarketClock())
    driver = pkg.registry.get_method("cb_rbfopt").make_driver(
        ds.domain, fig7.ROUTER_BUDGET, 0, target="cost")
    router.register(w, driver, binding=pkg.objectives.bind_objective(
        "offline", workload=w, target="cost", dataset_seed=int(ds.seed)))
    n = fig7.ROUTER_REQUESTS // 2 if quick else fig7.ROUTER_REQUESTS
    decisions = []
    for _ in range(n):
        d = router.route(w)
        if overlay.available(d.tick, d.provider, d.config):
            lat = overlay.value(d.tick, task.objective(d.provider, d.config),
                                d.provider, "cost")
            router.observe(d, lat)
        else:
            router.observe(d, pkg.objectives.EvalFailure(
                reason="backend down"))
        decisions.append((d.kind, d.tick, d.provider,
                          sorted(dict(d.config).items())))
    return decisions, router.stats(w), router.best(w)


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_fig7_router_leg_matches_reference(quick):
    ref = _router_leg("repro", quick)
    port = _router_leg("repro_torch", quick)
    n = fig7.ROUTER_REQUESTS // 2 if quick else fig7.ROUTER_REQUESTS
    assert len(port[0]) == n
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    # fig7's SLOs hold on the port's run too
    assert port[1]["told"] > 0
    kinds = {k for k, *_ in port[0]}
    assert "explore" in kinds
    assert all(p != "aws" or k == "blind" for k, t, p, _ in port[0]
               if 3 <= t < 9)
