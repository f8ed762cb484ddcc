"""Parity of the port's ``multicloud`` copy with the reference's: the
offline table, its domain and tasks, and the three table objectives
(``offline``, ``offline_proxy``, ``market``) evaluated on a seeded sample
of points.  Both packages run the same numpy code on the same machine,
so everything here is held to exact equality."""
import numpy as np
import pytest

from repro.core import objectives as jax_objectives
from repro.multicloud import dataset as jax_dataset
from repro.multicloud import market as jax_market
from repro.multicloud import perfmodel as jax_perfmodel
from repro.multicloud import providers as jax_providers
from repro_torch.core import objectives as objectives
from repro_torch.multicloud import dataset, market, perfmodel, providers

#: a schedule with every event kind, so failures, steps and slow windows
#: all show in the sampled payloads
SCHEDULE = ("outage:aws:2:5,revoke:gcp:family=e2:1:9,step:azure:3.0:4,"
            "slow:gcp:2.0:3:6")


def _domain_rows(domain):
    return [(p.name, [(s.name, tuple(s.values)) for s in p.params])
            for p in domain.providers]


def _table_arrays(task):
    keys = sorted(task.table)
    return keys, np.array([task.table[k] for k in keys])


@pytest.mark.parametrize("seed", [0, 3])
def test_build_dataset_equals_reference(seed):
    mine, ref = dataset.build_dataset(seed), jax_dataset.build_dataset(seed)
    assert mine.workloads == ref.workloads and len(mine.workloads) == 30
    assert mine.seed == ref.seed == seed
    assert _domain_rows(mine.domain) == _domain_rows(ref.domain)
    assert sorted(mine.tasks) == sorted(ref.tasks)
    assert len(mine.tasks) == 60
    for key, task in mine.tasks.items():
        other = ref.tasks[key]
        assert (task.workload, task.target) == (other.workload, other.target)
        keys, values = _table_arrays(task)
        ref_keys, ref_values = _table_arrays(other)
        assert keys == ref_keys and len(keys) == 88
        assert np.array_equal(values, ref_values)
        assert task.true_min == other.true_min
        assert task.true_argmin == other.true_argmin


def test_scalar_collection_loop_equals_vectorized():
    """The port's kept scalar loop equals its vectorized build and the
    reference's scalar loop."""
    mine = dataset.build_dataset_reference(0)
    ref = jax_dataset.build_dataset_reference(0)
    fast = dataset.build_dataset(0)
    for key, task in mine.tasks.items():
        values = _table_arrays(task)[1]
        assert np.array_equal(values, _table_arrays(ref.tasks[key])[1])
        assert np.array_equal(values, _table_arrays(fast.tasks[key])[1])


def test_catalog_and_encodings_equal_reference():
    assert providers.NODE_CATALOG == jax_providers.NODE_CATALOG
    assert [w.name for w in perfmodel.ALL_WORKLOADS] == [
        w.name for w in jax_perfmodel.ALL_WORKLOADS]
    dom = providers.multicloud_domain()
    for prov, cfg in dom.all_candidates():
        assert np.array_equal(providers.attr_encode_config(prov, cfg),
                              jax_providers.attr_encode_config(prov, cfg))
        assert np.array_equal(providers.attr_encode_point((prov, cfg)),
                              jax_providers.attr_encode_point((prov, cfg)))


def _sample_points(n, seed):
    """(workload, target, provider, config-tuple) drawn with numpy."""
    ds = dataset.build_dataset(0)
    cands = ds.domain.all_candidates()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = ds.workloads[int(rng.integers(len(ds.workloads)))]
        t = dataset.TARGETS[int(rng.integers(2))]
        prov, cfg = cands[int(rng.integers(len(cands)))]
        out.append((w, t, prov, tuple(sorted(cfg.items()))))
    return out


CASES = {
    "offline": {},
    "offline_proxy": {"proxy_sigma": 0.25},
    "market": {"market_seed": 5, "horizon": 12, "walk_sigma": 0.05,
               "schedule": SCHEDULE},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_table_objectives_return_equal_payloads(name):
    extra = CASES[name]
    mine_fn = objectives.get_objective(name).resolve()
    ref_fn = jax_objectives.get_objective(name).resolve()
    assert mine_fn.__module__.startswith("repro_torch.")
    assert ref_fn.__module__.startswith("repro.")
    failures = 0
    for i, (w, t, prov, cfg) in enumerate(_sample_points(48, seed=11)):
        params = dict(extra, workload=w, target=t, provider=prov,
                      config=cfg)
        if name == "market":
            params["tick"] = i % 12
        context = {"dataset_seed": 0}
        mine, ref = mine_fn(params, context), ref_fn(params, context)
        assert mine == ref
        failures += bool(mine.get("failed"))
    if name == "market":
        assert failures > 0             # the schedule's events did bite


def test_market_overlay_trajectories_equal_reference():
    mine = market.MarketOverlay(seed=2, horizon=16, walk_sigma=0.1,
                                schedule=SCHEDULE)
    ref = jax_market.MarketOverlay(seed=2, horizon=16, walk_sigma=0.1,
                                   schedule=SCHEDULE)
    for tick in range(16):
        for prov, cfg in providers.multicloud_domain().all_candidates():
            assert (mine.unavailable_reason(tick, prov, cfg)
                    == ref.unavailable_reason(tick, prov, cfg))
            for target in dataset.TARGETS:
                assert (mine.value(tick, 1.0, prov, target)
                        == ref.value(tick, 1.0, prov, target))
