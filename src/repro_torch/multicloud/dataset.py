"""Offline benchmark dataset: 30 workloads × 88 configs × {runtime, cost}.

Collected once (seeded), then replayed: when an algorithm evaluates
(provider, config) we read the recorded value — the paper's exact protocol
for comparing search methods without re-running clouds.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.domain import Domain
from repro_torch.multicloud.perfmodel import (
    ALL_WORKLOADS, Workload, cost_model, cost_model_batch, runtime_model,
    runtime_model_batch)
from repro_torch.multicloud.providers import multicloud_domain

TARGETS = ("cost", "time")


def _freeze(config: dict) -> tuple:
    return tuple(sorted(config.items()))


@dataclasses.dataclass
class Task:
    """One optimization task: (workload, target) with table-lookup objective."""
    workload: str
    target: str
    table: Dict[Tuple[str, tuple], float]

    def objective(self, provider: str, config: dict) -> float:
        return self.table[(provider, _freeze(config))]

    @property
    def true_min(self) -> float:
        return min(self.table.values())

    @property
    def true_argmin(self):
        return min(self.table, key=self.table.get)

    def mean_value(self) -> float:
        return float(np.mean(list(self.table.values())))

    def regret(self, value: float) -> float:
        m = self.true_min
        return (value - m) / m


@dataclasses.dataclass
class OfflineDataset:
    domain: Domain
    tasks: Dict[Tuple[str, str], Task]        # (workload, target) -> Task
    workloads: Tuple[str, ...]
    seed: int = 0                             # collection seed (cache key)

    def task(self, workload: str, target: str) -> Task:
        return self.tasks[(workload, target)]

    def tasks_for_target(self, target: str) -> List[Task]:
        return [self.tasks[(w, target)] for w in self.workloads]

    def offline_objectives(self, target: str, exclude: str
                           ) -> Dict[int, Callable]:
        """Other-workload objectives for the PARIS-style predictor."""
        return {
            i: self.tasks[(w, target)].objective
            for i, w in enumerate(self.workloads) if w != exclude
        }


def build_dataset(seed: int = 0) -> OfflineDataset:
    """Build (or fetch the memoized) offline dataset for a collection seed.

    The returned instance is shared across callers and must be treated as
    immutable — experiment workers rely on that to pay the build at most
    once per process (forked pool workers inherit it for free).
    """
    return _build_dataset_cached(int(seed))


@functools.lru_cache(maxsize=8)
def _build_dataset_cached(seed: int) -> OfflineDataset:
    domain = multicloud_domain()
    rng = np.random.default_rng(seed)
    tasks: Dict[Tuple[str, str], Task] = {}
    names = tuple(w.name for w in ALL_WORKLOADS)
    # static per-provider grids: configs + frozen table keys, shared by
    # every workload (the 88-point grid never changes)
    grids = [
        (prov, domain.inner_candidates(prov))
        for prov in domain.provider_names
    ]
    frozen = {prov: [(prov, _freeze(c)) for c in cfgs]
              for prov, cfgs in grids}
    for w in ALL_WORKLOADS:
        rt_table: Dict[Tuple[str, tuple], float] = {}
        cost_table: Dict[Tuple[str, tuple], float] = {}
        for prov, cfgs in grids:
            t = runtime_model_batch(w, prov, cfgs, rng)
            c = cost_model_batch(t, prov, cfgs)
            for key, tv, cv in zip(frozen[prov], t, c):
                rt_table[key] = float(tv)
                cost_table[key] = float(cv)
        tasks[(w.name, "time")] = Task(w.name, "time", rt_table)
        tasks[(w.name, "cost")] = Task(w.name, "cost", cost_table)
    return OfflineDataset(domain=domain, tasks=tasks, workloads=names,
                          seed=seed)


def build_dataset_reference(seed: int = 0) -> OfflineDataset:
    """Unvectorized scalar collection loop, kept as the ground truth the
    vectorized ``build_dataset`` is tested bit-identical against."""
    domain = multicloud_domain()
    rng = np.random.default_rng(seed)
    tasks: Dict[Tuple[str, str], Task] = {}
    names = tuple(w.name for w in ALL_WORKLOADS)
    for w in ALL_WORKLOADS:
        rt_table: Dict[Tuple[str, tuple], float] = {}
        cost_table: Dict[Tuple[str, tuple], float] = {}
        for prov in domain.provider_names:
            for cfg in domain.inner_candidates(prov):
                t = runtime_model(w, prov, cfg, rng)
                rt_table[(prov, _freeze(cfg))] = t
                cost_table[(prov, _freeze(cfg))] = cost_model(t, prov, cfg)
        tasks[(w.name, "time")] = Task(w.name, "time", rt_table)
        tasks[(w.name, "cost")] = Task(w.name, "cost", cost_table)
    return OfflineDataset(domain=domain, tasks=tasks, workloads=names,
                          seed=seed)
