"""Parallel, cached, resumable experiment engine (see engine.py)."""
from repro_torch.exp.engine import EngineStats, ExperimentEngine, WorkUnit
from repro_torch.exp.executors import (
    EXECUTORS, BaseExecutor, LocalSubprocessTransport, ProcessExecutor,
    RemoteExecutor, SerialExecutor, SSHTransport, ThreadExecutor,
    WorkerTransport, make_executor, parse_hosts)
from repro_torch.exp.cli import (
    add_engine_args, engine_from_args, engine_kwargs_from_args)
from repro_torch.exp.protocols import (
    BUDGET_COUPLED, GRANULARITIES, experiment_engine, make_engine,
    make_objective_engine, predictive_regret, regret_curves,
    savings_distribution)
from repro_torch.exp.runners import drive_units, eval_unit
from repro_torch.exp.store import (
    BaseResultStore, ResultStore, ShardedResultStore, merge_stores,
    open_store, unit_key)
from repro_torch.exp.wire import RemoteTaskError, UnitTimeout, WorkerDied

__all__ = [
    "BUDGET_COUPLED", "BaseExecutor", "BaseResultStore", "EXECUTORS",
    "EngineStats", "ExperimentEngine", "GRANULARITIES",
    "LocalSubprocessTransport", "ProcessExecutor", "RemoteExecutor",
    "RemoteTaskError", "ResultStore", "SSHTransport", "SerialExecutor",
    "ShardedResultStore", "ThreadExecutor", "UnitTimeout", "WorkUnit",
    "WorkerDied", "WorkerTransport", "add_engine_args", "drive_units",
    "engine_from_args", "engine_kwargs_from_args", "eval_unit",
    "experiment_engine", "make_engine", "make_executor",
    "make_objective_engine", "merge_stores", "open_store",
    "parse_hosts", "predictive_regret", "regret_curves",
    "savings_distribution", "unit_key",
]
