"""Shared argparse plumbing for engine-backed entrypoints.

Seven PRs of flag accretion left ``--executor/--workers/--hosts/
--timeout/--retries/--store/--store-dir/--granularity`` re-declared in
every CLI (``benchmarks/run.py``, the fig scripts, the sweep scripts,
``repro_torch.tuner.autotune``).  :func:`add_engine_args` declares them once
and :func:`engine_from_args` turns the parsed namespace into an
:class:`~repro_torch.exp.engine.ExperimentEngine` through the one factory
(:func:`~repro_torch.exp.protocols.experiment_engine`) — a new entrypoint gets
the full engine surface (executor backends, remote hosts, sharded
stores, per-unit timeouts, retries) with two calls.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.exp.protocols import GRANULARITIES, experiment_engine

EXECUTOR_CHOICES = ("serial", "thread", "process", "remote")

#: flag destinations declared by :func:`add_engine_args` — entrypoints
#: that forward engine options by introspection iterate this
ENGINE_ARG_NAMES = ("workers", "executor", "store", "store_dir", "hosts",
                    "timeout", "retries")


def add_engine_args(parser, *, granularity: bool = False,
                    workers: int = 1, timeout: Optional[float] = None,
                    retries: int = 0):
    """Declare the shared engine flags on ``parser`` (returns it).

    ``granularity`` opts into the ``--granularity`` flag (only the
    search protocols honour it); ``workers``/``timeout``/``retries``
    set entrypoint-specific defaults.
    """
    g = parser.add_argument_group("engine")
    g.add_argument("--workers", type=int, default=workers,
                   help="executor width (concurrent work units)")
    g.add_argument("--executor", default=None, choices=EXECUTOR_CHOICES,
                   help="engine backend (default: serial at --workers 1, "
                        "process pool above)")
    g.add_argument("--store", default=None,
                   help="single-file JSONL result store (memoizes "
                        "completed units across runs)")
    g.add_argument("--store-dir", default=None,
                   help="sharded result-store directory (multi-writer "
                        "safe) instead of --store")
    g.add_argument("--hosts", default=None,
                   help="remote executor host spec, e.g. "
                        "'local*4,ssh:user@gpu1*8' (default: --workers "
                        "local subprocess workers)")
    g.add_argument("--timeout", type=float, default=timeout,
                   help="per-unit wall-clock budget in seconds "
                        "(operational: never invalidates the store)")
    g.add_argument("--retries", type=int, default=retries,
                   help="extra attempts per unit after a failure/timeout "
                        "before it is surfaced as a structured failure")
    if granularity:
        g.add_argument("--granularity", default="run",
                       choices=GRANULARITIES,
                       help="search work-unit granularity: one unit per "
                            "whole run (default), or per objective "
                            "evaluation — drivers run in-process and "
                            "every yielded (provider, config) request "
                            "is dispatched through the executor and "
                            "memoized in the store, shared across "
                            "methods/seeds/budgets")
    return parser


def engine_kwargs_from_args(args) -> dict:
    """:func:`experiment_engine` keyword arguments from a parsed
    namespace (exactly the flags :func:`add_engine_args` declared)."""
    hosts = getattr(args, "hosts", None)
    return {
        "workers": getattr(args, "workers", 1),
        "executor": getattr(args, "executor", None),
        "executor_kwargs": {"hosts": hosts} if hosts else None,
        "store_path": getattr(args, "store", None),
        "store_dir": getattr(args, "store_dir", None),
        "unit_timeout_s": getattr(args, "timeout", None),
        "retries": getattr(args, "retries", 0),
    }


def engine_from_args(args, binding=None, *, dataset=None,
                     context: Optional[dict] = None, store=None,
                     local_context: Optional[dict] = None,
                     runner=None, verbose: bool = False):
    """Build the engine an entrypoint's parsed flags describe.

    ``binding``/``dataset``/``context`` feed the content-hash context
    exactly as in :func:`experiment_engine`; ``store`` injects a
    prebuilt store object (overriding ``--store``/``--store-dir``);
    ``runner`` swaps the unit runner (e.g. ``dryrun_runner``).
    """
    kw = engine_kwargs_from_args(args)
    if store is not None:
        kw["store"] = store
        kw.pop("store_path"), kw.pop("store_dir")
    if runner is not None:
        kw["runner"] = runner
    return experiment_engine(binding, dataset=dataset, context=context,
                             local_context=local_context, verbose=verbose,
                             **kw)
