"""Store maintenance CLI: ``python -m repro_torch.exp <cmd>``.

Subcommands operate on either store layout (single-file ``*.jsonl`` or
sharded directory — detected from the path):

``merge SRC [SRC ...] --out DEST``
    Consolidate stores from several writers/hosts into one.  The
    multi-host sweep workflow: every host runs with its own
    ``--store-dir`` (or its own writer files in a shared directory),
    then one merge produces the store all hosts replay from.
``compact STORE [--workers N --executor thread|process]``
    Rewrite to exactly one record per key in deterministic key order,
    dropping torn lines, superseded duplicates, and stale writer files.
    On a sharded store, ``--workers > 1`` compacts hash-prefixes in
    parallel through the executor registry (million-record stores are
    IO-bound: ``thread`` is the usual pick; ``remote`` is rejected —
    prefix shards must land on the caller's filesystem).
``worker [--heartbeat S]``
    Run a remote-execution worker speaking the framed JSONL protocol
    over stdin/stdout (see :mod:`repro_torch.exp.worker`) — spawned by
    :class:`~repro_torch.exp.executors.RemoteExecutor` over a local pipe or
    an SSH channel, not normally started by hand.
``gc STORE [--dry-run]``
    Drop records that no longer re-derive their own content key
    (old-schema leftovers, hand-edited rows) or lack a result payload,
    then compact.
``stat STORE``
    Record counts by unit kind plus the store's content fingerprint
    (timing-independent: equal fingerprints ⇒ semantically identical
    stores, regardless of layout or write order).
``methods [--tag TAG]``
    List the registered search methods (name, budget-coupling, tags)
    from the method registry — the same metadata ``run_search``, the
    figure protocols, and the benchmarks introspect.
``objectives [--tag TAG]``
    List the registered objectives (name, eval params with defaults,
    worker-importable evaluate ref, tags) from the objective registry —
    what ``eval`` work units and the autotuner dispatch against.
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

from repro_torch.exp.store import merge_stores, open_store


def _open_existing(path: str):
    """Maintenance targets must exist: open_store() on a typo'd path
    would create a fresh empty store and report success against it."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"store not found: {path}")
    return open_store(path)


def _warn_load_errors(store, action: str) -> int:
    """Surface shards a store could not read; maintenance that skipped
    data must not exit 0."""
    for path in store.load_errors:
        print(f"WARNING: unreadable shard not {action}: {path}",
              file=sys.stderr)
    return 1 if store.load_errors else 0


def _cmd_merge(args: argparse.Namespace) -> int:
    try:
        dest = merge_stores(args.sources, args.out)
    except (FileNotFoundError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(f"merged {len(args.sources)} store(s) -> {args.out}: "
          f"{len(dest)} records, fingerprint {dest.fingerprint()[:16]}")
    return _warn_load_errors(dest, "merged")


def _cmd_compact(args: argparse.Namespace) -> int:
    from repro_torch.exp.store import ShardedResultStore
    try:
        store = _open_existing(args.store)
        if isinstance(store, ShardedResultStore):
            store.compact(executor=args.executor, workers=args.workers)
        else:
            if args.workers > 1 or args.executor:
                print("note: parallel compaction applies to sharded "
                      "stores only; compacting serially", file=sys.stderr)
            store.compact()
    except (FileNotFoundError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(f"compacted {args.store}: {len(store)} records")
    return _warn_load_errors(store, "compacted")


def _cmd_worker(args: argparse.Namespace) -> int:
    from repro_torch.exp.worker import main as worker_main
    return worker_main(["--heartbeat", str(args.heartbeat)])


def _cmd_gc(args: argparse.Namespace) -> int:
    try:
        store = _open_existing(args.store)
        dropped = store.gc(dry_run=args.dry_run)
    except (FileNotFoundError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    verb = "would drop" if args.dry_run else "dropped"
    print(f"gc {args.store}: {verb} {dropped} stale record(s), "
          f"{len(store) - (dropped if args.dry_run else 0)} live")
    return _warn_load_errors(store, "gc'd")


def _cmd_stat(args: argparse.Namespace) -> int:
    try:
        store = _open_existing(args.store)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    kinds = Counter(rec.get("kind", "?") for rec in store.records())
    print(f"{args.store}: {len(store)} records")
    for kind, n in sorted(kinds.items()):
        print(f"  {kind}: {n}")
    _stat_eval_timing(store)
    for path in store.load_errors:
        print(f"  UNREADABLE shard skipped: {path}", file=sys.stderr)
    print(f"fingerprint: {store.fingerprint()}")
    return 0


def _stat_eval_timing(store) -> None:
    """Per-cost-class / per-rung timing breakdown over stored ``eval``
    records — the same timings the pipelined scheduler's cost model
    seeds its estimates from, so this is the operator's view of what
    the packer sees."""
    from repro_torch.core.objectives import DEFAULT_OBJECTIVE, get_objective
    groups: dict = {}
    for rec in store.records():
        if rec.get("kind") != "eval":
            continue
        params = rec.get("params") or {}
        obj = str(params.get("objective", DEFAULT_OBJECTIVE))
        fid = params.get("fidelity")
        try:
            cls = get_objective(obj).cost_class or "-"
        except KeyError:
            cls = "-"
        key = (cls, obj, "-" if fid is None else str(fid))
        n, tot = groups.get(key, (0, 0.0))
        groups[key] = (n + 1, tot + float(rec.get("elapsed_s", 0.0)))
    if not groups:
        return
    print("  eval timing by cost class / objective / rung:")
    rows = [(cls, obj, fid, n, tot, tot / n)
            for (cls, obj, fid), (n, tot) in sorted(groups.items())]
    w_cls = max(len(r[0]) for r in rows)
    w_obj = max(len(r[1]) for r in rows)
    for cls, obj, fid, n, tot, mean in rows:
        print(f"    {cls:<{w_cls}}  {obj:<{w_obj}}  rung={fid:<2} "
              f" n={n:<6} mean={mean:.4f}s total={tot:.2f}s")


def _cmd_methods(args: argparse.Namespace) -> int:
    from repro_torch.core.registry import method_specs
    specs = [s for s in method_specs()
             if args.tag is None or args.tag in s.tags]
    if not specs:
        print(f"no methods tagged {args.tag!r}", file=sys.stderr)
        return 1
    width = max(len(s.name) for s in specs)
    for s in specs:
        coupling = "budget-coupled" if s.budget_coupled else "curve-sliced"
        print(f"{s.name:<{width}}  {coupling:<14}  {','.join(s.tags)}")
    return 0


def _cmd_objectives(args: argparse.Namespace) -> int:
    from repro_torch.core.objectives import objective_specs
    specs = [s for s in objective_specs()
             if args.tag is None or args.tag in s.tags]
    if not specs:
        print(f"no objectives tagged {args.tag!r}", file=sys.stderr)
        return 1
    width = max(len(s.name) for s in specs)
    for s in specs:
        defaults = dict(s.defaults)
        params = ", ".join(
            f"{p}={defaults[p]!r}" if p in defaults else p
            for p in s.params)
        print(f"{s.name:<{width}}  ({params})  {s.evaluate}  "
              f"{','.join(s.tags)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.exp",
        description="experiment result-store maintenance")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("merge", help="merge stores into one")
    p.add_argument("sources", nargs="+")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=_cmd_merge)

    p = sub.add_parser("compact", help="dedup + canonicalize a store")
    p.add_argument("store")
    p.add_argument("--workers", type=int, default=1,
                   help="parallel per-prefix compaction width "
                        "(sharded stores)")
    p.add_argument("--executor", default=None,
                   choices=("serial", "thread", "process"),
                   help="executor backend for parallel compaction "
                        "(local backends only; default: thread when "
                        "--workers > 1)")
    p.set_defaults(fn=_cmd_compact)

    p = sub.add_parser("gc", help="drop stale/undecodable records")
    p.add_argument("store")
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=_cmd_gc)

    p = sub.add_parser("stat", help="record counts + content fingerprint")
    p.add_argument("store")
    p.set_defaults(fn=_cmd_stat)

    p = sub.add_parser("methods", help="list registered search methods")
    p.add_argument("--tag", default=None,
                   help="filter by registry tag (e.g. flat, bandit, sota)")
    p.set_defaults(fn=_cmd_methods)

    p = sub.add_parser("objectives", help="list registered objectives")
    p.add_argument("--tag", default=None,
                   help="filter by registry tag (e.g. table, measured, "
                        "compile)")
    p.set_defaults(fn=_cmd_objectives)

    p = sub.add_parser("worker", help="remote execution worker "
                                      "(framed JSONL over stdio)")
    p.add_argument("--heartbeat", type=float, default=2.0,
                   help="seconds between heartbeats (0 disables)")
    p.set_defaults(fn=_cmd_worker)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout piped into a pager/head that closed early — the unix
        # convention is silent success, not a traceback
        sys.stderr.close()
        return 0


if __name__ == "__main__":
    sys.exit(main())
