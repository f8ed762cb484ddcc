"""Content-addressed JSONL result stores for experiment work units.

Each completed unit is persisted as one JSON line keyed by a content hash
of (schema version, unit kind, unit params, engine context).  The context
carries everything code-relevant that is *not* in the unit itself — the
dataset collection seed, protocol revision, etc. — so a change to either
the unit or the context yields a fresh key and a recompute, while re-runs
and crash-resumes of an identical experiment replay from the store.

Two on-disk layouts share one dict-like API:

:class:`ResultStore`
    The original single-file layout: one append-only JSONL file.  Safe
    for one writer process per file (a torn trailing line from a crashed
    writer is skipped on load); kept fully readable/writable for
    backward compatibility.

:class:`ShardedResultStore`
    A directory of JSONL shards for multi-process / multi-host sweeps:
    records fan out into ``<root>/<hash-prefix>/`` subdirectories, and
    within a prefix every *writer* (host + pid) appends to its own file —
    concurrent engine processes on the same or different hosts never
    interleave writes into one file, so no locking is needed on shared
    filesystems.  ``merge``/``compact``/``gc`` (also exposed through
    ``python -m repro_torch.exp``) consolidate shards across hosts.

Both layouts are append-only with last-record-for-a-key-wins semantics.
Because keys are content hashes and runners are deterministic in
(kind, params, context), duplicate records for one key carry identical
payloads — so cross-file "last wins" resolution order only needs to be
deterministic (lexicographic file order), not causal.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
from typing import (
    Any, Dict, Iterable, List, Mapping, Optional, Tuple, Union)

#: bump when the record format or unit semantics change incompatibly
SCHEMA_VERSION = 1

#: record fields excluded from content fingerprints: operational
#: measurements that legitimately differ between identical re-runs
#: (timings, and how many attempts the engine's retry budget spent
#: before the unit succeeded)
VOLATILE_FIELDS = ("elapsed_s", "attempts")


def unit_key(kind: str, params: Mapping[str, Any],
             context: Optional[Mapping[str, Any]] = None) -> str:
    """Deterministic content hash identifying one work unit."""
    payload = {
        "schema": SCHEMA_VERSION,
        "kind": kind,
        "params": {str(k): params[k] for k in sorted(params)},
        "context": {str(k): v for k, v in sorted((context or {}).items())},
    }
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def _parse_lines(f) -> Iterable[dict]:
    """Yield well-formed records from a JSONL stream, skipping blank and
    torn/corrupt lines (crashed writers leave at most one torn tail)."""
    for line in f:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "key" in rec:
            yield rec


def _canonical_record(record: dict) -> dict:
    return {k: record[k] for k in sorted(record) if k not in VOLATILE_FIELDS}


class BaseResultStore:
    """Dict-like unit-result cache; subclasses define persistence."""

    def __init__(self) -> None:
        self._records: Dict[str, dict] = {}
        #: shard files skipped on load (unreadable/undecodable), by path
        self.load_errors: List[str] = []

    # -- read side -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, key: str) -> bool:
        return key in self._records

    def get(self, key: str) -> Optional[dict]:
        return self._records.get(key)

    def keys(self) -> Iterable[str]:
        return self._records.keys()

    def records(self) -> Iterable[dict]:
        """All live records in deterministic (key-sorted) order."""
        return (self._records[k] for k in sorted(self._records))

    def fingerprint(self) -> str:
        """Content hash of the live record set, excluding volatile fields
        (timings) — equal fingerprints mean semantically identical
        stores, regardless of layout, shard fan-out, or write order."""
        h = hashlib.sha256()
        for rec in self.records():
            h.update(json.dumps(_canonical_record(rec), sort_keys=True,
                                default=str).encode())
            h.update(b"\n")
        return h.hexdigest()

    # -- write side ------------------------------------------------------
    def put(self, key: str, record: dict) -> None:
        record = dict(record, key=key)
        self._records[key] = record
        self._append(record)

    def update(self, other: "BaseResultStore",
               persist: bool = True) -> None:
        """Absorb another store's records (later sources win).

        ``persist=False`` updates only the in-memory set — for bulk
        operations that finish with one :meth:`compact` instead of one
        append per record (a merge of N records would otherwise pay N
        file opens and then rewrite everything again anyway)."""
        for rec in other.records():
            if persist:
                self.put(rec["key"], rec)
            else:
                self._records[rec["key"]] = dict(rec)

    def _append(self, record: dict) -> None:
        raise NotImplementedError

    # -- maintenance -----------------------------------------------------
    def gc(self, dry_run: bool = False) -> int:
        """Drop records whose key no longer re-derives from their own
        (kind, params, context) — old-schema leftovers after a
        SCHEMA_VERSION bump, hand-edited or foreign records — plus any
        record missing a result payload.  Returns the number dropped."""
        stale = [
            k for k, rec in self._records.items()
            if "result" not in rec
            or unit_key(rec.get("kind", ""), rec.get("params") or {},
                        rec.get("context") or {}) != k
        ]
        if not dry_run:
            for k in stale:
                del self._records[k]
            self.compact()
        return len(stale)

    def compact(self) -> None:
        """Rewrite persistent state to exactly one record per live key,
        in deterministic key order, dropping torn lines and superseded
        duplicates."""
        raise NotImplementedError


class ResultStore(BaseResultStore):
    """Single-file JSONL store (one writer process per file).

    ``path=None`` gives a purely in-memory store (used by tests and by
    library callers that do not want artifacts on disk).
    """

    def __init__(self, path: Optional[str] = None):
        super().__init__()
        self.path = path
        if path and os.path.exists(path):
            self._load(path)

    def _load(self, path: str) -> None:
        try:
            with open(path) as f:
                for rec in _parse_lines(f):
                    self._records[rec["key"]] = rec
        except (OSError, UnicodeDecodeError):
            self.load_errors.append(path)

    def _append(self, record: dict) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")
            f.flush()

    def compact(self) -> None:
        if not self.path:
            return
        if self.path in self.load_errors:
            # our own file never loaded: rewriting from the partial
            # (empty) in-memory set would destroy whatever it still
            # holds.  (Foreign paths propagated by merge_stores don't
            # block compaction — their files aren't the rewrite target.)
            raise RuntimeError(
                f"refusing to compact {self.path}: load failed")
        tmp = self.path + ".compact.tmp"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            for rec in self.records():
                f.write(json.dumps(rec, default=str) + "\n")
        os.replace(tmp, self.path)


class ShardedResultStore(BaseResultStore):
    """Directory-of-shards store safe for concurrent multi-process and
    multi-host writers.

    Layout::

        <root>/MANIFEST.json          {"schema": 1, "prefix_len": 2}
        <root>/<key[:2]>/<writer>.jsonl

    The hash prefix fans records out across subdirectories (bounding
    per-directory file counts and letting maintenance parallelize by
    prefix); the per-writer file — ``<hostname>-<pid>`` by default —
    guarantees no two processes ever append to the same file, which is
    the whole concurrency story: no locks, no interleaved lines, safe on
    NFS.  Loads scan every shard in sorted order; unreadable or
    undecodable shard files are skipped (and listed in ``load_errors``)
    rather than failing the sweep.
    """

    MANIFEST = "MANIFEST.json"

    def __init__(self, root: str, prefix_len: int = 2,
                 writer_id: Optional[str] = None):
        super().__init__()
        self.root = root
        self.prefix_len = int(prefix_len)
        self.writer_id = writer_id or f"{socket.gethostname()}-{os.getpid()}"
        #: shard sizes observed at load time — compact() only deletes a
        #: shard whose size is unchanged since we read it
        self._loaded_sizes: Dict[str, int] = {}
        #: prefix dirs already created (skip per-record makedirs/stat)
        self._seen_dirs: set = set()
        if os.path.isdir(root):
            self._read_manifest()
            self._load()

    # -- layout ----------------------------------------------------------
    def _read_manifest(self) -> None:
        path = os.path.join(self.root, self.MANIFEST)
        try:
            with open(path) as f:
                self.prefix_len = int(json.load(f)["prefix_len"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            pass                        # absent/corrupt manifest: keep default

    def _write_manifest(self) -> None:
        path = os.path.join(self.root, self.MANIFEST)
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump({"schema": SCHEMA_VERSION,
                           "prefix_len": self.prefix_len}, f)

    def _shard_files(self) -> List[str]:
        out = []
        for sub in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, sub)
            if not os.path.isdir(d):
                continue
            out.extend(os.path.join(d, name)
                       for name in sorted(os.listdir(d))
                       if name.endswith(".jsonl"))
        return out

    def _writer_path(self, key: str) -> str:
        return os.path.join(self.root, key[:self.prefix_len],
                            self.writer_id + ".jsonl")

    # -- persistence -----------------------------------------------------
    def _load(self) -> None:
        for path in self._shard_files():
            try:
                # size first: anything appended after this point makes
                # the size check fail and protects the file from compact
                size = os.path.getsize(path)
                with open(path) as f:
                    for rec in _parse_lines(f):
                        self._records[rec["key"]] = rec
                self._loaded_sizes[path] = size
            except (OSError, UnicodeDecodeError):
                self.load_errors.append(path)

    def _append(self, record: dict) -> None:
        path = self._writer_path(record["key"])
        d = os.path.dirname(path)
        # persist-as-you-go hot path: don't re-stat the prefix dir and
        # manifest for every record (each is a round-trip on NFS)
        if d not in self._seen_dirs:
            os.makedirs(d, exist_ok=True)
            self._write_manifest()
            self._seen_dirs.add(d)
        with open(path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")
            f.flush()

    def _compact_plan(self) -> Dict[str, List[dict]]:
        by_prefix: Dict[str, List[dict]] = {}
        for rec in self.records():
            by_prefix.setdefault(rec["key"][:self.prefix_len],
                                 []).append(rec)
        return by_prefix

    def _safe_to_delete(self, path: str) -> bool:
        """A shard may be deleted after compaction only if every record
        it holds is in memory: our own writer file always qualifies
        (nobody else writes it), any other file only if its size is
        unchanged since we loaded it — a concurrent writer appending
        between load and compact grows the file, and deleting it then
        would silently drop those records.  Maintenance is meant to run
        with writers quiesced; this guard turns an accidental overlap
        into harmless duplicate leftovers instead of data loss."""
        if os.path.basename(path) == self.writer_id + ".jsonl":
            return True
        try:
            return (path in self._loaded_sizes
                    and os.path.getsize(path) == self._loaded_sizes[path])
        except OSError:
            return False

    def compact(self, executor: Optional[str] = None,
                workers: Optional[int] = None) -> None:
        """Collapse every prefix's writer files into one ``_compact``
        shard holding exactly the live records, key-sorted.

        Prefixes are independent (no record ever crosses a prefix
        directory), so with ``workers > 1`` the per-prefix rewrites fan
        out through the executor registry — the same local backends the
        engine uses (``executor`` defaults to ``thread``, the right
        choice for this IO-bound work).  ``remote`` is rejected: prefix
        jobs write files relative to the caller's filesystem, and a
        worker on another host would write them *there* while the
        caller deletes the local shards it believes were rewritten.
        Shard bookkeeping (which stale files are safe to delete) stays
        in the caller, where the load-time size snapshots live —
        workers only ever write fresh ``_compact`` files, so a crashed
        or killed parallel compaction leaves at worst a stale ``.tmp``
        alongside intact data.
        """
        if executor == "remote":
            raise ValueError(
                "parallel compaction is local-only (thread/process): "
                "prefix shards must be written on the caller's "
                "filesystem")
        os.makedirs(self.root, exist_ok=True)
        self._write_manifest()
        by_prefix = self._compact_plan()
        # never delete shards whose records may not all be in memory:
        # failed-to-load files (repair/inspection material) and files a
        # concurrent writer touched since our load — removal would be
        # silent data loss
        stale = {p for p in self._shard_files()
                 if p not in self.load_errors and self._safe_to_delete(p)}
        jobs = sorted(by_prefix.items())
        if workers and int(workers) > 1 and len(jobs) > 1:
            from repro_torch.exp.executors import make_executor
            with make_executor(executor or "thread",
                               workers=int(workers)) as ex:
                futs = [ex.submit(_compact_prefix_job, self.root, prefix,
                                  recs) for prefix, recs in jobs]
                written = [f.result() for f in ex.as_completed(futs)]
        else:
            written = [_compact_prefix_job(self.root, prefix, recs)
                       for prefix, recs in jobs]
        for final, size in written:
            # freshly written from memory: fully covered, hence safe for
            # a later compact/gc in this process to delete or replace
            self._loaded_sizes[final] = size
            stale.discard(final)
        for path in stale:
            try:
                os.remove(path)
            except OSError:
                pass
        for sub in os.listdir(self.root):
            d = os.path.join(self.root, sub)
            if os.path.isdir(d) and not os.listdir(d):
                os.rmdir(d)


def _compact_prefix_job(root: str, prefix: str,
                        records: List[dict]) -> Tuple[str, int]:
    """Rewrite one prefix directory's canonical ``_compact.jsonl`` from
    the given (already key-sorted) records.  Module-level and built from
    plain JSON records so any executor backend — thread, process, or
    remote worker — can run it; returns ``(final_path, size)`` for the
    caller's shard bookkeeping."""
    d = os.path.join(root, prefix)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, "_compact.jsonl.tmp")
    with open(tmp, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, default=str) + "\n")
    final = os.path.join(d, "_compact.jsonl")
    os.replace(tmp, final)
    return final, os.path.getsize(final)


def open_store(path: Optional[str]) -> BaseResultStore:
    """Open a store by path, dispatching on layout.

    ``None`` → in-memory; an existing regular file or a ``.jsonl`` path
    → single-file; anything else (existing directory or a fresh
    extensionless path) → sharded.
    """
    if path is None:
        return ResultStore()
    if os.path.isdir(path):
        return ShardedResultStore(path)
    if os.path.isfile(path) or path.endswith(".jsonl"):
        return ResultStore(path)
    return ShardedResultStore(path)


def merge_stores(sources: Iterable[Union[str, BaseResultStore]],
                 out: Union[str, BaseResultStore]) -> BaseResultStore:
    """Merge any mix of single-file and sharded stores into ``out``
    (later sources win on key collisions — immaterial for
    content-addressed records, deterministic regardless), then compact
    the destination so per-host writer files collapse into canonical
    shards.  This is the multi-host workflow: each host sweeps into its
    own store (or its own writer files in a shared directory), then one
    ``merge`` produces the store every host can replay from.

    A source path that does not exist raises — a typo'd host path must
    not silently contribute an empty store to the consolidated sweep.
    Shard files a source could not read propagate into the
    destination's ``load_errors`` so callers can warn about them.
    """
    dest = open_store(out) if isinstance(out, str) else out
    for src in sources:
        if isinstance(src, str):
            if not os.path.exists(src):
                raise FileNotFoundError(f"merge source not found: {src}")
            store = open_store(src)
        else:
            store = src
        dest.update(store, persist=False)
        dest.load_errors.extend(store.load_errors)
    dest.compact()
    return dest
