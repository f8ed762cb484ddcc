"""Pluggable executor backends for the experiment engine.

The engine's execution model is deliberately tiny: ``submit`` work,
iterate ``as_completed``, ``shutdown``.  Everything the engine needs —
crash-durable incremental persistence, failure isolation, determinism —
is expressed against that interface, so swapping *how* units run (in
process, in threads, in a process pool, or on a remote/batch service)
never touches the engine or the protocols.

The interface is async-capable by construction: ``submit`` only enqueues
and returns a :class:`concurrent.futures.Future`-compatible handle;
completion is decoupled and surfaces through ``as_completed`` in
whatever order units actually finish.  A remote or batch backend
implements it by returning futures resolved from a polling loop or a
callback — no engine changes required.

Built-in backends:

``serial``   — runs units in submission order, in process, when
               ``as_completed`` is iterated.  Zero concurrency, zero
               pickling requirements; bit-for-bit the historical
               single-worker engine behavior.
``thread``   — a ``ThreadPoolExecutor``.  Right for IO-bound runners
               (subprocess-spawning dry-run cells, future remote-API
               runners); shares the process's memoized dataset cache.
``process``  — a ``ProcessPoolExecutor`` with BLAS pinned to one thread
               per worker (units are tiny, library-level threading only
               makes workers thrash each other's cores).  The historical
               ``workers > 1`` behavior; requires runner and arguments
               to be picklable.
``remote``   — worker processes reached over a pluggable transport
               (local subprocess pipes by default, SSH for real remote
               hosts) speaking the pickle-free framed JSONL protocol of
               :mod:`repro_torch.exp.wire`.  Per-host capacity, heartbeats,
               unit deadlines, and dead-worker reassignment; see
               :class:`RemoteExecutor`.
"""
from __future__ import annotations

import itertools
import multiprocessing
import os
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import (
    FIRST_COMPLETED, Future, ProcessPoolExecutor, ThreadPoolExecutor, wait)
from typing import (
    Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence,
    Tuple, Type, Union)

from repro_torch.exp.wire import (
    RemoteTaskError, UnitTimeout, WorkerDied, encode_task, read_msg,
    write_msg)


class BaseExecutor:
    """Minimal executor contract: ``submit`` / ``as_completed`` /
    ``shutdown``.

    Subclasses must deliver every submitted future exactly once through
    ``as_completed`` (in any order) with either a result or an exception
    set.  Exceptions must be captured into the future, never raised out
    of ``as_completed`` — the engine turns them into per-unit failures.
    """

    #: registry name; subclasses override
    name = "base"

    #: per-unit wall-clock budget, seconds.  The engine sets this from
    #: its own ``unit_timeout_s`` config; backends able to preempt work
    #: (``remote``) enforce ``timeout + grace`` as a hard deadline,
    #: in-process backends rely on the engine's in-task watchdog instead.
    unit_timeout_s: Optional[float] = None

    #: True for backends whose startup is expensive enough that the
    #: engine should keep one instance alive across ``run()`` calls
    #: instead of building a fresh one per run.
    persistent = False

    @property
    def slots(self) -> int:
        """Usable parallel capacity — what cost-aware schedulers size
        their packing and speculation budgets against.  Pool backends
        report their worker count; serial is 1."""
        return max(1, int(getattr(self, "workers", 1) or 1))

    def submit(self, fn: Callable[..., Any], /, *args: Any,
               **kwargs: Any) -> Future:
        raise NotImplementedError

    def as_completed(self,
                     futures: Optional[Iterable[Future]] = None
                     ) -> Iterator[Future]:
        """Yield submitted futures as they finish.

        ``futures`` restricts delivery to that subset — required when
        several callers share one executor instance (each passes its own
        futures, so nobody steals or loses another caller's
        completions).  ``None`` means everything outstanding.
        """
        raise NotImplementedError

    def shutdown(self, wait: bool = True) -> None:  # noqa: ARG002
        """Release workers.  Idempotent."""

    # -- context-manager sugar -------------------------------------------
    def __enter__(self) -> "BaseExecutor":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()


class SerialExecutor(BaseExecutor):
    """In-process, submission-order execution (the ``workers=1`` path).

    ``submit`` only enqueues; the unit runs when ``as_completed`` reaches
    it.  That keeps the engine's persist-as-you-go semantics: each result
    is recorded before the next unit starts, so a crash mid-batch loses
    at most the in-flight unit.
    """

    name = "serial"

    def __init__(self, workers: int = 1, **_kwargs: Any):
        self._queue: list = []

    def submit(self, fn: Callable[..., Any], /, *args: Any,
               **kwargs: Any) -> Future:
        fut: Future = Future()
        self._queue.append((fut, fn, args, kwargs))
        return fut

    def as_completed(self,
                     futures: Optional[Iterable[Future]] = None
                     ) -> Iterator[Future]:
        wanted = None if futures is None else set(futures)
        remaining = []
        try:
            while self._queue:
                fut, fn, args, kwargs = self._queue.pop(0)
                if wanted is not None and fut not in wanted:
                    # someone else's work: leave it queued
                    remaining.append((fut, fn, args, kwargs))
                    continue
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn(*args, **kwargs))
                except BaseException as exc:  # noqa: BLE001 — engine unwraps
                    fut.set_exception(exc)
                yield fut
        finally:
            # restore other callers' items even if our consumer abandons
            # the generator mid-iteration (exception or early break)
            self._queue.extend(remaining)


class _TrackedExecutor(BaseExecutor):
    """Pending-set bookkeeping + the wait()-based ``as_completed`` shared
    by every backend whose futures complete asynchronously (pool threads
    or remote reader threads)."""

    def __init__(self) -> None:
        self._pending: set = set()
        self._pending_lock = threading.Lock()

    def _track(self, fut: Future) -> Future:
        with self._pending_lock:
            self._pending.add(fut)
        return fut

    def as_completed(self,
                     futures: Optional[Iterable[Future]] = None
                     ) -> Iterator[Future]:
        if futures is None:
            with self._pending_lock:
                waiting = set(self._pending)
        else:
            waiting = set(futures)
        while waiting:
            done, waiting = wait(waiting, return_when=FIRST_COMPLETED)
            with self._pending_lock:
                self._pending -= done
            for fut in done:
                yield fut


class _PoolBackedExecutor(_TrackedExecutor):
    """Shared submit plumbing over a concurrent.futures pool; subclasses
    provide ``_make_pool``."""

    def __init__(self, workers: int = 1, **kwargs: Any):
        super().__init__()
        self.workers = max(1, int(workers))
        self._pool = self._make_pool(**kwargs)

    def _make_pool(self, **kwargs: Any):
        raise NotImplementedError

    def submit(self, fn: Callable[..., Any], /, *args: Any,
               **kwargs: Any) -> Future:
        return self._track(self._pool.submit(fn, *args, **kwargs))

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


class ThreadExecutor(_PoolBackedExecutor):
    """Thread-pool backend for IO-bound or subprocess-spawning runners.

    Threads share the parent's memory, so per-process memoized state
    (e.g. the built dataset) is paid once, not once per worker.
    """

    name = "thread"

    def _make_pool(self, **_kwargs: Any) -> ThreadPoolExecutor:
        return ThreadPoolExecutor(max_workers=self.workers,
                                  thread_name_prefix="exp-unit")


_BLAS_LIMIT = None          # keeps the threadpoolctl limiter alive


def _worker_init() -> None:
    """Pin BLAS to one thread per pool worker: units are tiny (88-point
    grids), so library-level threading only makes N workers thrash each
    other's cores.  threadpoolctl works post-fork where env vars can't."""
    global _BLAS_LIMIT
    try:
        from threadpoolctl import threadpool_limits
        _BLAS_LIMIT = threadpool_limits(limits=1)
    except Exception:       # noqa: BLE001 — best-effort, optional dep
        pass


def _cuda_initialized() -> bool:
    """True once this process has initialised CUDA (torch is only asked
    if something already imported it: the engine never imports it)."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def _check_fork(ctx) -> None:
    """A forked child of a process that has initialised CUDA cannot use
    the card: refuse, never switch start method behind the caller."""
    if ctx.get_start_method() == "fork" and _cuda_initialized():
        raise RuntimeError(
            "the process backend forks its workers, but this process "
            "has initialised CUDA, which a forked child cannot use; pass "
            "mp_context='spawn' (or REPRO_EXP_MP=spawn), or use the "
            "serial, thread or remote backend")


def _resolve_mp_context(name: Optional[str]):
    name = name or os.environ.get("REPRO_EXP_MP") or "fork"
    try:
        ctx = multiprocessing.get_context(name)
    except ValueError:
        ctx = multiprocessing.get_context()
    _check_fork(ctx)
    return ctx


class ProcessExecutor(_PoolBackedExecutor):
    """Process-pool backend (fork by default — override with
    ``mp_context`` or the ``REPRO_EXP_MP`` env var).  Runner and
    arguments must be picklable; runners are passed by module-level
    reference for exactly this reason.  Forking after this process has
    initialised CUDA raises (:func:`_check_fork`)."""

    name = "process"

    def _make_pool(self, mp_context: Optional[str] = None,
                   **_kwargs: Any) -> ProcessPoolExecutor:
        self._mp = _resolve_mp_context(mp_context)
        return ProcessPoolExecutor(max_workers=self.workers,
                                   mp_context=self._mp,
                                   initializer=_worker_init)

    def submit(self, fn: Callable[..., Any], /, *args: Any,
               **kwargs: Any) -> Future:
        # the pool forks on demand: CUDA may have come up since it was made
        _check_fork(self._mp)
        return super().submit(fn, *args, **kwargs)


# ---------------------------------------------------------------------------
# remote execution: transports + controller
# ---------------------------------------------------------------------------
class WorkerTransport:
    """Factory for worker connections.  ``spawn`` starts one worker and
    returns a Popen-like handle with text-mode ``stdin``/``stdout``;
    the controller respawns through the same transport when a worker
    dies."""

    def __init__(self, heartbeat_s: float = 2.0):
        self.heartbeat_s = float(heartbeat_s)

    def spawn(self) -> subprocess.Popen:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


class LocalSubprocessTransport(WorkerTransport):
    """Spawn ``python -m repro_torch.exp worker`` on this machine, protocol
    over the subprocess pipe.  The worker inherits the parent's full
    ``sys.path`` via PYTHONPATH, so anything importable here (runners,
    test modules) is importable there."""

    def __init__(self, python: Optional[str] = None,
                 heartbeat_s: float = 2.0):
        super().__init__(heartbeat_s)
        self.python = python or sys.executable

    def spawn(self) -> subprocess.Popen:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in sys.path if p)
        return subprocess.Popen(
            [self.python, "-m", "repro_torch.exp", "worker",
             "--heartbeat", str(self.heartbeat_s)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=None, text=True, bufsize=1, env=env)

    def describe(self) -> str:
        return "local"


class SSHTransport(WorkerTransport):
    """Run the worker on a remote host over ``ssh``, protocol over the
    SSH channel's stdio — byte-identical framing to the local pipe, so
    heterogeneous hosts need only a Python with this repo importable.

    ``remote_command`` is the shell line executed on the host; the
    default assumes ``repro_torch`` is importable there (configure PYTHONPATH
    in the remote environment, or pass e.g.
    ``"cd ~/repo && PYTHONPATH=src python -m repro_torch.exp worker"``).
    ``ssh_cmd`` exists for non-standard clients (and lets tests drive
    the same code path through ``("sh", "-c")`` without a real host).
    """

    def __init__(self, host: str, remote_command: Optional[str] = None,
                 ssh_cmd: Sequence[str] = ("ssh", "-oBatchMode=yes"),
                 heartbeat_s: float = 2.0):
        super().__init__(heartbeat_s)
        self.host = host
        self.ssh_cmd = list(ssh_cmd)
        # `is None`, not falsiness: an explicit "" means "the host
        # argument already is the whole command" (wrapper transports)
        self.remote_command = remote_command if remote_command is not None \
            else f"python -m repro_torch.exp worker --heartbeat {self.heartbeat_s}"

    def spawn(self) -> subprocess.Popen:
        return subprocess.Popen(
            [*self.ssh_cmd, self.host, self.remote_command],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=None, text=True, bufsize=1)

    def describe(self) -> str:
        return f"ssh:{self.host}"


#: host spec grammar for --hosts: comma-separated ``local[*CAP]`` /
#: ``ssh:[user@]host[*CAP]`` entries; CAP = concurrent workers on that
#: host (default 1)
HostsSpec = Union[None, str,
                  Sequence[Union[WorkerTransport,
                                 Tuple[WorkerTransport, int]]]]


def parse_hosts(hosts: HostsSpec, *, workers: int = 1,
                python: Optional[str] = None, heartbeat_s: float = 2.0
                ) -> List[Tuple[WorkerTransport, int]]:
    """Resolve a hosts spec to ``(transport, capacity)`` pairs.

    ``None`` means ``workers`` local subprocess workers; a string is the
    ``--hosts`` grammar; a sequence passes prebuilt transports through
    (optionally as ``(transport, capacity)``)."""
    if hosts is None:
        return [(LocalSubprocessTransport(python, heartbeat_s),
                 max(1, int(workers)))]
    if not isinstance(hosts, str):
        out = []
        for entry in hosts:
            if isinstance(entry, WorkerTransport):
                out.append((entry, 1))
            else:
                tr, cap = entry
                out.append((tr, max(1, int(cap))))
        return out
    out = []
    for tok in hosts.split(","):
        tok = tok.strip()
        if not tok:
            continue
        cap = 1
        if "*" in tok:
            tok, _, cap_s = tok.rpartition("*")
            cap = max(1, int(cap_s))
        if tok in ("local", "localhost"):
            out.append((LocalSubprocessTransport(python, heartbeat_s), cap))
        elif tok.startswith("ssh:"):
            out.append((SSHTransport(tok[4:], heartbeat_s=heartbeat_s), cap))
        else:
            raise ValueError(
                f"bad host spec {tok!r} (want local[*N] or ssh:host[*N])")
    if not out:
        raise ValueError("empty hosts spec")
    return out


#: default for ``startup_grace_s``: extra slack for one-time worker
#: startup costs — between spawn and hello (interpreter + base imports,
#: slow ssh handshakes) for the heartbeat-silence check, and between
#: dispatch and the worker's ack (runner-module import) for the unit
#: deadline; once the ack arrives the tight ``timeout + grace`` deadline
#: is armed
_STARTUP_GRACE_S = 30.0


class _RemoteTask:
    __slots__ = ("fut", "line", "reassigns")

    def __init__(self, fut: Future, line: str):
        self.fut = fut
        self.line = line
        self.reassigns = 0


class _WorkerConn:
    """One live worker connection: a spawned process, its reader thread,
    and the single in-flight task slot."""

    def __init__(self, executor: "RemoteExecutor",
                 transport: WorkerTransport, strikes: int = 0):
        self.transport = transport
        self.strikes = strikes          # consecutive spawns with 0 completions
        self.completed = 0              # tasks finished since this spawn
        self.task_id: Optional[int] = None
        self.deadline: Optional[float] = None
        self.last_seen = time.monotonic()
        self.alive = True
        #: set on the worker's hello: tasks are dispatched only to ready
        #: workers, so unit deadlines measure execution, never startup
        self.ready = False
        #: set when the monitor kills this worker over a unit deadline:
        #: the *unit* was slow, the worker was healthy — no strike
        self.deadline_killed = False
        self.exit_handled = False
        self.proc = transport.spawn()   # may raise OSError — caller handles
        self.reader = threading.Thread(
            target=executor._reader_loop, args=(self,), daemon=True,
            name=f"exp-remote-{transport.describe()}")
        # NOT started here: the spawner registers the conn first, so an
        # instantly-dying worker's death handler can never observe (and
        # leave behind) an unregistered conn

    def start_reader(self) -> None:
        self.reader.start()

    def kill(self) -> None:
        try:
            self.proc.kill()
        except Exception:               # noqa: BLE001 — already gone
            pass


class RemoteExecutor(_TrackedExecutor):
    """Dispatch work to worker processes over a transport.

    The controller keeps ``capacity`` connections open per host (true
    process parallelism — each connection runs one task at a time), and
    runs two supervision loops:

    - a **reader thread per connection** consumes results, heartbeats,
      and EOFs.  EOF or a corrupt line means the worker died: its
      in-flight task is reassigned to the queue (up to ``max_reassign``
      times per task, then :class:`~repro_torch.exp.wire.WorkerDied`), and the
      slot is respawned — unless ``max_worker_strikes`` consecutive
      spawns died without completing anything (a systematically broken
      host is retired, not respawned forever).
    - a **monitor thread** watches heartbeats (a worker silent for
      ``heartbeat_timeout_s`` is presumed dead and killed, triggering
      the reassignment path) and unit deadlines: when the engine sets
      ``unit_timeout_s``, a task still running ``timeout + grace_s``
      after the worker acked execution start (dispatch + startup slack
      until then — first tasks pay the runner-module import) fails with
      :class:`~repro_torch.exp.wire.UnitTimeout` and its wedged worker is
      killed and respawned.  The grace leaves room for the engine's
      in-task watchdog to fire first with a cleaner error; the hard
      deadline is the backstop for workers too stuck to answer at all.

    Tasks travel as framed JSONL (:mod:`repro_torch.exp.wire`) — no pickling,
    so heterogeneous hosts work; submit fails fast on non-JSON
    arguments.  Fault-free runs are bit-identical to the in-process
    backends: JSON round-trips floats exactly and completion order never
    affects engine aggregation.
    """

    name = "remote"
    persistent = True                   # engine keeps it across run() calls

    @property
    def slots(self) -> int:
        """Live worker connections (each runs one task at a time)."""
        with self._lock:
            return max(1, len(self._conns))

    def __init__(self, workers: int = 1, hosts: HostsSpec = None,
                 python: Optional[str] = None, heartbeat_s: float = 2.0,
                 heartbeat_timeout_s: float = 30.0,
                 unit_timeout_s: Optional[float] = None,
                 timeout_grace_s: float = 15.0,
                 startup_grace_s: float = _STARTUP_GRACE_S,
                 max_reassign: int = 2,
                 max_worker_strikes: int = 3, **_kwargs: Any):
        super().__init__()
        self.unit_timeout_s = unit_timeout_s
        self.timeout_grace_s = float(timeout_grace_s)
        self.startup_grace_s = float(startup_grace_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_reassign = int(max_reassign)
        self.max_worker_strikes = int(max_worker_strikes)
        self._lock = threading.RLock()
        self._tasks: Dict[int, _RemoteTask] = {}
        self._queue: deque = deque()
        self._conns: List[_WorkerConn] = []
        #: respawns in flight (spawning happens outside the lock): while
        #: nonzero, an empty _conns list is transient, not terminal
        self._spawning = 0
        self._ids = itertools.count()
        self._shutdown = False
        for transport, cap in parse_hosts(hosts, workers=workers,
                                          python=python,
                                          heartbeat_s=heartbeat_s):
            for _ in range(cap):
                self._spawn_conn(transport, strikes=0)
        if not self._conns:
            raise RuntimeError("remote executor: no worker could be spawned")
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="exp-remote-monitor")
        self._monitor.start()

    # -- public contract -------------------------------------------------
    def submit(self, fn: Callable[..., Any], /, *args: Any,
               **kwargs: Any) -> Future:
        fut: Future = Future()
        # encode before taking the lock: non-serializable arguments fail
        # fast here, in the caller, and serialization cost never stalls
        # the reader/monitor paths (next() on the id counter is atomic
        # under the GIL)
        tid = next(self._ids)
        line = encode_task(tid, fn, args, kwargs)
        with self._lock:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            self._track(fut)
            if not self._conns and not self._spawning:
                # every transport retired: a queued task would never be
                # dispatched, so fail it now (via the future, like every
                # other per-task failure) instead of hanging the caller
                fut.set_exception(WorkerDied(
                    "no live workers remain (all transports retired)"))
                return fut
            self._tasks[tid] = _RemoteTask(fut, line)
            self._queue.append(tid)
            assignments = self._pump_locked()
        self._send_assignments(assignments)
        return fut

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            conns = list(self._conns)
            orphans = [self._tasks.pop(tid).fut
                       for tid in list(self._queue)
                       if tid in self._tasks]
            self._queue.clear()
        for fut in orphans:
            fut.set_exception(WorkerDied("executor shut down"))
        for conn in conns:
            try:
                write_msg(conn.proc.stdin, {"type": "shutdown"})
                conn.proc.stdin.close()
            except Exception:           # noqa: BLE001 — already dead
                pass
        for conn in conns:
            try:
                conn.proc.wait(timeout=3 if wait else 0.1)
            except Exception:           # noqa: BLE001 — didn't exit: kill
                conn.kill()

    # -- internals -------------------------------------------------------
    def _spawn_conn(self, transport: WorkerTransport,
                    strikes: int) -> Optional[_WorkerConn]:
        try:
            conn = _WorkerConn(self, transport, strikes)
        except OSError as exc:
            print(f"[exp] remote: spawn failed on {transport.describe()}: "
                  f"{exc}", file=sys.stderr)
            return None
        self._conns.append(conn)
        conn.start_reader()             # only after registration (above)
        return conn

    def _pump_locked(self) -> List[Tuple[_WorkerConn, int, _RemoteTask]]:
        """Assign queued tasks to idle ready workers (state only; caller
        must hold the lock) and return the assignments for
        :meth:`_send_assignments` to write *outside* the lock — a
        stalled transport write must block only its own dispatch, never
        the monitor/reader paths that would detect the stall."""
        out: List[Tuple[_WorkerConn, int, _RemoteTask]] = []
        for conn in self._conns:
            if not self._queue:
                break
            if conn.alive and conn.ready and conn.task_id is None:
                tid = self._queue.popleft()
                task = self._tasks.get(tid)
                if task is None:
                    continue
                conn.task_id = tid
                timeout = self.unit_timeout_s
                # provisional deadline includes startup slack (first
                # task on a fresh worker pays the runner-module
                # import); the worker's ack — execution actually
                # starting — tightens it to timeout + grace
                conn.deadline = (time.monotonic() + float(timeout)
                                 + self.timeout_grace_s
                                 + self.startup_grace_s
                                 ) if timeout else None
                out.append((conn, tid, task))
        return out

    def _send_assignments(
            self, assignments: List[Tuple[_WorkerConn, int, _RemoteTask]]
            ) -> None:
        """Perform the (potentially blocking) pipe writes for freshly
        assigned tasks.  Must be called WITHOUT the lock held."""
        for conn, tid, task in assignments:
            try:
                conn.proc.stdin.write(task.line + "\n")
                conn.proc.stdin.flush()
            except Exception:           # noqa: BLE001 — pipe gone
                fail_fut = None
                with self._lock:
                    if conn.task_id == tid:
                        conn.task_id = None
                        conn.deadline = None
                        if self._shutdown:
                            # the queue is dead: resolve, don't strand
                            t = self._tasks.pop(tid, None)
                            fail_fut = t.fut if t is not None else None
                        else:
                            # never started: free requeue
                            self._queue.appendleft(tid)
                if fail_fut is not None:
                    fail_fut.set_exception(WorkerDied(
                        "executor shut down with task in flight"))
                conn.kill()             # reader EOF runs the death path

    def _pump(self) -> None:
        with self._lock:
            assignments = self._pump_locked()
        self._send_assignments(assignments)

    def _complete(self, conn: _WorkerConn, msg: Dict[str, Any]) -> None:
        tid = msg.get("id")
        with self._lock:
            task = self._tasks.get(tid)
            if task is None or conn.task_id != tid:
                return                  # stale (already timed out/reassigned)
            del self._tasks[tid]
            conn.task_id = None
            conn.deadline = None
            conn.completed += 1
            conn.strikes = 0
        contaminated = False
        if msg.get("ok"):
            task.fut.set_result(msg.get("value"))
        else:
            err = msg.get("error") or {}
            if err.get("type") == "UnitTimeout":
                exc: BaseException = UnitTimeout(err.get("message", ""))
                # the worker's in-task watchdog fired: the stuck runner
                # thread is still alive inside that worker process —
                # retire it for a fresh spawn instead of piling further
                # tasks (and further leaked threads) onto it
                contaminated = True
            else:
                exc = RemoteTaskError(err.get("type", "Error"),
                                      err.get("message", ""),
                                      err.get("traceback", ""))
            task.fut.set_exception(exc)
        if contaminated:
            conn.kill()         # death path respawns and re-pumps
        else:
            self._pump()

    def _reader_loop(self, conn: _WorkerConn) -> None:
        try:
            while True:
                msg = read_msg(conn.proc.stdout)
                if msg is None:
                    break
                conn.last_seen = time.monotonic()
                mtype = msg.get("type")
                if mtype == "result":
                    self._complete(conn, msg)
                elif mtype == "ack":
                    with self._lock:
                        timeout = self.unit_timeout_s
                        if (conn.task_id == msg.get("id")
                                and conn.deadline is not None and timeout):
                            conn.deadline = (time.monotonic()
                                             + float(timeout)
                                             + self.timeout_grace_s)
                elif mtype == "hello":
                    with self._lock:
                        conn.ready = True
                    self._pump()
        except Exception:               # noqa: BLE001 — treat as death
            pass
        finally:
            self._handle_conn_exit(conn)

    def _handle_conn_exit(self, conn: _WorkerConn) -> None:
        to_fail: List[Tuple[Future, BaseException]] = []
        assignments: List[Tuple[_WorkerConn, int, _RemoteTask]] = []
        with self._lock:
            if conn.exit_handled:
                return
            conn.exit_handled = True
            conn.alive = False
            if conn in self._conns:
                self._conns.remove(conn)
            conn.kill()
            tid, conn.task_id = conn.task_id, None
            if tid is not None and tid in self._tasks:
                task = self._tasks[tid]
                if self._shutdown:
                    # nothing will ever dispatch a requeued task now:
                    # resolve the future so waiters don't hang forever
                    del self._tasks[tid]
                    to_fail.append((task.fut, WorkerDied(
                        "executor shut down with task in flight")))
                else:
                    task.reassigns += 1
                    if task.reassigns > self.max_reassign:
                        del self._tasks[tid]
                        to_fail.append((task.fut, WorkerDied(
                            f"worker ({conn.transport.describe()}) died "
                            f"and task exceeded {self.max_reassign} "
                            "reassignments")))
                    else:
                        self._queue.appendleft(tid)
            respawn: Optional[Tuple[WorkerTransport, int]] = None
            if not self._shutdown:
                strikes = (0 if conn.completed or conn.deadline_killed
                           else conn.strikes + 1)
                if strikes < self.max_worker_strikes:
                    # spawn happens outside the lock (fork/exec of
                    # python or ssh can take a while); _spawning keeps
                    # the empty-_conns state recognizably transient
                    respawn = (conn.transport, strikes)
                    self._spawning += 1
                else:
                    print(f"[exp] remote: retiring "
                          f"{conn.transport.describe()} after "
                          f"{strikes} consecutive dead spawns",
                          file=sys.stderr)
                if not self._conns and not self._spawning:
                    to_fail.extend(self._fail_queued_locked())
                else:
                    assignments = self._pump_locked()
        for fut, exc in to_fail:
            fut.set_exception(exc)
        self._send_assignments(assignments)
        if respawn is not None:
            self._respawn(*respawn)

    def _fail_queued_locked(
            self) -> List[Tuple[Future, BaseException]]:
        """All workers gone for good: collect every queued task for
        failure (caller resolves the futures outside the lock)."""
        out: List[Tuple[Future, BaseException]] = []
        for otid in list(self._queue):
            t = self._tasks.pop(otid, None)
            if t is not None:
                out.append((t.fut, WorkerDied("no live workers remain")))
        self._queue.clear()
        return out

    def _respawn(self, transport: WorkerTransport, strikes: int) -> None:
        """Replace a dead worker: spawn WITHOUT the lock held, then
        register (and only then start the reader) under it."""
        to_fail: List[Tuple[Future, BaseException]] = []
        assignments: List[Tuple[_WorkerConn, int, _RemoteTask]] = []
        try:
            conn: Optional[_WorkerConn] = _WorkerConn(self, transport,
                                                      strikes)
        except OSError as exc:
            print(f"[exp] remote: spawn failed on {transport.describe()}: "
                  f"{exc}", file=sys.stderr)
            conn = None
        kill_conn = None
        with self._lock:
            self._spawning -= 1
            if conn is not None:
                if self._shutdown:
                    kill_conn = conn    # raced shutdown: don't register
                else:
                    self._conns.append(conn)
                    conn.start_reader()
                    assignments = self._pump_locked()
            elif (not self._conns and not self._spawning
                    and not self._shutdown):
                to_fail.extend(self._fail_queued_locked())
        if kill_conn is not None:
            kill_conn.kill()
        for fut, exc in to_fail:
            fut.set_exception(exc)
        self._send_assignments(assignments)

    def _monitor_loop(self) -> None:
        while True:
            time.sleep(0.1)
            now = time.monotonic()
            to_fail: List[Tuple[Future, BaseException]] = []
            to_kill: List[_WorkerConn] = []
            with self._lock:
                if self._shutdown:
                    return
                for conn in self._conns:
                    if not conn.alive:
                        continue
                    if (conn.task_id is not None
                            and conn.deadline is not None
                            and now > conn.deadline):
                        task = self._tasks.pop(conn.task_id, None)
                        conn.task_id = None
                        conn.deadline = None
                        if task is not None:
                            to_fail.append((task.fut, UnitTimeout(
                                f"unit still running "
                                f"{self.unit_timeout_s}s + "
                                f"{self.timeout_grace_s}s grace after "
                                f"dispatch to {conn.transport.describe()}")))
                        conn.deadline_killed = True
                        to_kill.append(conn)   # wedged: kill + respawn
                    elif (conn.transport.heartbeat_s > 0
                          and now - conn.last_seen
                          > self.heartbeat_timeout_s
                          + (0 if conn.ready else self.startup_grace_s)):
                        # pre-hello spawns get startup slack: a slow ssh
                        # handshake / cold import is not a dead worker
                        # silent: presumed dead (workers spawned with
                        # heartbeats disabled are exempt — they are
                        # legitimately silent while busy)
                        to_kill.append(conn)
            for fut, exc in to_fail:
                fut.set_exception(exc)
            for conn in to_kill:
                conn.kill()


EXECUTORS: Dict[str, Type[BaseExecutor]] = {
    SerialExecutor.name: SerialExecutor,
    ThreadExecutor.name: ThreadExecutor,
    ProcessExecutor.name: ProcessExecutor,
    RemoteExecutor.name: RemoteExecutor,
}

#: a spec is a registry name, an executor instance, or None (= pick from
#: the worker count: the historical serial/process-pool split)
ExecutorSpec = Union[None, str, BaseExecutor]


def make_executor(spec: ExecutorSpec = None, *, workers: int = 1,
                  mp_context: Optional[str] = None,
                  **kwargs: Any) -> BaseExecutor:
    """Resolve an executor spec to a ready instance.

    ``None`` preserves historical engine behavior: serial at
    ``workers <= 1``, a process pool above.  Instances pass through
    untouched (caller owns their lifecycle).  Extra keyword arguments
    reach the backend constructor (e.g. ``hosts=`` for ``remote``);
    every backend tolerates the ones it does not use.
    """
    if isinstance(spec, BaseExecutor):
        return spec
    if spec is None:
        spec = ProcessExecutor.name if workers > 1 else SerialExecutor.name
    try:
        cls = EXECUTORS[spec]
    except KeyError:
        raise ValueError(
            f"unknown executor {spec!r} (have: {sorted(EXECUTORS)})"
        ) from None
    if kwargs.get("hosts") is not None and not issubclass(cls,
                                                          RemoteExecutor):
        # every backend tolerates unknown kwargs, but silently running a
        # "remote" sweep on local processes because --executor remote
        # was forgotten is not tolerable
        raise ValueError(
            f"hosts= only applies to the remote executor, not {spec!r} "
            "(pass --executor remote)")
    return cls(workers=workers, mp_context=mp_context, **kwargs)
