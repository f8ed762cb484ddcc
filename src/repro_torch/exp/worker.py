"""Remote execution worker: ``python -m repro_torch.exp worker``.

Speaks the framed JSONL protocol (:mod:`repro_torch.exp.wire`) over
stdin/stdout — one task in, one result out, heartbeats from a side
thread so the controller can tell a busy worker from a dead one.  The
same loop serves every transport (local subprocess pipe, SSH channel):
the worker neither knows nor cares how its stdio is connected.

Stray output is a protocol hazard: anything a runner writes to stdout
would corrupt the message stream, so the worker keeps a private dup of
the real stdout for protocol lines and redirects file descriptor 1 to
stderr before executing tasks — covering Python prints, C-extension
writes, and subprocesses that inherit the worker's fds alike.

Fault injection (CI and chaos testing): set
``REPRO_EXP_FAULT=timeout:<prob>[:<sleep_s>],crash:<prob>`` and the
worker will, independently per task, either sleep ``sleep_s`` seconds
before running it (a stuck unit — caught by the controller's unit
deadline) or hard-exit the whole process (a dead worker — caught by
EOF/heartbeat loss and reassigned).  Injection lives only in this
module: in-process executors and the serial baseline never see it.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import socket
import sys
import threading
import time
import traceback
from typing import Optional

from repro_torch.exp.wire import decode_task, read_msg, write_msg

#: exit code used by the crash fault (distinguishable from real errors)
CRASH_EXIT = 17


class FaultInjector:
    """Parsed ``REPRO_EXP_FAULT`` spec: comma-separated
    ``kind:prob[:arg]`` entries.

    ``timeout:P[:S]`` — with probability P, sleep S seconds (default
    3600) before running the task, simulating a hung unit.
    ``crash:P`` — with probability P, ``os._exit`` the worker before
    running the task, simulating a dead machine.

    Draws are independent per task attempt (fresh OS entropy per
    worker), so a retried/reassigned unit is not doomed to re-fault.
    """

    def __init__(self, spec: str):
        self.p_timeout = 0.0
        self.sleep_s = 3600.0
        self.p_crash = 0.0
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            kind, prob = parts[0], float(parts[1])
            if kind == "timeout":
                self.p_timeout = prob
                if len(parts) > 2:
                    self.sleep_s = float(parts[2])
            elif kind == "crash":
                self.p_crash = prob
            else:
                raise ValueError(f"unknown fault kind {kind!r} in {spec!r}")
        self._rng = random.Random(int.from_bytes(os.urandom(8), "big"))

    @classmethod
    def from_env(cls, env_var: str = "REPRO_EXP_FAULT"
                 ) -> Optional["FaultInjector"]:
        spec = os.environ.get(env_var)
        return cls(spec) if spec else None

    def before_task(self) -> None:
        r = self._rng.random()
        if r < self.p_crash:
            sys.stderr.write("[worker] FAULT: injected crash\n")
            sys.stderr.flush()
            os._exit(CRASH_EXIT)
        if r < self.p_crash + self.p_timeout:
            sys.stderr.write(
                f"[worker] FAULT: injected {self.sleep_s:.0f}s stall\n")
            sys.stderr.flush()
            time.sleep(self.sleep_s)


def _heartbeat_loop(stream, lock: threading.Lock, interval: float) -> None:
    while True:
        time.sleep(interval)
        try:
            write_msg(stream, {"type": "heartbeat"}, lock)
        except Exception:       # noqa: BLE001 — pipe gone: controller died
            os._exit(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.exp worker")
    ap.add_argument("--heartbeat", type=float, default=2.0,
                    help="seconds between heartbeat messages")
    args = ap.parse_args(argv)

    # protocol stream = a private dup of the real stdout; fd 1 itself is
    # then pointed at stderr, so stray output at ANY level — Python
    # prints, C extensions writing to fd 1, subprocesses inheriting it —
    # lands on stderr instead of corrupting the message framing
    out = os.fdopen(os.dup(sys.stdout.fileno()), "w")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    sys.stdout = sys.stderr
    inp = sys.stdin
    out_lock = threading.Lock()

    try:
        write_msg(out, {"type": "hello", "pid": os.getpid(),
                        "host": socket.gethostname()}, out_lock)
    except BrokenPipeError:
        return 0                          # controller already gone
    if args.heartbeat > 0:
        threading.Thread(target=_heartbeat_loop,
                         args=(out, out_lock, args.heartbeat),
                         daemon=True).start()
    injector = FaultInjector.from_env()

    while True:
        msg = read_msg(inp)
        if msg is None or msg.get("type") == "shutdown":
            return 0
        if msg.get("type") != "task":
            continue                      # ignore unknown message types
        task_id = msg.get("id")
        try:
            fn, fargs, fkwargs = decode_task(msg)
        except BaseException as exc:      # noqa: BLE001 — shipped upstream
            write_msg(out, {"type": "result", "id": task_id, "ok": False,
                            "error": {"type": type(exc).__name__,
                                      "message": str(exc),
                                      "traceback": traceback.format_exc(
                                          limit=20)}}, out_lock)
            continue
        # ack = execution actually starting: the runner's module import
        # is paid, so the controller can arm the tight unit deadline now
        # (injected faults fire after the ack for the same reason — they
        # simulate stuck/dying *execution*, not slow imports)
        write_msg(out, {"type": "ack", "id": task_id}, out_lock)
        if injector is not None:
            injector.before_task()
        try:
            value = fn(*fargs, **fkwargs)
            # one strict encode (no default=) is both the serialization
            # and the fail-fast check mirroring the submit side: a value
            # that only survives the wire stringified (e.g. np.int64)
            # would silently differ from what in-process backends
            # deliver, so it becomes an error, never a coercion
            line = json.dumps({"type": "result", "id": task_id,
                               "ok": True, "value": value})
        except BaseException as exc:      # noqa: BLE001 — shipped upstream
            line = json.dumps(
                {"type": "result", "id": task_id, "ok": False,
                 "error": {"type": type(exc).__name__,
                           "message": str(exc),
                           "traceback": traceback.format_exc(limit=20)}},
                default=str)
        try:
            with out_lock:
                out.write(line + "\n")
                out.flush()
        except BrokenPipeError:
            return 0                      # controller already gone


if __name__ == "__main__":              # pragma: no cover — module CLI
    sys.exit(main())
