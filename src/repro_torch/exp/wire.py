"""Framed JSONL wire protocol for remote work-unit execution.

The controller (:class:`~repro_torch.exp.executors.RemoteExecutor`) and the
worker (``python -m repro_torch.exp worker``) speak newline-delimited JSON
messages over a byte stream — a subprocess pipe, an SSH channel, or any
other stdio transport.  The protocol is deliberately pickle-free:
callables travel as ``"module:qualname"`` references resolved by import
on the worker side, and every argument/result is plain JSON — so
heterogeneous hosts (different Python builds, different architectures)
interoperate as long as the code is importable on both ends.

Message types (one JSON object per line):

controller → worker
    ``{"type": "task", "id": N, "fn": "mod:qual", "args": [...],
    "kwargs": {...}}`` — execute one call.
    ``{"type": "shutdown"}`` — drain and exit cleanly.

worker → controller
    ``{"type": "hello", "pid": ..., "host": ...}`` — sent once on
    startup.
    ``{"type": "heartbeat"}`` — sent every few seconds from a side
    thread, including *while* a task is executing; a silent worker is a
    dead worker.
    ``{"type": "result", "id": N, "ok": true, "value": ...}`` or
    ``{"type": "result", "id": N, "ok": false, "error": {"type": ...,
    "message": ..., "traceback": ...}}``.

JSON is a value-faithful channel for this repo's payloads: floats
round-trip exactly (``repr``-based), dict insertion order is preserved,
and tuples arrive as lists (callers that care unpack, which works for
both).
"""
from __future__ import annotations

import importlib
import json
import threading
import types
from typing import Any, Dict, Optional, Tuple


class UnitTimeout(RuntimeError):
    """A work unit exceeded its wall-clock budget (raised by the
    engine's in-task watchdog or by the remote controller's deadline)."""


class WorkerDied(RuntimeError):
    """A remote worker died mid-task and the task's reassignment budget
    is exhausted (or no live worker remains to take it)."""


class RemoteTaskError(RuntimeError):
    """A task raised on the worker; carries the remote exception type
    and message (``.remote_type``, and the traceback in ``.args[0]``)."""

    def __init__(self, remote_type: str, message: str,
                 traceback_text: str = ""):
        super().__init__(f"{remote_type}: {message}"
                         + (f"\n{traceback_text}" if traceback_text else ""))
        self.remote_type = remote_type
        self.remote_message = message


# ---------------------------------------------------------------------------
# callable references (the pickle-free function channel)
# ---------------------------------------------------------------------------
def fn_ref(fn: Any) -> str:
    """``module:qualname`` reference for a module-level callable."""
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    # an instance-bound method is the poison case: its qualname resolves
    # to the unbound function on the worker, silently shifting every
    # argument by one — reject it here at submit time.  A module-bound
    # __self__ (builtins like abs) or class-bound one (classmethods)
    # re-resolves to the same bound callable and is fine.
    self_obj = getattr(fn, "__self__", None)
    instance_bound = (self_obj is not None
                      and not isinstance(self_obj, (types.ModuleType, type)))
    if not mod or not qual or "<" in qual or instance_bound:
        raise TypeError(
            f"remote execution needs a module-level callable, got {fn!r} "
            "(lambdas, locals and bound methods cannot be imported by name)")
    return f"{mod}:{qual}"


def resolve_ref(ref: str) -> Any:
    mod_name, _, qual = ref.partition(":")
    obj: Any = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


_CALLABLE_KEY = "__callable__"


def _encode_value(v: Any) -> Any:
    if callable(v):
        return {_CALLABLE_KEY: fn_ref(v)}
    return v


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict) and set(v) == {_CALLABLE_KEY}:
        return resolve_ref(v[_CALLABLE_KEY])
    return v


def encode_task(task_id: int, fn: Any, args: Tuple[Any, ...],
                kwargs: Dict[str, Any]) -> str:
    """Serialize one call to its wire line.  Raises ``TypeError`` at
    submit time (fail fast, in the controller) if anything is neither
    JSON-serializable nor a module-level callable."""
    msg = {
        "type": "task", "id": task_id, "fn": fn_ref(fn),
        "args": [_encode_value(a) for a in args],
        "kwargs": {k: _encode_value(v) for k, v in kwargs.items()},
    }
    return json.dumps(msg)


def decode_task(msg: Dict[str, Any]) -> Tuple[Any, list, Dict[str, Any]]:
    fn = resolve_ref(msg["fn"])
    args = [_decode_value(a) for a in msg.get("args", [])]
    kwargs = {k: _decode_value(v)
              for k, v in (msg.get("kwargs") or {}).items()}
    return fn, args, kwargs


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def write_msg(stream, obj: Dict[str, Any],
              lock: Optional[threading.Lock] = None) -> None:
    """Write one message line and flush.  ``lock`` serializes writers
    sharing a stream (the worker's result loop vs its heartbeat
    thread)."""
    line = json.dumps(obj, default=str) + "\n"
    if lock is None:
        stream.write(line)
        stream.flush()
    else:
        with lock:
            stream.write(line)
            stream.flush()


def read_msg(stream) -> Optional[Dict[str, Any]]:
    """Read the next message; ``None`` on EOF (peer gone).  A corrupt
    line is a protocol error — the connection is considered dead."""
    line = stream.readline()
    if not line:
        return None
    try:
        msg = json.loads(line)
    except json.JSONDecodeError:
        return None
    if not isinstance(msg, dict):
        return None
    return msg
