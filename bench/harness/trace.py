"""A profiler window over a block of served steps, read back as plain
intervals.

``Window`` starts ``torch.profiler`` (host ops and device activity)
before a step and stops it after the block's last step, whose end waits
on the card, then exports the chrome trace into a temporary directory
and keeps only what the readers need:

* ``device``: every kernel, copy and memset on the card (name, start,
  duration, in microseconds);
* ``runtime``: the host's CUDA runtime and driver calls (name, start,
  duration);
* ``host``: host ops and annotations, to label the card's idle gaps;
* ``wall_s``: the window's length;
* ``steps``: how many served steps ran inside it.

Busy time is the union of the device intervals, so overlapping kernels
count once; ``gaps`` are the spans of the window in which nothing ran on
the card.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")

Interval = Tuple[str, float, float]          # name, start us, duration us


@dataclass
class Trace:
    device: List[Interval] = field(default_factory=list)
    runtime: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    wall_s: float = 0.0
    steps: int = 0
    start_us: float = 0.0          # the window's bounds on the trace's clock
    end_us: float = 0.0


def read_chrome(events: List[dict]) -> Trace:
    """The intervals of a chrome trace's complete events."""
    tr = Trace()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append(item)
        elif cat in RUNTIME_CATS:
            tr.runtime.append(item)
        elif cat in HOST_CATS:
            tr.host.append(item)
    return tr


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """Merged (start, end) spans of the intervals, in order."""
    spans = sorted((s, s + d) for _, s, d in intervals)
    out: List[List[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(tr: Trace) -> float:
    """Microseconds of the window in which some operation ran on the
    card."""
    return sum(max(0.0, min(e, tr.end_us) - max(s, tr.start_us))
               for s, e in union(tr.device))


def gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The idle spans of the window: between the window's start, the
    merged device spans and its end."""
    out, t = [], tr.start_us
    for s, e in union(tr.device):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if tr.end_us > t:
        out.append((t, tr.end_us))
    return out


def label(tr: Trace, at: float) -> str:
    """What the host was doing at ``at``: the shortest host op or
    annotation that spans it, else the runtime call that does."""
    best: Optional[Interval] = None
    for item in tr.host + tr.runtime:
        _, s, d = item
        if s <= at <= s + d and (best is None or d < best[2]):
            best = item
    return best[0] if best else "host: outside any op"


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, in seconds."""
    by_name: dict = {}
    for name, _, d in tr.device:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    idle = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[k[:200], v / 1e6] for k, v in ops],
            "idle_gaps": [[label(tr, (s + e) / 2)[:200], (e - s) / 1e6]
                          for s, e in idle]}


class Window:
    """Profile a block of steps: ``start()`` before the first, ``stop()``
    after the last (which has waited on the card), ``read()`` after the
    measured window, since writing and reading the trace takes seconds.
    The block runs inside the annotation ``WINDOW_MARK``, whose span on
    the trace's clock is the window."""

    def __init__(self):
        self._prof = None
        self._mark = None
        self._t0 = self._wall = 0.0
        self.steps = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._mark = record_function(WINDOW_MARK)
        self._mark.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """End the profiled block; ``read()`` it once the window is over."""
        import torch
        torch.cuda.synchronize()
        self._wall = time.perf_counter() - self._t0
        self._mark.__exit__(None, None, None)
        self._prof.stop()

    def read(self) -> Trace:
        wall = self._wall
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        self._prof = self._mark = None
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        tr = read_chrome(events)
        tr.steps = self.steps
        marks = [(s, d) for name, s, d in tr.host if name == WINDOW_MARK]
        if marks:
            tr.start_us, d = marks[0]
            tr.end_us = tr.start_us + d
        else:
            tr.start_us = min((s for _, s, _ in tr.device), default=0.0)
            tr.end_us = tr.start_us + wall * 1e6
        tr.host = [h for h in tr.host if h[0] != WINDOW_MARK]
        tr.wall_s = (tr.end_us - tr.start_us) / 1e6
        return tr


WINDOW_MARK = "bench.traced_steps"
