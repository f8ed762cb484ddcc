"""The closed loop of clients around the port's continuous-batching
server, on the host's clock.

Every client holds one request at a time and submits its next the moment
the last one finishes.  The server is driven only through ``submit()``
and ``step()``; what a step did is read from the requests it holds
(``started``, ``output``, ``done``) and from ``server.steps``.  Each
step's end is stamped after ``step()`` returns, which waits on the card
for the step's tokens.

Before the window: one step of one-token requests on every slot, which
captures the server's step graph (and builds the decode kernel on a
checkout's first run), then the mix's warm-up steps.  In the window,
per step: its end, the lengths of the slots it served, and the output
tokens it gave; per request: submit time, first token, the gaps between
its tokens.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from harness.trace import Trace, Window


@dataclass
class Record:
    """What the window saw.  Times in seconds from the window's start."""
    slots: int
    window_s: float = 0.0
    step_end: List[float] = field(default_factory=list)
    step_dt: List[float] = field(default_factory=list)
    step_lengths: List[np.ndarray] = field(default_factory=list)
    step_outputs: List[int] = field(default_factory=list)
    step_traced: List[bool] = field(default_factory=list)
    itl_s: List[float] = field(default_factory=list)
    ttft_s: List[float] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    steps_before: int = 0            # server.steps at the window's start
    trace: Optional[Trace] = None


class ClosedLoop:
    def __init__(self, server, traffic, request_cls):
        self.server = server
        self.traffic = traffic
        self.Request = request_cls
        self.next_id = 0
        self.waiting: List = []      # submitted, not yet in a slot
        self.running: List = []      # in a slot
        self.submitted: Dict[int, float] = {}
        self.last_token: Dict[int, tuple] = {}   # rid -> (tokens, time)
        self.served: List = []       # every request that got a slot

    def _submit(self, now: float) -> None:
        i = self.next_id
        self.next_id += 1
        _, n_out = self.traffic.lengths(i)
        r = self.Request(rid=i, prompt=self.traffic.prompt(i),
                         max_new_tokens=n_out)
        self.submitted[i] = now
        self.waiting.append(r)
        self.server.submit(r)

    def capture(self) -> None:
        """One step of one-token requests on every slot: the step graph's
        capture, before any request of the mix."""
        for i in range(self.server.B):
            self.server.submit(self.Request(rid=-1 - i, prompt=[0],
                                            max_new_tokens=1))
        self.server.step()
        if any(a is not None for a in self.server.active) or \
                self.server.queue:
            raise RuntimeError("the capture step left requests behind")

    def start(self) -> None:
        now = time.perf_counter()
        for _ in range(self.server.B):
            self._submit(now)

    def step(self, rec: Optional[Record] = None,
             window_t0: float = 0.0) -> None:
        finished = self.server.step()
        now = time.perf_counter()
        steps = self.server.steps
        still = []
        for r in self.waiting:
            if r.started is None:
                still.append(r)
            else:
                self.running.append(r)
                self.served.append(r)
        self.waiting = still
        lengths = np.fromiter((steps - r.started for r in self.running),
                              np.int64, len(self.running))
        outputs = 0
        for r in self.running:
            n = len(r.output)
            if n == 0 or self.last_token.get(r.rid, (0, None))[0] == n:
                continue
            outputs += 1
            prev = self.last_token.get(r.rid)
            self.last_token[r.rid] = (n, now)
            if rec is None:
                continue
            if n == 1:
                rec.ttft_s.append(now - self.submitted[r.rid])
            elif prev is not None and prev[1] >= window_t0:
                rec.itl_s.append(now - prev[1])
        if rec is not None:
            rec.step_end.append(now - window_t0)
            prev_end = rec.step_end[-2] if len(rec.step_end) > 1 else 0.0
            rec.step_dt.append(rec.step_end[-1] - prev_end)
            rec.step_lengths.append(lengths)
            rec.step_outputs.append(outputs)
        done = [r for r in self.running if r.done]
        if done:
            self.running = [r for r in self.running if not r.done]
            for r in done:
                if rec is not None and \
                        len(r.output) < r.max_new_tokens:
                    rec.failed += 1
                self._submit(now)
        if len(finished) != len(done):
            raise RuntimeError(f"the server finished {len(finished)} "
                               f"requests; the loop saw {len(done)}")

    def window(self, seconds: float, trace_steps: int = 0) -> Record:
        """Steps until ``seconds`` have passed; with ``trace_steps``, that
        many steps from the window's middle run under the profiler."""
        rec = Record(slots=self.server.B, steps_before=self.server.steps)
        ids_before = {r.rid for r in self.running}
        win: Optional[Window] = None
        done = not trace_steps
        t0 = time.perf_counter()
        while True:
            # the profiled steps and the one after them, whose time holds
            # the profiler's stop, are marked traced
            traced = win is not None and win.steps <= trace_steps
            if not done and win is None and \
                    time.perf_counter() - t0 >= seconds / 2:
                win = Window()
                win.start()
                traced = True
            self.step(rec, t0)
            rec.step_traced.append(traced)
            if traced and win.steps < trace_steps:
                win.steps += 1
                if win.steps == trace_steps:
                    win.stop()
            elif traced:
                win.steps += 1
                done = True
            if done and time.perf_counter() - t0 >= seconds:
                break
        rec.window_s = rec.step_end[-1]
        if win is not None:
            win.steps = trace_steps
            rec.trace = win.read()
        seen = ids_before | {r.rid for r in self.served
                             if r.started >= rec.steps_before}
        rec.attempted = len(seen)
        return rec
