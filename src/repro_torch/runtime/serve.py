"""Serving loops: continuous batching with a retained lockstep reference.

Port of ``repro/runtime/serve.py`` to torch; the behaviour, the step clock
and the bit-identity contract are the reference's.  The servers run on
``cuda`` unless given ``device="cpu"``.  They cast the parameters to the
compute dtype once at load (``models.model.precast``) and keep an f32
cache (KV, recurrent state, the vlm's image K/V) that each step updates
in place.  Each step is ``Model.decode_step`` plus its argmax through the
server's :class:`~repro_torch.runtime.graph.StepGraph`: on the card one
CUDA graph a server, captured at the first step and replayed at every
step, as the reference wraps the step in ``jax.jit``; on the CPU eagerly.

``BatchedServer`` is a continuous-batching greedy server: every slot
carries its own position and KV-cache occupancy, requests are admitted
mid-flight via the ``submit()/step()/drain()`` streaming API, and the
flash-decode CUDA kernel (``repro_torch.kernels.ops.decode_attention``) can
run the generation path with per-slot ``length`` instead of a shared
position.  ``run()`` stays as a thin closed-batch compat wrapper.

``LockstepServer`` retains the original loop — one shared ``pos``, a
closed-batch ``run()``, hard truncation at ``S-1`` — as the bit-identity
reference: on closed batches without slot reuse every slot consumes one
token per step, so the per-slot positions coincide with the shared
position and the continuous server's greedy outputs are bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import (
    ATTENTION_FAMILIES, Model, compute_dtype, precast)
from repro_torch.runtime.graph import StepGraph


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # step-clock bookkeeping (set by the continuous server; units = decode
    # steps, which are wall-clock-independent and therefore deterministic)
    arrived: Optional[int] = None      # submit() time
    started: Optional[int] = None      # slot admission time
    finished: Optional[int] = None     # completion time


class LockstepServer:
    """Original lockstep loop (shared position) — bit-identity reference.

    All slots advance one shared ``pos`` together; the whole batch hard-
    truncates when it reaches ``S-1``.  Late-admitted requests inherit the
    current shared position, so only batches without slot reuse are served
    at correct positions — exactly the regime the continuous server's
    ``run()`` is pinned bit-identical against.  The step takes ``pos`` as
    a 0-d int32 tensor, as the reference's ``jnp.asarray(pos, jnp.int32)``;
    ``self.pos`` stays the host int callers read.
    """

    def __init__(self, model: Model, params, *, batch_size: int = 4,
                 max_seq: int = 256, opts: ModelOpts = ModelOpts(),
                 eos_id: Optional[int] = None, device=None):
        self.model = model
        self.device = resolve_device(device)
        self.params = _load(model, params, self.device)
        self.B = batch_size
        self.S = max_seq
        self.opts = opts
        self.eos_id = eos_id
        self.cache = model.init_cache(batch_size, max_seq, torch.float32,
                                      self.device)
        self.pos = 0                       # shared position (lockstep batch)
        self.step_graph = StepGraph(model, self.params, self.cache, opts,
                                    batch=batch_size, per_slot=False,
                                    device=self.device)

    def reset(self) -> None:
        """Rewind for a fresh closed batch (epoch serving,
        ``serve.py:68``): position 0 and every cache entry zeroed in
        place, the values of a fresh ``init_cache`` at the addresses the
        step's graph holds."""
        self.pos = 0
        for v in self.cache.values():
            v.zero_()

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve a closed batch of requests to completion (greedy)."""
        queue = list(requests)
        active: List[Optional[Request]] = [None] * self.B
        results: Dict[int, List[int]] = {}
        cursor = np.zeros(self.B, np.int64)      # per-slot prompt cursor
        token = np.zeros((self.B, 1), np.int32)

        def admit():
            for i in range(self.B):
                if active[i] is None and queue:
                    r = queue.pop(0)
                    active[i] = r
                    cursor[i] = 0
                    token[i, 0] = r.prompt[0]

        admit()
        while any(a is not None for a in active) or queue:
            nxt = self.step_graph.step(token, self.pos)
            self.pos += 1
            for i in range(self.B):
                r = active[i]
                if r is None:
                    continue
                cursor[i] += 1
                if cursor[i] < len(r.prompt):
                    token[i, 0] = r.prompt[cursor[i]]    # prompt feeding
                else:
                    t = int(nxt[i])
                    r.output.append(t)
                    token[i, 0] = t
                    if len(r.output) >= r.max_new_tokens or \
                            (self.eos_id is not None and t == self.eos_id):
                        results[r.rid] = list(r.output)
                        active[i] = None
            if self.pos >= self.S - 1:
                for i in range(self.B):
                    if active[i] is not None:
                        results[active[i].rid] = list(active[i].output)
                        active[i] = None
                break
            admit()
        return results


class BatchedServer:
    """Continuous-batching greedy server with per-slot positions.

    Streaming API: ``submit(request)`` enqueues, ``step()`` admits queued
    requests into free slots and runs ONE fused batched decode step
    (returning the requests that finished on it), ``drain()`` steps until
    the queue and all slots are empty.  A slot frees the moment its
    request finishes — the next queued request is admitted at position 0
    on the very next step, while its co-batched neighbours keep decoding
    at their own positions.

    ``run()`` is a closed-batch compat wrapper; on batches without slot
    reuse its greedy outputs are bit-identical to :class:`LockstepServer`
    (the per-slot mask rows and rope positions coincide with the shared
    position, and the argmax over identical logits is deterministic).

    ``use_kernel=True`` puts the flash-decode CUDA kernel on the
    generation path with per-slot ``length``; it is forced off for
    sliding-window configs and for families other than dense and moe
    (``serve.py:161-164``): the ssm decode step runs no kernel.  On CPU
    tensors the kernel's wrapper runs its plain version and counts that
    apart (``kernels.decode_attention.COUNT``).

    Families with per-slot support (``SLOT_FAMILIES``): dense and moe (KV
    caches) and ssm (position-free recurrent state, re-zeroed per slot on
    admission).  An moe decode step puts each slot in its own routing
    group (``moe._num_groups``, up to 32 slots), so its neighbours never
    change a slot's tokens.  Every other family (``continuous`` False)
    serves through an internal :class:`LockstepServer` behind ``run()``,
    and ``submit``/``step``/``drain`` raise RuntimeError
    (``serve.py:160-168``): hybrid and vlm, whose decode step takes one
    shared position; audio, an encoder, fails there as in the reference,
    in ``Model.init_cache``.  ``step_graph`` is the server's decode step
    (the lockstep server's behind the fallback).  ``_reset_slot`` zeroes
    a slot on the step's stream, so it lands before the next replay.
    """

    SLOT_FAMILIES = ("dense", "moe", "ssm")

    def __init__(self, model: Model, params, *, batch_size: int = 4,
                 max_seq: int = 256, opts: ModelOpts = ModelOpts(),
                 eos_id: Optional[int] = None,
                 use_kernel: Optional[bool] = None, device=None):
        self.model = model
        self.device = resolve_device(device)
        self.B = batch_size
        self.S = max_seq
        self.opts = opts
        self.eos_id = eos_id
        cfg = model.cfg
        if use_kernel is None:
            use_kernel = opts.use_kernel
        self.use_kernel = bool(use_kernel and cfg.family in ATTENTION_FAMILIES
                               and not cfg.sliding_window)
        self.continuous = cfg.family in self.SLOT_FAMILIES
        self._lockstep: Optional[LockstepServer] = None
        if not self.continuous:
            self._lockstep = LockstepServer(
                model, params, batch_size=batch_size, max_seq=max_seq,
                opts=opts, eos_id=eos_id, device=self.device)
            self.step_graph = self._lockstep.step_graph
            return
        self.params = _load(model, params, self.device)
        self.cache = model.init_cache(batch_size, max_seq, torch.float32,
                                      self.device)
        self.steps = 0                     # completed decode steps
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * self.B
        self.results: Dict[int, List[int]] = {}
        self._cursor = np.zeros(self.B, np.int64)   # per-slot prompt cursor
        self._token = np.zeros((self.B, 1), np.int32)
        self._pos = np.zeros(self.B, np.int32)      # per-slot position
        self._dopts = dataclasses.replace(opts, use_kernel=self.use_kernel)
        self.step_graph = StepGraph(model, self.params, self.cache,
                                    self._dopts, batch=batch_size,
                                    per_slot=True, device=self.device)

    # ------------------------------------------------------------------
    # Streaming API
    # ------------------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Enqueue a request; it is admitted on the next free slot."""
        self._check_continuous()
        if request.arrived is None:
            request.arrived = self.steps
        self.queue.append(request)

    def step(self) -> List[Request]:
        """Admit queued requests, run one fused decode step.

        Returns the requests that finished on this step (streamed out in
        slot order).  A no-op (empty list) when nothing is queued/active.
        """
        self._check_continuous()
        self._admit()
        if not any(a is not None for a in self.active):
            return []
        nxt = self.step_graph.step(self._token, self._pos)
        self.steps += 1
        finished: List[Request] = []
        for i in range(self.B):
            r = self.active[i]
            if r is None:
                continue
            self._pos[i] += 1
            self._cursor[i] += 1
            if self._cursor[i] < len(r.prompt):
                self._token[i, 0] = r.prompt[self._cursor[i]]  # prompt feed
            else:
                t = int(nxt[i])
                r.output.append(t)
                self._token[i, 0] = t
                if len(r.output) >= r.max_new_tokens or \
                        (self.eos_id is not None and t == self.eos_id):
                    self._finish(i, finished)
                    continue
            if self._pos[i] >= self.S - 1:
                # this slot's KV budget is exhausted: truncate ONLY this
                # request (the lockstep loop flushed the whole batch here)
                self._finish(i, finished)
        return finished

    def drain(self) -> Dict[int, List[int]]:
        """Step until every queued/active request has finished."""
        self._check_continuous()
        out: Dict[int, List[int]] = {}
        while any(a is not None for a in self.active) or self.queue:
            for r in self.step():
                out[r.rid] = list(r.output)
        return out

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Closed-batch compat wrapper: submit everything, drain."""
        if not self.continuous:
            return self._lockstep.run(requests)
        for r in requests:
            self.submit(r)
        return self.drain()

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _check_continuous(self) -> None:
        if not self.continuous:
            raise RuntimeError(
                f"{self.model.cfg.family} serves via the lockstep fallback; "
                "use run()")

    def _admit(self) -> None:
        for i in range(self.B):
            if self.active[i] is None and self.queue:
                r = self.queue.pop(0)
                self.active[i] = r
                self._cursor[i] = 0
                self._pos[i] = 0
                self._token[i, 0] = r.prompt[0]
                r.started = self.steps
                self._reset_slot(i)

    def _reset_slot(self, i: int) -> None:
        """``serve.py:273``.  KV entries at/above the slot's position are
        masked out and overwritten as it advances; the ssm family's
        recurrent state would carry across occupants, so it is re-zeroed
        (every cache entry ``[:, i]``, in place)."""
        if self.model.cfg.family != "ssm":
            return
        for v in self.cache.values():
            v[:, i].zero_()

    def _finish(self, i: int, finished: List[Request]) -> None:
        r = self.active[i]
        r.done = True
        r.finished = self.steps
        self.results[r.rid] = list(r.output)
        self.active[i] = None
        finished.append(r)


def _load(model: Model, params, device: torch.device):
    """Parameters on the device, cast once to the compute dtype."""
    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(device)
    return precast(to(params), compute_dtype(model.cfg))
