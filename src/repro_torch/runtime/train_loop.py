"""Fault-tolerant training loop (port of ``repro/runtime/train_loop.py``).

* auto-resume from the newest complete checkpoint (atomic writes, in the
  reference's format, so a run may resume from the reference's
  checkpoints and the other way round),
* periodic checkpointing and pruning,
* optional int8 gradient compression with error feedback,
* straggler detection and simulated failure injection,
* elastic restart: ``run()`` may be re-entered on another mesh
  (``run(shardings=ShardCtx(mesh, rules))``, a mesh of any shape over the
  gloo or NCCL group of the moment); the checkpoint re-places its leaves
  under the new placements.

A step is ``torch.autograd.grad`` of ``Model.loss`` with respect to the
f32 masters, then the cosine schedule and AdamW, which update the state
IN PLACE where the reference donates its buffers to a jitted step.  On a
mesh the state and each batch are DTensors, each gradient is
redistributed to its master's placements (FSDP's reduce-scatter), and
rank 0 alone writes the metrics and the checkpoints.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (
    latest_step, prune_checkpoints, restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import SyntheticLMData, place_batch
from repro_torch.device import resolve_device
from repro_torch.distrib.logical import (
    NOSHARD, ShardCtx, param_shardings, place)
from repro_torch.launch.steps import batch_shardings, input_specs
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, cosine_schedule)
from repro_torch.optim.compress import compress_grads, init_error_feedback
from repro_torch.runtime.fault import (
    FailureInjector, SimulatedCrash, StragglerDetector)
from repro_torch.tree import leaves, tree_map, unflatten


def _host(x) -> float:
    """A metric's value on the host; a DTensor's through ``full_tensor``,
    which every rank enters."""
    from torch.distributed.tensor import DTensor
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 20
    keep_ckpts: int = 3
    out_dir: str = "runs/default"
    log_every: int = 10
    compress_grads: bool = False
    seed: int = 0
    schedule_total: int = 10_000
    warmup: int = 20


class TrainLoop:
    """``train_loop.py:48``.  ``device`` defaults to ``cuda`` and raises
    without a card (``device.resolve_device``)."""

    def __init__(self, model: Model, data: SyntheticLMData,
                 cfg: TrainLoopConfig = TrainLoopConfig(),
                 opts: ModelOpts = ModelOpts(remat="none"),
                 ocfg: AdamWConfig = AdamWConfig(),
                 ctx=None,
                 failure: Optional[FailureInjector] = None,
                 n_hosts: int = 1,
                 device: Any = None):
        self.model = model
        self.data = data
        self.cfg = cfg
        self.opts = opts
        self.ocfg = ocfg
        self.ctx = self._ctx = ctx or NOSHARD
        self.failure = failure
        self.device = resolve_device(device)
        self.detector = StragglerDetector(n_hosts)
        os.makedirs(cfg.out_dir, exist_ok=True)
        self._metrics_path = os.path.join(cfg.out_dir, "metrics.jsonl")

    def train_step(self, state: Dict[str, Any], batch) -> Dict[str, Any]:
        """One step (``train_loop.py:67``), IN PLACE on ``state``: the loss
        and its gradient, compression when asked, the schedule at the
        step's ``count`` and AdamW.  ``state["err"]`` is read only with
        ``compress_grads``.  Returns {"loss", "grad_norm", "lr"}, f32
        device tensors: nothing here waits on the device."""
        mesh = self.ctx.mesh
        params = state["params"]
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        with self._replicated():
            with torch.enable_grad():
                loss = self.model.loss(params, batch, self.ctx, self.opts)
                # a leaf the loss never reads (audio's token embedding)
                # gets a zero gradient, as jax.grad gives it
                grads = torch.autograd.grad(loss, flat,
                                            materialize_grads=True)
            if mesh is not None:
                grads = [g.redistribute(mesh, p.placements)
                         for g, p in zip(grads, flat)]
            grads = unflatten(params, grads)
            if self.cfg.compress_grads:
                grads, state["err"] = compress_grads(grads, state["err"])
            lr_scale = cosine_schedule(state["opt"]["count"],
                                       warmup=self.cfg.warmup,
                                       total=self.cfg.schedule_total)
            m = adamw_update(grads, state["opt"], params, self.ocfg,
                             lr_scale)
        m["loss"] = loss.detach()
        return m

    def _replicated(self):
        """On a mesh, the step's plain tensors (0-d scalars, masks) read
        as replicated DTensors, as in the dry-run's trace."""
        if self.ctx.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        return implicit_replication()

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded f32 params on ``generator.device``, zero AdamW state and
        error feedback."""
        params = self.model.init(generator)
        return {"params": params, "opt": adamw_init(params),
                "err": init_error_feedback(params)}

    def state_like(self) -> Dict[str, Any]:
        """The state's structure, shapes and names as ``meta`` tensors: what
        a restore reads into, with nothing drawn (``jax.eval_shape`` in the
        reference)."""
        like = self.model.abstract_params
        return {"params": like(),
                "opt": {"m": like(), "v": like(),
                        "count": torch.empty((), dtype=torch.int32,
                                             device="meta")},
                "err": like()}

    def state_shardings(self, ctx: ShardCtx) -> Dict[str, Any]:
        """The state's placements on ``ctx.mesh``: the params' for
        ``params``, ``opt.m``, ``opt.v`` and ``err``; ``count``
        replicated."""
        p = param_shardings(self.model.param_spec(), ctx)
        return {"params": p, "opt": {"m": p, "v": p,
                                     "count": ctx.sharding_for((), ())},
                "err": p}

    def batch(self, step: int) -> Dict[str, Any]:
        """The batch of ``step`` on the loop's device, placed on the mesh
        of ``self.ctx`` as ``launch.steps.batch_shardings`` says."""
        if self.ctx.mesh is None:
            return place_batch(self.data.batch_at(step), self.device)
        d = self.data
        shape = ShapeSpec("train", "train", d.seq_len, d.global_batch)
        sh = batch_shardings(self.model.cfg, shape,
                             input_specs(self.model.cfg, shape), self.ctx)
        return place_batch(d.batch_at(step), self.device, sh, self.ctx.mesh)

    def run(self, generator: Optional[torch.Generator] = None,
            shardings: Optional[ShardCtx] = None) -> Dict[str, Any]:
        """Train to ``cfg.steps``, resuming from the newest checkpoint in
        ``<out_dir>/ckpt`` where there is one.  -> {"state", "losses",
        "final_step"}.

        ``shardings``, a ``ShardCtx`` with a mesh and its rules, runs the
        loop on that mesh (``train_loop.py:93``, whose tree of
        ``NamedSharding``s the rules give here): the state restored or
        drawn under ``state_shardings``, each batch placed, the step on
        DTensors; every rank returns the same losses.  ``None`` trains
        on the loop's own ``ctx``."""
        cfg = self.cfg
        self.ctx = self._ctx if shardings is None else shardings
        mesh = None if shardings is None else shardings.mesh
        placed = None if mesh is None else self.state_shardings(shardings)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot hold a "
                             f"{self.device.type} loop's state")
        writer = mesh is None or mesh.get_rank() == 0
        ckpt_dir = os.path.join(cfg.out_dir, "ckpt")
        start = latest_step(ckpt_dir)
        if start is not None:
            state = restore_checkpoint(ckpt_dir, start, self.state_like(),
                                       self.device, placed, mesh)
            step0 = start
        else:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(cfg.seed)
            state = self.init_state(generator)
            if placed is not None:      # every rank draws it whole
                state = tree_map(lambda x, pl: place(x, pl, mesh), state,
                                 placed)
            step0 = 0

        losses = []
        with (open(self._metrics_path, "a") if writer
              else contextlib.nullcontext()) as log:
            for step in range(step0, cfg.steps):
                if self.failure is not None and \
                        self.failure.check(step) == "crash":
                    raise SimulatedCrash(f"injected crash at step {step}")
                t0 = time.time()
                batch = self.batch(step)
                m = self.train_step(state, batch)
                dt = time.time() - t0
                flagged = self.detector.observe(np.array([dt]))
                loss = _host(m["loss"])
                losses.append(loss)
                if step % cfg.log_every == 0 or step == cfg.steps - 1:
                    rec = {"step": step, "loss": loss,
                           "grad_norm": _host(m["grad_norm"]),
                           "lr": _host(m["lr"]), "sec": dt,
                           "stragglers": flagged}
                    if writer:
                        log.write(json.dumps(rec) + "\n")
                        log.flush()
                if (step + 1) % cfg.ckpt_every == 0 or \
                        step == cfg.steps - 1:
                    save_checkpoint(ckpt_dir, step + 1, state)
                    if writer:
                        prune_checkpoints(ckpt_dir, cfg.keep_ckpts)
        return {"state": state, "losses": losses, "final_step": cfg.steps}
