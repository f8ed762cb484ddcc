"""Fault-tolerant training loop (port of ``repro/runtime/train_loop.py``).

* auto-resume from the newest complete checkpoint (atomic writes, in the
  reference's format, so a run may resume from the reference's
  checkpoints and the other way round),
* periodic checkpointing and pruning,
* optional int8 gradient compression with error feedback,
* straggler detection and simulated failure injection.

A step is ``torch.autograd.grad`` of ``Model.loss`` with respect to the
f32 masters, then the cosine schedule and AdamW, which update the state
IN PLACE where the reference donates its buffers to a jitted step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (
    latest_step, prune_checkpoints, restore_checkpoint, save_checkpoint)
from repro_torch.data.pipeline import SyntheticLMData, to_device
from repro_torch.device import resolve_device
from repro_torch.distrib.logical import NOSHARD, spec_map
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, cosine_schedule)
from repro_torch.optim.compress import compress_grads, init_error_feedback
from repro_torch.runtime.fault import (
    FailureInjector, SimulatedCrash, StragglerDetector)
from repro_torch.tree import leaves, unflatten


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
        self.ctx = ctx or NOSHARD
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
        params = state["params"]
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = self.model.loss(params, batch, self.ctx, self.opts)
            # a leaf the loss never reads (audio's token embedding) gets a
            # zero gradient, as jax.grad gives it
            grads = unflatten(params, torch.autograd.grad(
                loss, flat, materialize_grads=True))
        if self.cfg.compress_grads:
            grads, state["err"] = compress_grads(grads, state["err"])
        lr_scale = cosine_schedule(state["opt"]["count"],
                                   warmup=self.cfg.warmup,
                                   total=self.cfg.schedule_total)
        m = adamw_update(grads, state["opt"], params, self.ocfg, lr_scale)
        m["loss"] = loss.detach()
        return m

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
        def like():
            return spec_map(lambda s: torch.empty(s.shape, device="meta"),
                            self.model.param_spec())
        return {"params": like(),
                "opt": {"m": like(), "v": like(),
                        "count": torch.empty((), dtype=torch.int32,
                                             device="meta")},
                "err": like()}

    def run(self, generator: Optional[torch.Generator] = None
            ) -> Dict[str, Any]:
        """Train to ``cfg.steps``, resuming from the newest checkpoint in
        ``<out_dir>/ckpt`` where there is one.  -> {"state", "losses",
        "final_step"}."""
        cfg = self.cfg
        ckpt_dir = os.path.join(cfg.out_dir, "ckpt")
        start = latest_step(ckpt_dir)
        if start is not None:
            state = restore_checkpoint(ckpt_dir, start, self.state_like(),
                                       self.device)
            step0 = start
        else:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(cfg.seed)
            state = self.init_state(generator)
            step0 = 0

        losses = []
        with open(self._metrics_path, "a") as log:
            for step in range(step0, cfg.steps):
                if self.failure is not None and \
                        self.failure.check(step) == "crash":
                    raise SimulatedCrash(f"injected crash at step {step}")
                t0 = time.time()
                batch = to_device(self.data.batch_at(step), self.device)
                m = self.train_step(state, batch)
                dt = time.time() - t0
                flagged = self.detector.observe(np.array([dt]))
                loss = float(m["loss"])
                losses.append(loss)
                if step % cfg.log_every == 0 or step == cfg.steps - 1:
                    rec = {"step": step, "loss": loss,
                           "grad_norm": float(m["grad_norm"]),
                           "lr": float(m["lr"]), "sec": dt,
                           "stragglers": flagged}
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                if (step + 1) % cfg.ckpt_every == 0 or \
                        step == cfg.steps - 1:
                    save_checkpoint(ckpt_dir, step + 1, state)
                    prune_checkpoints(ckpt_dir, cfg.keep_ckpts)
        return {"state": state, "losses": losses, "final_step": cfg.steps}
