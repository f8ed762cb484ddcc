"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``).

The state is a tree like the parameters': ``m`` and ``v`` in the params'
dtype and an int32 ``count``.  ``adamw_update`` updates params and state
IN PLACE under ``torch.no_grad()``, where the reference donates its
buffers to a jitted step.  Its operation order is the reference's, and the
clip scale, the bias corrections and the learning rate are f32 tensors on
the params' device made from ``count``: the step never waits on the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> dict:
    """``adamw.py:24``: zero ``m`` and ``v`` like the params, count 0."""
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device)}


def global_norm(tree) -> torch.Tensor:
    """``adamw.py:30``: sqrt of the f32 sum of squares, leaf sums added in
    the reference's leaf order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0
                 ) -> dict:
    """``adamw.py:36``: one clipped AdamW step, IN PLACE on ``params`` and
    ``state``.  Returns the metrics {"grad_norm", "lr"}, f32 device
    tensors."""
    state["count"].add_(1)
    c = state["count"].float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    mhat_scale = 1.0 / (1 - torch.pow(b1, c))
    vhat_scale = 1.0 / (1 - torch.pow(b2, c))
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=c.device)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        # each op rounds as the reference's; in place on temporaries to
        # keep one leaf's worth of them at a time
        g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        denom = (v * vhat_scale).sqrt_().add_(cfg.eps)
        step = (m * mhat_scale).div_(denom)
        del denom
        step.add_(cfg.weight_decay * p).mul_(lr)
        p.sub_(step.to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
