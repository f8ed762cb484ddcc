"""Shared layers as plain functions on tensors (port of
``repro/models/layers.py``).

The roundings follow the reference op by op: ``rmsnorm`` works in f32 and
casts back; ``rope`` multiplies the input by f32 cos/sin, so a bf16 input
is promoted to f32 and rounded once at the end (``layers.py:40``);
``chunked_cross_entropy`` sums in f32 chunk by chunk.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.logical import NOSHARD, P, ShardCtx


def remat_call(fn, *args, context_fn=noop_context_fn, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward while grad is on
    (non-reentrant ``torch.utils.checkpoint``; ``context_fn`` may keep some
    of its intermediates): the reference's ``jax.checkpoint`` around a scan
    body (the query chunks of attention, the chunks of the SSD scan and of
    the cross-entropy, a layer under ``remat``), so the backward keeps one
    chunk's intermediates at a time.  Without grad it is ``fn``'s call."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn,
                      **kwargs)


def rmsnorm_spec(d: int) -> dict:
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``layers.py:20``: f32 inside, eps 1e-6."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """``layers.py:31``, half-split layout.  x: (..., S, H, D);
    positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freq = theta ** (-ar / half)
    angles = positions[..., None].float() * freq           # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_spec(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "wi": P((d, f), ("embed", "ffn")),
            "wg": P((d, f), ("embed", "ffn")),
            "wo": P((f, d), ("ffn", "embed")),
        }
    return {
        "wi": P((d, f), ("embed", "ffn")),
        "wo": P((f, d), ("ffn", "embed")),
    }


def _gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    return F.gelu(a, approximate="tanh")


def activation(cfg: ArchConfig):
    """silu for swiglu, tanh-gelu otherwise (``layers.py:68``,
    ``moe.py:99``)."""
    return F.silu if cfg.activation == "swiglu" else _gelu_tanh


def mlp(params, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx
        ) -> torch.Tensor:
    """``layers.py:64``: silu for swiglu, tanh-gelu for geglu and gelu."""
    dt = x.dtype
    if cfg.activation in ("swiglu", "geglu"):
        act = activation(cfg)
        h = act(ctx.matmul(x, params["wg"].to(dt))) * ctx.matmul(
            x, params["wi"].to(dt))
    else:
        h = _gelu_tanh(ctx.matmul(x, params["wi"].to(dt)))
    h = ctx.constrain(h, "batch", "seq", "act_ffn")
    return ctx.matmul(h, params["wo"].to(dt))


def embed_spec(cfg: ArchConfig) -> dict:
    spec = {"tok": P((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        spec["unembed"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return spec


def embed(params, tokens: torch.Tensor, dtype: torch.dtype,
          ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    # an embedding lookup (an indexed read's values); on a vocab-split
    # table each rank reads its own slice (``ShardCtx.embed``)
    return ctx.embed(params["tok"], tokens, dtype)


def unembed_matrix(params, cfg: ArchConfig, dtype: torch.dtype,
                   ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    if cfg.tie_embeddings:
        return ctx.transpose(params["tok"].to(dtype))
    return params["unembed"].to(dtype)


def logits_last(params, cfg: ArchConfig, h_last: torch.Tensor
                ) -> torch.Tensor:
    """(B, D) -> (B, V) f32 logits for decode."""
    w = unembed_matrix(params, cfg, h_last.dtype)
    return (h_last @ w).float()


class GoldLogit(torch.autograd.Function):
    """``gather(logits, -1, idx)``, each row's logit at its label, with
    ``ShardCtx.gold_grad`` as its backward: gather's own with no mesh, and
    under a mesh an elementwise form that keeps the logits' vocab split,
    where DTensor places gather's backward replicated (a (B, chunk, V)
    f32 tensor on every chip)."""

    @staticmethod
    def forward(ctx, logits, idx, shard: ShardCtx):
        ctx.shard = shard
        ctx.save_for_backward(logits, idx)
        return torch.gather(logits, -1, idx)

    @staticmethod
    def backward(ctx, grad):
        logits, idx = ctx.saved_tensors
        return ctx.shard.gold_grad(grad, idx, logits), None, None


def chunked_cross_entropy(params, cfg: ArchConfig, h: torch.Tensor,
                          labels: torch.Tensor, ctx: ShardCtx,
                          chunk: int = 1024) -> torch.Tensor:
    """``layers.py:100``: mean CE without materialising (B, S, V) logits.

    h: (B, S, D); labels: (B, S) int, -1 = ignore.  Each sequence chunk
    makes its (B, chunk, V) f32 logits, adds its CE to an f32 sum and
    drops them; under grad the backward recomputes them a chunk at a time
    (``remat_call``) instead of keeping every chunk's.  ``S`` must be a
    multiple of ``min(chunk, S)``, as the reference asserts.
    """
    B, S, D = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk {chunk}")
    w = unembed_matrix(params, cfg, h.dtype, ctx)         # (D, V)

    def body(hc, yc):
        logits = ctx.constrain(ctx.matmul(hc, w).float(), "batch", "seq",
                               "vocab")
        # (B, chunk, 1) until the difference: on a vocab-sharded DTensor
        # the gather's pending reduction (a masked partial) is made on
        # the shape it was gathered at
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        gold = GoldLogit.apply(logits, yc.clamp_min(0).long()[..., None],
                               ctx)
        valid = yc >= 0
        return torch.sum((lse - gold)[..., 0] * valid), valid.sum()

    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int64, device=h.device)
    for start in range(0, S, chunk):
        s, c = remat_call(body, h[:, start:start + chunk],
                          labels[:, start:start + chunk])
        loss_sum = loss_sum + s
        count = count + c
    return loss_sum / count.clamp_min(1).float()
