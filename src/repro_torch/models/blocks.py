"""Dense and MoE transformer blocks, the VLM's cross-attention blocks and
Mamba blocks, pre-norm residual (port of ``repro/models/blocks.py``)."""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.logical import ShardCtx
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    mlp, mlp_spec, remat_call, rmsnorm, rmsnorm_spec)


@dataclasses.dataclass(frozen=True)
class ModelOpts:
    """Run-time knobs (``blocks.py:19``)."""
    attn_chunk: int = 512        # query chunk of the prefill attention
    ce_chunk: int = 1024         # sequence chunk of the cross-entropy
    remat: str = "full"          # none | full | dots; see remat_wrap
    banded_local: bool = False   # banded sliding-window path
    use_kernel: bool = False     # hand-written CUDA kernels
    aux_loss_coef: float = 0.01  # weight of the MoE router's aux loss


def remat_wrap(fn, opts: ModelOpts):
    """``blocks.py:29``: "none" keeps every activation; "full" saves only
    the block's inputs and recomputes it in the backward
    (``torch.utils.checkpoint``, non-reentrant); "dots" also saves the
    outputs of the matrix products and recomputes the rest
    (``jax.checkpoint_policies.checkpoint_dots``).  Inert while grad is
    off (``layers.remat_call``), so the serving and prefill paths run
    ``fn`` as it is.  Any other string means "full", as in the
    reference."""
    if opts.remat == "none":
        return fn
    if opts.remat == "dots":
        return functools.partial(remat_call, fn, context_fn=_save_dots)
    return functools.partial(remat_call, fn)


_aten = torch.ops.aten
# what matmul and einsum lower to, with or without a bias
_DOTS = frozenset((_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
                   _aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


# ---------------------------------------------------------------------------
# Dense / MoE attention block
# ---------------------------------------------------------------------------
def dense_block_spec(cfg: ArchConfig) -> dict:
    """``blocks.py:41``: the FFN is "moe" when the config has experts."""
    spec = {
        "ln1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attn_spec(cfg),
        "ln2": rmsnorm_spec(cfg.d_model),
    }
    if cfg.n_experts:
        spec["moe"] = moe_mod.moe_spec(cfg)
    else:
        spec["mlp"] = mlp_spec(cfg)
    return spec


def ffn(p, hn, cfg: ArchConfig, ctx: ShardCtx):
    """The block's FFN on the normed hidden state: MoE or MLP."""
    if cfg.n_experts:
        return moe_mod.moe_ffn(p["moe"], hn, cfg, ctx)
    return mlp(p["mlp"], hn, cfg, ctx)


def dense_block(p, h, cfg: ArchConfig, ctx: ShardCtx, opts: ModelOpts, *,
                positions, is_global=True, banded=False):
    """Forward block (``blocks.py:54``); ``banded`` takes the attention
    through ``attention.banded_mha`` where the config has a window.
    Returns (h, aux loss): the MoE router's, an f32 zero without
    experts."""
    p = ctx.weights(p)
    h = ctx.constrain(h, "batch", "seq", "act_embed")
    a = attn.self_attention(
        p["attn"], rmsnorm(p["ln1"], h), cfg, ctx,
        positions=positions, is_global=is_global, chunk=opts.attn_chunk,
        banded=banded)
    h = h + a
    hn = rmsnorm(p["ln2"], h)
    if cfg.n_experts:
        aux = moe_mod.router_aux_loss(p["moe"], hn, cfg, ctx)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ffn(p, hn, cfg, ctx), aux


def dense_block_decode(p, h, k_cache, v_cache, cfg: ArchConfig,
                       ctx: ShardCtx, *, pos, is_global=True,
                       use_kernel: bool = False):
    """One-token step (``blocks.py:73``).  Writes this token's K/V into the
    caches in place (see ``attention.decode_self_attention``).
    Returns (h, k_new, v_new)."""
    p = ctx.weights(p)
    a, k_new, v_new = attn.decode_self_attention(
        p["attn"], rmsnorm(p["ln1"], h), k_cache, v_cache, cfg, ctx,
        pos=pos, is_global=is_global, use_kernel=use_kernel)
    h = h + a
    return h + ffn(p, rmsnorm(p["ln2"], h), cfg, ctx), k_new, v_new


# ---------------------------------------------------------------------------
# Cross-attention block (VLM)
# ---------------------------------------------------------------------------
def cross_block_spec(cfg: ArchConfig) -> dict:
    """``blocks.py:96``: no qkv bias; ``gate`` is a norm-shaped scale."""
    return {
        "ln": rmsnorm_spec(cfg.d_model),
        "xattn": attn.attn_spec(cfg, cross=True),
        "gate": rmsnorm_spec(cfg.d_model),   # tanh-gated residual scale
    }


def _gated(h, a, p):
    """The residual ``h + a * tanh(gate)``, the gate cast to a's dtype."""
    return h + a * torch.tanh(p["gate"]["scale"].to(a.dtype))


def cross_block(p, h, img, cfg: ArchConfig, ctx: ShardCtx,
                opts: ModelOpts):
    """``blocks.py:104``: h attends to the image embeddings ``img``."""
    p = ctx.weights(p)
    a = attn.cross_attention(p["xattn"], rmsnorm(p["ln"], h), img, cfg, ctx,
                             chunk=opts.attn_chunk)
    return _gated(h, a, p)


def cross_block_cached(p, h, xk, xv, cfg: ArchConfig, ctx: ShardCtx):
    """``blocks.py:112``: the image K/V already projected (the prefill's
    or the decode cache's ``xk``/``xv``), one query at a time.

    The sum is returned in h's dtype.  The reference's layer scan needs
    that of its carry; where ``xk``/``xv`` are wider than h (a bf16
    model on the server's f32 cache) it promotes h and its scan raises a
    TypeError, and the port rounds the sum back instead.  Elsewhere the
    cast changes nothing."""
    p = ctx.weights(p)
    q = attn.project_q(p["xattn"], rmsnorm(p["ln"], h), cfg, ctx)
    o = attn.chunked_mha(q, xk, xv, ctx, causal=False, chunk=1)
    a = attn.out_proj(p["xattn"], o, cfg, ctx)
    return _gated(h, a, p).to(h.dtype)


# ---------------------------------------------------------------------------
# Mamba block wrapper
# ---------------------------------------------------------------------------
def mamba_block_spec(cfg: ArchConfig) -> dict:
    """``blocks.py:124``."""
    return {"ln": rmsnorm_spec(cfg.d_model), "mixer": ssm_mod.mamba_spec(cfg)}


def mamba_block(p, h, cfg: ArchConfig, ctx: ShardCtx, opts: ModelOpts):
    """``blocks.py:128``: the only route to the ``ssd_scan`` kernel."""
    p = ctx.weights(p)
    h = ctx.constrain(h, "batch", "seq", "act_embed")
    return h + ssm_mod.mamba_block(p["mixer"], rmsnorm(p["ln"], h), cfg, ctx,
                                   use_kernel=opts.use_kernel)


def mamba_block_decode(p, h, cache, cfg: ArchConfig, ctx: ShardCtx):
    """``blocks.py:134``: -> (h, new cache)."""
    p = ctx.weights(p)
    y, cache = ssm_mod.mamba_decode_step(
        p["mixer"], rmsnorm(p["ln"], h), cache, cfg, ctx)
    return h + y, cache
