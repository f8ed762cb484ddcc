"""Self- and cross-attention (port of ``repro/models/attention.py``).

Scores are taken in f32 from the inputs as they are, as the reference's
``einsum(..., preferred_element_type=f32)`` does; probabilities are cast to
the value dtype before the value product.  NEG_INF is the finite -1e30.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.logical import NOSHARD, P, ShardCtx
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import remat_call, rope

NEG_INF = -1e30


def attn_spec(cfg: ArchConfig, cross: bool = False) -> dict:
    d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    spec = {
        "wq": P((d, qd), ("embed", "q_heads")),
        "wk": P((d, kd), ("embed", "kv_heads")),
        "wv": P((d, kd), ("embed", "kv_heads")),
        "wo": P((qd, d), ("q_heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        spec["bq"] = P((qd,), ("q_heads",), init="zeros")
        spec["bk"] = P((kd,), ("kv_heads",), init="zeros")
        spec["bv"] = P((kd,), ("kv_heads",), init="zeros")
    return spec


def project_q(p, x, cfg: ArchConfig, ctx: ShardCtx = NOSHARD):
    dt = x.dtype
    q = ctx.matmul(x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    return ctx.split_heads(q, cfg.n_heads)


def project_kv(p, x, cfg: ArchConfig, ctx: ShardCtx = NOSHARD):
    dt = x.dtype
    k = ctx.matmul(x, p["wk"].to(dt))
    v = ctx.matmul(x, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (ctx.split_heads(k, cfg.n_kv_heads),
            ctx.split_heads(v, cfg.n_kv_heads))


def out_proj(p, o, cfg: ArchConfig, ctx: ShardCtx = NOSHARD):
    return ctx.matmul(ctx.merge_heads(o), p["wo"].to(o.dtype))


def _mask(qpos, kpos, *, causal, is_global, window):
    """(Sq, Sk) boolean allowed-mask (``attention.py:71``)."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m = kpos[None, :] <= qpos[:, None]
    if window:
        in_win = kpos[None, :] > (qpos[:, None] - window)
        m = m & (in_win | bool(is_global))
    return m


def chunked_mha(q, k, v, ctx: ShardCtx, *, causal: bool = True,
                is_global=True, window: int = 0, q_offset: int = 0,
                chunk: int = 1024):
    """q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D) -> (B,Sq,Hq,D) (``:89``).

    The reference scans the query chunks; a Python loop does it here.
    Under grad each chunk's body is recomputed in the backward
    (``remat_call``, the reference's ``jax.checkpoint(body)``), so the
    backward holds one chunk's f32 (B, Hkv, G, chunk, Sk) scores at a
    time.
    """
    _, Sq, _, D = q.shape
    _, Sk, Hkv, _ = k.shape
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Sq)
    if Sq % chunk:
        raise ValueError(f"Sq={Sq} is not a multiple of chunk={chunk}")
    kpos = torch.arange(Sk, device=q.device)
    qg = ctx.split_heads(q, Hkv, dim=2)                  # (B,Sq,Hkv,G,D)
    kf = k.float()

    def block(qc, kf, v, start: int):
        qpos = q_offset + start + torch.arange(chunk, device=q.device)
        s = ctx.einsum("bqkgd,bskd->bkgqs", qc.float(), kf) * scale
        m = _mask(qpos, kpos, causal=causal, is_global=is_global,
                  window=window)
        s = torch.where(m[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return ctx.einsum("bkgqs,bskd->bqkgd", p, v)

    outs = [remat_call(block, qg[:, start:start + chunk], kf, v, start)
            for start in range(0, Sq, chunk)]
    o = ctx.merge_heads(torch.cat(outs, dim=1), dim=2)
    return ctx.constrain(o, "batch", "seq", "act_heads", None)


def banded_mha(q, k, v, ctx: ShardCtx, *, window: int, q_offset: int = 0,
               chunk: int = 512):
    """Causal sliding-window attention over the reachable KV band only
    (``attention.py:142``): q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D).

    Each query chunk attends to ``band = min(Sk, round_up(window + chunk,
    chunk))`` keys from ``k0 = clip(q_offset + start + chunk - band, 0,
    Sk - band)``, which hold every key its window can reach; the mask is
    causal and in-window, so the result is ``chunked_mha(window=window,
    is_global=False)``'s without the masked-out work.  The bands are
    slices of K and V, not copies.  Precision and the per-chunk
    ``remat_call`` are ``chunked_mha``'s.
    """
    _, Sq, _, D = q.shape
    _, Sk, Hkv, _ = k.shape
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Sq)
    if Sq % chunk:
        raise ValueError(f"Sq={Sq} is not a multiple of chunk={chunk}")
    band = min(Sk, _round_up(window + chunk, chunk))
    qg = ctx.split_heads(q, Hkv, dim=2)                  # (B,Sq,Hkv,G,D)
    kf = k.float()

    def block(qc, kc, vc, start: int, k0: int):
        qpos = q_offset + start + torch.arange(chunk, device=q.device)
        kpos = k0 + torch.arange(band, device=q.device)
        s = ctx.einsum("bqkgd,bskd->bkgqs", qc.float(), kc) * scale
        m = (kpos[None, :] <= qpos[:, None]) & \
            (kpos[None, :] > (qpos[:, None] - window))
        s = torch.where(m[None, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(vc.dtype)
        return ctx.einsum("bkgqs,bskd->bqkgd", p, vc)

    outs = []
    for start in range(0, Sq, chunk):
        k0 = min(max(q_offset + start + chunk - band, 0), Sk - band)
        outs.append(remat_call(block, qg[:, start:start + chunk],
                               kf[:, k0:k0 + band], v[:, k0:k0 + band],
                               start, k0))
    o = ctx.merge_heads(torch.cat(outs, dim=1), dim=2)
    return ctx.constrain(o, "batch", "seq", "act_heads", None)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def decode_mha(q, k_cache, v_cache, ctx: ShardCtx, *, pos, is_global=True,
               window: int = 0, k_new: Optional[torch.Tensor] = None,
               v_new: Optional[torch.Tensor] = None):
    """q: (B,1,Hq,D); caches: (B,Sk,Hkv,D) (``attention.py:194``).

    ``pos`` is a scalar (lockstep) or ``(B,)`` per-slot positions.  With
    ``k_new/v_new`` the cache positions ``< pos`` are read and the current
    token's K/V enter the softmax as one extra slot; without them the
    cache must already hold position ``pos``.
    """
    B, _, _, D = q.shape
    _, Sk, Hkv, _ = k_cache.shape
    scale = 1.0 / math.sqrt(D)
    qg = ctx.split_heads(q[:, 0], Hkv, dim=1)            # (B,Hkv,G,D)
    s = ctx.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    kpos = torch.arange(Sk, device=q.device)
    posb = torch.as_tensor(pos, device=q.device).reshape(-1, 1)  # (1,1)|(B,1)
    m = (kpos[None, :] < posb) if k_new is not None else (kpos[None, :] <= posb)
    if window:
        m = m & ((kpos[None, :] > posb - window) | bool(is_global))
    s = torch.where(m[:, None, None, :], s, NEG_INF)
    if k_new is not None:
        s_self = ctx.einsum("bkgd,bskd->bkgs", qg.float(),
                            k_new.to(q.dtype).float()) * scale
        s = torch.cat([s, s_self], dim=-1)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    if k_new is not None:
        o = ctx.einsum("bkgs,bskd->bkgd", p[..., :-1], v_cache) + \
            p[..., -1:] * v_new.to(v_cache.dtype).reshape(B, Hkv, 1, D)
        o = o.to(v_cache.dtype)
    else:
        o = ctx.einsum("bkgs,bskd->bkgd", p, v_cache)
    return ctx.merge_heads(o, dim=1)[:, None]


def self_attention(p, x, cfg: ArchConfig, ctx: ShardCtx, *, positions,
                   is_global=True, chunk: int = 1024, banded: bool = False):
    """``attention.py:244``: with ``banded`` and a sliding window,
    ``banded_mha`` (the window applies whatever ``is_global`` says)."""
    q = project_q(p, x, cfg, ctx)
    k, v = project_kv(p, x, cfg, ctx)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if banded and cfg.sliding_window:
        o = banded_mha(q, k, v, ctx, window=cfg.sliding_window, chunk=chunk)
    else:
        o = chunked_mha(q, k, v, ctx, causal=cfg.causal,
                        is_global=is_global, window=cfg.sliding_window,
                        chunk=chunk)
    return out_proj(p, o, cfg, ctx)


def cross_attention(p, x, kv_src, cfg: ArchConfig, ctx: ShardCtx, *,
                    chunk: int = 1024):
    """``attention.py:262``: x attends to ``kv_src`` (the VLM's image-patch
    embeddings); no mask, no RoPE."""
    q = project_q(p, x, cfg, ctx)
    k, v = project_kv(p, kv_src, cfg, ctx)
    o = chunked_mha(q, k, v, ctx, causal=False, chunk=chunk)
    return out_proj(p, o, cfg, ctx)


def decode_self_attention(p, x, k_cache, v_cache, cfg: ArchConfig,
                          ctx: ShardCtx, *, pos, is_global=True,
                          use_kernel: bool = False):
    """One-token decode step (``attention.py:273``).

    Unlike the reference, which leaves the cache read-only and lets the
    caller write it after the layer scan, this writes the step's K/V into
    ``k_cache``/``v_cache`` IN PLACE at ``pos`` before attending; the
    final cache is the same as the reference's.  With ``use_kernel`` the
    attention runs through ``kernel_ops.decode_attention`` on the cache
    as it lies (a strided ``(B,Hkv,S,D)`` view, no transpose or copy)
    with per-slot ``length = pos + 1``.

    Returns (out, k_new, v_new), k_new/v_new in the cache dtype.
    """
    B = x.shape[0]
    q = project_q(p, x, cfg, ctx)                  # (B,1,Hq,D)
    k_new, v_new = project_kv(p, x, cfg, ctx)      # (B,1,Hkv,D)
    posv = torch.as_tensor(pos, device=x.device).reshape(-1, 1).expand(B, 1)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)
    ctx.write_rows(k_cache, k_new, posv[:, 0])
    ctx.write_rows(v_cache, v_new, posv[:, 0])
    if use_kernel:
        if cfg.sliding_window:
            raise ValueError(
                "decode_attention kernel has no sliding-window mask; "
                "keep use_kernel=False for windowed configs")
        o = kernel_ops.decode_attention(
            q.to(k_cache.dtype).reshape(B, cfg.n_heads, cfg.head_dim),
            k_cache.transpose(1, 2), v_cache.transpose(1, 2),
            posv[:, 0].to(torch.int32) + 1)
        o = o.reshape(B, 1, cfg.n_heads, cfg.head_dim)
    else:
        o = decode_mha(q, k_cache, v_cache, ctx, pos=pos,
                       is_global=is_global, window=cfg.sliding_window,
                       k_new=k_new, v_new=v_new)
    return (out_proj(p, o.to(x.dtype), cfg, ctx),
            k_new.to(k_cache.dtype), v_new.to(v_cache.dtype))
