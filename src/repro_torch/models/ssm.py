"""Mamba2 (SSD, state-space duality) block (port of ``repro/models/ssm.py``).

The reference forward is the chunked SSD algorithm of the Mamba2 paper,
scanned over sequence chunks (``ssm.py:67-130``); here the scan is a Python
loop over the chunks.  ``use_kernel`` routes the scan through the CUDA
``ssd_scan`` kernel (``repro_torch.kernels.ops.ssd``), as the reference
routes it through its Pallas kernel (``ssm.py:151-153``).

The roundings follow the reference op by op: the causal conv accumulates
its taps one by one in the input dtype (bf16 in the model), ``silu``
rounds each op of ``x / (1 + exp(-x))`` in the input dtype, and the
one-token decode step promotes to f32 wherever the reference's f32 cache
does (``ssm.py:176``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.logical import NOSHARD, P, ShardCtx
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import remat_call, rmsnorm, rmsnorm_spec


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it: ``x * logistic(x)`` with
    ``logistic(x) = 1 / (1 + exp(-x))``, every op rounded to x's dtype.
    In bf16 ``torch.sigmoid`` rounds once and differs by one unit in the
    last place for about a third of the inputs."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def mamba_spec(cfg: ArchConfig) -> dict:
    """``ssm.py:21``."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        # in_proj -> [z (di), xBC (di + 2n), dt (h)]
        "in_proj": P((d, 2 * di + 2 * n + h), ("embed", "inner")),
        "conv_w": P((cfg.ssm_conv_width, conv_dim), ("conv", "inner"),
                    scale=0.5),
        "conv_b": P((conv_dim,), ("inner",), init="zeros"),
        "A_log": P((h,), ("ssm_heads",), init="ones"),
        "D": P((h,), ("ssm_heads",), init="ones"),
        "dt_bias": P((h,), ("ssm_heads",), init="zeros"),
        "norm": rmsnorm_spec(di),
        "out_proj": P((di, d), ("inner", "embed")),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    """``ssm.py:38``: views of z, xBC and dt."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    if dt.shape[-1] != h:
        raise ValueError(f"projection width {zxbcdt.shape[-1]} does not fit "
                         f"{cfg.name}")
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    """``ssm.py:47``: depthwise causal conv of width W, xBC (B, L, C),
    w (W, C).  The taps are added one by one in xBC's dtype, in tap order,
    then the bias, then silu; ``F.conv1d`` would round once in f32 and
    differ in bf16."""
    W = w.shape[0]
    L = xBC.shape[1]
    pad = ctx.pad_front(xBC, W - 1)
    out = torch.zeros_like(xBC)
    for i in range(W):
        out = out + pad[:, i:i + L] * w[i].to(xBC.dtype)
    return silu(out + b.to(xBC.dtype))


def _segsum(a: torch.Tensor, ctx: ShardCtx = NOSHARD) -> torch.Tensor:
    """``ssm.py:58``: (..., Q) -> lower-triangular segment sums (..., Q, Q),
    ``-inf`` above the diagonal, so that ``exp`` gives 0 there (selected,
    never multiplied by a mask)."""
    Q = a.shape[-1]
    cum = ctx.cumsum(a)
    d = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_reference(x, dt, A, Bm, Cm, D, chunk: int,
                  init_state: Optional[torch.Tensor] = None,
                  ctx: ShardCtx = NOSHARD
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (``ssm.py:67``).

    x: (B, L, H, P); dt: (B, L, H) positive step sizes; A: (H,) negative
    decay rates; Bm, Cm: (B, L, N) shared across heads; D: (H,).
    Returns (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) f32).
    Under grad each chunk's body is recomputed in the backward
    (``remat_call``, the reference's ``jax.checkpoint(body)``), so the
    (B, H, Q, Q) intra-chunk matrices are kept for one chunk at a time.
    """
    B_, L, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"L={L} is not a multiple of chunk {Q}")
    n = L // Q

    a = dt * A.float()[None, None, :]                    # (B, L, H) f32
    xw = x.float() * dt[..., None]                       # (B, L, H, P)
    a = ctx.constrain(a, "batch", "seq", "ssm_heads")
    xw = ctx.constrain(xw, "batch", "seq", "ssm_heads", "ssm_hd")
    a_c = a.reshape(B_, n, Q, H)
    xw_c = xw.reshape(B_, n, Q, H, Pd)
    B_c = Bm.float().reshape(B_, n, Q, N)
    C_c = Cm.float().reshape(B_, n, Q, N)

    state = (torch.zeros((B_, H, Pd, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())

    def body(state, ac, xc, bc, cc):
        ah = ac.transpose(1, 2)                          # (B, H, Q)
        cum = ctx.cumsum(ah)
        Lmat = torch.exp(_segsum(ah, ctx))               # (B, H, Q, Q)
        G = ctx.einsum("bqn,bsn->bqs", cc, bc)           # (B, Q, Q)
        M = G[:, None] * Lmat
        y_diag = ctx.einsum("bhqs,bshp->bqhp", M, xc)
        state_decay = torch.exp(cum)                     # (B, H, Q)
        y_off = ctx.einsum("bqn,bhpn,bhq->bqhp", cc, state, state_decay)
        total = cum[..., -1]                             # (B, H)
        decay_to_end = torch.exp(cum[..., -1:] - cum)    # (B, H, Q)
        new_contrib = ctx.einsum("bqn,bhq,bqhp->bhpn", bc, decay_to_end,
                                 xc)
        state = state * torch.exp(total)[..., None, None] + new_contrib
        return state, y_diag + y_off

    ys = []
    for c in range(n):
        state, yc = remat_call(body, state, a_c[:, c], xw_c[:, c],
                               B_c[:, c], C_c[:, c])
        ys.append(yc)
    y = torch.stack(ys, dim=1).reshape(B_, L, H, Pd)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def _mixer(p, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx,
           use_kernel: bool):
    """The Mamba2 mixer (``ssm.py:133``) -> (out (B, L, D_model), final ssm
    state (B, H, P, N) f32, xBC before the conv).  ``mamba_block`` keeps
    the output; the prefill (``model.py:510``) also keeps the state and the
    conv's input, whose tail seeds the decode cache."""
    dt_ = x.dtype
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    zxbcdt = ctx.matmul(x, p["in_proj"].to(dt_))
    z, xBC_in, dt = _split_proj(cfg, zxbcdt)
    xBC = ctx.constrain(_causal_conv(xBC_in, p["conv_w"], p["conv_b"], ctx),
                        "batch", "seq", "inner")
    xs = ctx.split_heads(xBC[..., :di], h)
    Bm = xBC[..., di:di + n]
    Cm = xBC[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if use_kernel:
        y, state = kernel_ops.ssd(xs, dt, A, Bm, Cm, p["D"],
                                  chunk=cfg.ssm_chunk)
    else:
        y, state = ssd_reference(xs, dt, A, Bm, Cm, p["D"],
                                 chunk=cfg.ssm_chunk, ctx=ctx)
    y = ctx.merge_heads(y)
    y = rmsnorm(p["norm"], y * silu(z))
    y = ctx.constrain(y, "batch", "seq", "act_ffn")
    return ctx.matmul(y, p["out_proj"].to(dt_)), state, xBC_in


def mamba_block(p, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx,
                use_kernel: bool = False) -> torch.Tensor:
    """Full Mamba2 mixer, train/prefill path (``ssm.py:133``).
    x: (B, L, D_model).

    With ``use_kernel`` the scan takes x, Bm and Cm as the strided views of
    the conv output that are made here (row stride ``d_inner + 2N``); the
    kernel reads them through their strides, without a copy.
    """
    return _mixer(p, x, cfg, ctx, use_kernel)[0]


# ---------------------------------------------------------------------------
# Decode: single-token state update
# ---------------------------------------------------------------------------
def mamba_init_cache(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device="cpu") -> dict:
    """``ssm.py:166``: the ssm state is f32 whatever ``dtype`` is."""
    di, n = cfg.d_inner, cfg.ssm_state
    conv_dim = di + 2 * n
    return {
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, n),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba_decode_step(p, x: torch.Tensor, cache: dict, cfg: ArchConfig,
                      ctx: ShardCtx):
    """``ssm.py:176``: x (B, 1, D_model) -> (y (B, 1, D), new cache).

    With the server's f32 cache the rolling conv history promotes to f32,
    and so does everything after it until ``y`` is cast back for
    ``out_proj``, as in the reference.
    """
    dt_ = x.dtype
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    zxbcdt = x[:, 0] @ p["in_proj"].to(dt_)              # (B, ...)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    # causal conv via rolling buffer
    ht = torch.promote_types(cache["conv"].dtype, xBC.dtype)
    hist = torch.cat([cache["conv"].to(ht), xBC[:, None].to(ht)], dim=1)
    w = p["conv_w"].to(dt_)
    et = torch.promote_types(ht, w.dtype)
    conv_out = torch.einsum("bwc,wc->bc", hist.to(et), w.to(et)) \
        + p["conv_b"].to(dt_)
    xBC = silu(conv_out)
    new_conv = hist[:, 1:]

    xs = ctx.split_heads(xBC[..., :di], h).float()
    Bm = xBC[..., di:di + n].float()
    Cm = xBC[..., di + n:].float()
    # the heads placed by the logical rule before the nonlinearity (heads
    # that do not divide the mesh axis replicated): DTensor would settle
    # the product's pending sum by splitting them into uneven shards,
    # which the state's products cannot merge
    dt = ctx.constrain(dt, "batch", "ssm_heads")
    dt = F.softplus(dt.float() + p["dt_bias"].float())     # (B, H)
    A = -torch.exp(p["A_log"].float())

    decay = torch.exp(dt * A[None, :])                   # (B, H)
    state = cache["ssm"] * decay[..., None, None] + ctx.einsum(
        "bh,bhp,bn->bhpn", dt, xs, Bm)
    y = ctx.einsum("bhpn,bn->bhp", state, Cm) \
        + xs * p["D"].float()[None, :, None]
    y = ctx.merge_heads(y)
    y = rmsnorm(p["norm"], y * silu(z.float()))
    y = (y.to(dt_) @ p["out_proj"].to(dt_))[:, None]
    return y, {"ssm": state, "conv": new_conv}
