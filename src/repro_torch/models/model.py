"""Model assembly for the dense, moe and ssm families: specs, forward,
loss, prefill, decode (port of ``repro/models/model.py``).

Parameters are an explicit nested dict of tensors with the reference's
keys and stacked per-layer layout (leading ``layers`` axis), so a JAX tree
loads as it is (``repro_torch.interop``).  The reference's ``lax.scan``
over the stack is a Python loop over its slices here.  The hybrid, vlm
and audio families raise ``NotImplementedError`` until their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.logical import (
    NOSHARD, P, ShardCtx, init_params, spec_map)
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as B
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.layers import (
    chunked_cross_entropy, embed, embed_spec, logits_last, rmsnorm,
    rmsnorm_spec)

FAMILIES = ("dense", "moe", "ssm")
ATTENTION_FAMILIES = ("dense", "moe")     # a stack of dense_block, KV cache


def stack_spec(spec: dict, *ns: int) -> dict:
    """Prepend scan dims to every leaf (logical axis 'layers')."""
    extra = tuple(ns)
    return spec_map(
        lambda p: P(extra + p.shape, ("layers",) * len(extra) + p.axes,
                    p.scale, p.init),
        spec)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter tree, as views."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, as views: one
    ``torch.unbind`` a leaf, whose backward is one ``stack``.  Indexing
    layer by layer (``layer_slice``) would make each layer's backward
    allocate a zero tensor the size of the whole stacked leaf."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree))


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def _check_family(self) -> None:
        if self.cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{self.cfg.name}: family {self.cfg.family!r} is not ported "
                f"yet; the port covers the {', '.join(FAMILIES)} families")

    def param_spec(self) -> dict:
        """``model.py:64`` for the dense, moe and ssm families."""
        self._check_family()
        cfg = self.cfg
        block = (B.dense_block_spec(cfg) if cfg.family in ATTENTION_FAMILIES
                 else B.mamba_block_spec(cfg))
        return {"embed": embed_spec(cfg),
                "ln_f": rmsnorm_spec(cfg.d_model),
                "layers": stack_spec(block, cfg.n_layers)}

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
        """Seeded parameters on ``generator.device``."""
        return init_params(generator, self.param_spec(), dtype)

    def global_flags(self) -> np.ndarray:
        return np.array([g for _, g in self.cfg.layer_pattern()], bool)

    # ---------------- forward and loss ----------------
    def forward(self, params, batch, ctx: ShardCtx = NOSHARD,
                opts: ModelOpts = ModelOpts()):
        """``model.py:106``: -> (hidden (B, S, D) after the final norm,
        aux loss).  The aux loss is the MoE router's, summed over the
        layers (``model.py:135-137``); an f32 zero for the other families.
        For the ssm family ``opts.use_kernel`` runs every layer's scan
        through the ``ssd_scan`` kernel, which has no backward: under grad
        with parameters that require it, that raises (training runs
        ``ssd_reference``, as the reference does).

        Differentiable: gradients reach the f32 masters through
        ``precast``; ``opts.remat`` recomputes each layer in the backward
        (``blocks.remat_wrap``)."""
        self._check_family()
        cfg = self.cfg
        if opts.banded_local and cfg.local_global_ratio \
                and cfg.sliding_window:
            raise NotImplementedError(
                "the banded local:global path comes with the gemma3 slice")
        dtype = compute_dtype(cfg)
        params = precast(params, dtype)
        h = ctx.constrain(embed(params["embed"], batch["tokens"], dtype),
                          "batch", "seq", "act_embed")
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        layers = unstack(params["layers"], cfg.n_layers)
        if cfg.family in ATTENTION_FAMILIES:
            positions = torch.arange(h.shape[1], device=h.device)[None]
            body = B.remat_wrap(B.dense_block, opts)
            for p_i, flag in zip(layers, self.global_flags()):
                h, a = body(p_i, h, cfg, ctx, opts, positions=positions,
                            is_global=bool(flag))
                aux = aux + a
        else:
            body = B.remat_wrap(B.mamba_block, opts)
            for p_i in layers:
                h = body(p_i, h, cfg, ctx, opts)
        return rmsnorm(params["ln_f"], h), aux

    def loss(self, params, batch, ctx: ShardCtx = NOSHARD,
             opts: ModelOpts = ModelOpts()) -> torch.Tensor:
        """``model.py:225``: mean CE over labels >= 0 plus
        ``opts.aux_loss_coef`` times the aux loss."""
        h, aux = self.forward(params, batch, ctx, opts)
        ce = chunked_cross_entropy(params["embed"], self.cfg, h,
                                   batch["labels"], ctx, chunk=opts.ce_chunk)
        return ce + opts.aux_loss_coef * aux

    # ---------------- prefill (forward + KV/state cache) ----------------
    @torch.no_grad()
    def prefill(self, params, batch, ctx: ShardCtx = NOSHARD,
                opts: ModelOpts = ModelOpts()):
        """``model.py:234``: -> (last-position logits (B, V) f32, cache).
        dense and moe: {"k", "v"}: (L, B, S, Hkv, D) in the compute dtype;
        ssm: {"ssm": (L, B, H, P, N) f32, "conv": (L, B, W-1, C) in the
        compute dtype}.  The ssm prefill runs ``ssd_reference``, as the
        reference does, whatever ``opts.use_kernel`` says."""
        self._check_family()
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        params = precast(params, dtype)
        h = embed(params["embed"], batch["tokens"], dtype)
        if cfg.family in ATTENTION_FAMILIES:
            positions = torch.arange(h.shape[1], device=h.device)[None]
            ks, vs = [], []
            for i, flag in enumerate(self.global_flags()):
                h, (k, v) = _dense_prefill(layer_slice(params["layers"], i),
                                           h, cfg, ctx, opts, positions,
                                           bool(flag))
                ks.append(k)
                vs.append(v)
            cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        else:
            ssms, convs = [], []
            for i in range(cfg.n_layers):
                h, (st, conv) = _mamba_prefill(
                    layer_slice(params["layers"], i), h, cfg, ctx)
                ssms.append(st)
                convs.append(conv)
            cache = {"ssm": torch.stack(ssms), "conv": torch.stack(convs)}
        h = rmsnorm(params["ln_f"], h)
        return logits_last(params["embed"], cfg, h[:, -1]), cache

    # ---------------- decode ----------------
    def init_cache(self, batch: int, seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Any = "cpu") -> Dict[str, torch.Tensor]:
        """``model.py:315``: dense and moe: zeros (L, B, S, Hkv, D) for k
        and v; ssm: the zero state and conv history of every layer
        (``seq`` is unused; the ssm state is f32 whatever ``dtype`` is)."""
        self._check_family()
        cfg = self.cfg
        if cfg.family == "ssm":
            m = ssm_mod.mamba_init_cache(cfg, batch, dtype, device)
            return {"ssm": _tile(m["ssm"], cfg.n_layers),
                    "conv": _tile(m["conv"], cfg.n_layers)}
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @torch.no_grad()
    def decode_step(self, params, batch, cache, ctx: ShardCtx = NOSHARD,
                    opts: ModelOpts = ModelOpts()):
        """One token for every sequence in the batch (``model.py:351``).

        batch: {"token": (B,1) int, "pos": scalar int or (B,) int}
        -> (logits (B,V) f32, cache)

        A scalar ``pos`` is the lockstep path; a ``(B,)`` vector gives each
        slot its own position; the ssm family's recurrent state has no
        position and ignores it (``model.py:402-411``).  The cache is
        updated IN PLACE, one layer at a time, and returned; its final
        contents equal the reference's (``model.py:386-399``).
        """
        self._check_family()
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        params = precast(params, dtype)
        pos = batch["pos"]
        h = embed(params["embed"], batch["token"], dtype)   # (B,1,D)
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                h, new = B.mamba_block_decode(
                    layer_slice(params["layers"], i), h,
                    {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
                    cfg, ctx)
                cache["ssm"][i].copy_(new["ssm"])
                cache["conv"][i].copy_(new["conv"])
            h = rmsnorm(params["ln_f"], h)
            return logits_last(params["embed"], cfg, h[:, 0]), cache
        for i, flag in enumerate(self.global_flags()):
            h, _, _ = B.dense_block_decode(
                layer_slice(params["layers"], i), h, cache["k"][i],
                cache["v"][i], cfg, ctx, pos=pos, is_global=bool(flag),
                use_kernel=opts.use_kernel)
        h = rmsnorm(params["ln_f"], h)
        return logits_last(params["embed"], cfg, h[:, 0]), cache


def _dense_prefill(p, h, cfg, ctx, opts, positions, is_global):
    """``model.py:490``: a dense or MoE block that also returns its K/V."""
    hn = rmsnorm(p["ln1"], h)
    q = attn_mod.project_q(p["attn"], hn, cfg)
    k, v = attn_mod.project_kv(p["attn"], hn, cfg)
    q = attn_mod.rope(q, positions, cfg.rope_theta)
    k = attn_mod.rope(k, positions, cfg.rope_theta)
    o = attn_mod.chunked_mha(
        q, k, v, ctx, causal=cfg.causal, is_global=is_global,
        window=cfg.sliding_window, chunk=opts.attn_chunk)
    h = h + attn_mod.out_proj(p["attn"], o, cfg)
    return h + B.ffn(p, rmsnorm(p["ln2"], h), cfg, ctx), (k, v)


def _mamba_prefill(p, h, cfg, ctx):
    """``model.py:510``: a Mamba block that also returns (final ssm state,
    conv tail).  The tail is the last W-1 rows of xBC before the conv.
    The scan is ``ssd_reference``, as in the reference."""
    L = h.shape[1]
    y, state, xBC = ssm_mod._mixer(p["mixer"], rmsnorm(p["ln"], h), cfg, ctx,
                                   use_kernel=False)
    conv_tail = xBC[:, L - (cfg.ssm_conv_width - 1):, :]   # pre-activation
    return h + y, (state, conv_tail.to(h.dtype))


def _tile(x: torch.Tensor, n: int) -> torch.Tensor:
    """``model.py:537``: n stacked copies (a new tensor, not a view)."""
    return x[None].repeat((n,) + (1,) * x.dim())


def precast(params, dtype: torch.dtype):
    """Port of ``_precast`` (``model.py:541``): cast every f32 leaf with
    ``ndim >= 2`` to the compute dtype; 1-D leaves stay f32.

    On the stacked tree that rounds the per-layer norm scales and qkv
    biases, shaped (L, d), and the ssm family's (L, H) ``A_log``, ``D``
    and ``dt_bias``, to bf16 while ``ln_f.scale``, shaped (d,), stays f32,
    exactly as the reference.  Casting is idempotent, so a
    server casts once at load and the per-step call returns the same
    tensors; the reference casts inside every jitted step.
    """
    if dtype == torch.float32:
        return params

    def walk(pr):
        if isinstance(pr, dict):
            return {k: walk(v) for k, v in pr.items()}
        if pr.dim() >= 2 and pr.dtype == torch.float32:
            return pr.to(dtype)
        return pr

    return walk(params)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
