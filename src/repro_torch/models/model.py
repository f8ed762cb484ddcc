"""Model assembly: parameter specs, forward, loss, prefill, decode (port of
``repro/models/model.py``) for every family of the reference: dense, moe,
ssm, hybrid (zamba2's Mamba stack with one shared attention block), vlm
(self-attention groups, each closed by a cross-attention block to image
embeddings) and audio (an encoder over frame embeddings).

Parameters are an explicit nested dict of tensors with the reference's
keys and stacked per-layer layout (leading ``layers`` axes, two of them
for the grouped hybrid and vlm stacks), so a JAX tree loads as it is
(``repro_torch.interop``).  The reference's ``lax.scan`` over a stack is
a Python loop over its slices here.  With ``opts.banded_local`` a
local:global stack (gemma3's 5:1) runs as superblocks whose local layers
take the banded attention (``Model._forward_banded``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.logical import (
    NOSHARD, P, ShardCtx, abstract_params, init_params, spec_map)
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as B
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.layers import (
    chunked_cross_entropy, embed, embed_spec, logits_last, rmsnorm,
    rmsnorm_spec, unembed_matrix)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
ATTENTION_FAMILIES = ("dense", "moe")     # a stack of dense_block, KV cache
GROUPED_FAMILIES = ("hybrid", "vlm")      # two-level stacks, lockstep decode


def stack_spec(spec: dict, *ns: int) -> dict:
    """Prepend scan dims to every leaf (logical axis 'layers')."""
    extra = tuple(ns)
    return spec_map(
        lambda p: P(extra + p.shape, ("layers",) * len(extra) + p.axes,
                    p.scale, p.init),
        spec)


def _groups(cfg: ArchConfig) -> Tuple[int, int, int]:
    """``model.py:44``: (n_groups, group_len, remainder) of a grouped
    stack.  hybrid: groups of ``shared_attn_every`` Mamba layers, each
    followed by the shared block, and the remainder after them; vlm:
    groups of ``cross_attn_every - 1`` self-attention layers and one
    cross block, the remainder dropped."""
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return cfg.n_layers // k, k, cfg.n_layers % k
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        n = cfg.n_layers // k
        return n, k - 1, cfg.n_layers - n * k
    raise ValueError(cfg.family)


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


def unstack_groups(tree, g: int, k: int) -> list:
    """A (g, k)-stacked tree as g lists of k layers, as views."""
    return [unstack(p_g, k) for p_g in unstack(tree, g)]


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def _check_family(self) -> None:
        if self.cfg.family not in FAMILIES:
            raise ValueError(self.cfg.family)

    def param_spec(self) -> dict:
        """``model.py:64``."""
        self._check_family()
        cfg = self.cfg
        spec: Dict[str, Any] = {"embed": embed_spec(cfg),
                                "ln_f": rmsnorm_spec(cfg.d_model)}
        if cfg.family == "audio":
            spec["frame_proj"] = P((cfg.frame_dim, cfg.d_model),
                                   (None, "embed"))
        if cfg.family in ATTENTION_FAMILIES + ("audio",):
            spec["layers"] = stack_spec(B.dense_block_spec(cfg), cfg.n_layers)
        elif cfg.family == "ssm":
            spec["layers"] = stack_spec(B.mamba_block_spec(cfg), cfg.n_layers)
        elif cfg.family == "hybrid":
            g, k, r = _groups(cfg)
            spec["groups"] = stack_spec(B.mamba_block_spec(cfg), g, k)
            spec["shared"] = B.dense_block_spec(cfg)
            if r:
                spec["rem"] = stack_spec(B.mamba_block_spec(cfg), r)
        else:
            g, k, _ = _groups(cfg)
            spec["self"] = stack_spec(B.dense_block_spec(cfg), g, k)
            spec["cross"] = stack_spec(B.cross_block_spec(cfg), g)
        return spec

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
        """Seeded parameters on ``generator.device``."""
        return init_params(generator, self.param_spec(), dtype)

    def abstract_params(self, dtype: torch.dtype = torch.float32) -> dict:
        """``model.py:92``: ``meta`` tensors of every leaf, nothing
        drawn."""
        return abstract_params(self.param_spec(), dtype)

    def global_flags(self) -> np.ndarray:
        return np.array([g for _, g in self.cfg.layer_pattern()], bool)

    # ---------------- forward and loss ----------------
    def _embed_in(self, params, batch, dtype: torch.dtype,
                  ctx: ShardCtx = NOSHARD) -> torch.Tensor:
        """``model.py:99``: audio projects its frame embeddings, every
        other family embeds its tokens."""
        if self.cfg.family == "audio":
            return ctx.matmul(batch["frames"].to(dtype),
                              params["frame_proj"].to(dtype))
        return embed(params["embed"], batch["tokens"], dtype, ctx)

    def forward(self, params, batch, ctx: ShardCtx = NOSHARD,
                opts: ModelOpts = ModelOpts()):
        """``model.py:106``: -> (hidden (B, S, D) after the final norm,
        aux loss).  The aux loss is the MoE router's, summed over the
        layers (``model.py:135-137``); an f32 zero for the other families.
        For the ssm and hybrid families ``opts.use_kernel`` runs every
        Mamba layer's scan through the ``ssd_scan`` kernel, which has no
        backward: under grad with parameters that require it, that raises
        (training runs ``ssd_reference``, as the reference does).  The vlm
        family reads ``batch["image_embeds"]`` (B, n_img, D), audio
        ``batch["frames"]`` (B, S, frame_dim) in place of tokens.

        With ``opts.banded_local`` on a config with a local:global ratio
        and a window (dense, moe, audio), ``_forward_banded`` runs the
        stack (``model.py:118-126``).

        Differentiable: gradients reach the f32 masters through
        ``precast``; ``opts.remat`` recomputes each layer, or each group
        of a grouped stack, in the backward (``blocks.remat_wrap``)."""
        self._check_family()
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        params = _top_weights(precast(params, dtype), ctx)
        h = ctx.constrain(self._embed_in(params, batch, dtype, ctx),
                          "batch", "seq", "act_embed")
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        positions = torch.arange(h.shape[1], device=h.device)[None]
        if cfg.family in ATTENTION_FAMILIES + ("audio",) and \
                opts.banded_local and cfg.local_global_ratio and \
                cfg.sliding_window:
            h, aux = self._forward_banded(params, h, cfg, ctx, opts,
                                          positions)
        elif cfg.family in ATTENTION_FAMILIES + ("audio",):
            body = B.remat_wrap(B.dense_block, opts)
            for p_i, flag in zip(unstack(params["layers"], cfg.n_layers),
                                 self.global_flags()):
                h, a = body(p_i, h, cfg, ctx, opts, positions=positions,
                            is_global=bool(flag))
                aux = aux + a
        elif cfg.family == "ssm":
            body = B.remat_wrap(B.mamba_block, opts)
            for p_i in unstack(params["layers"], cfg.n_layers):
                h = body(p_i, h, cfg, ctx, opts)
        elif cfg.family == "hybrid":
            g, k, r = _groups(cfg)
            shared = params["shared"]

            def group(hh, p_g):
                for p_i in p_g:
                    hh = B.mamba_block(p_i, hh, cfg, ctx, opts)
                return B.dense_block(shared, hh, cfg, ctx, opts,
                                     positions=positions)[0]

            body = B.remat_wrap(group, opts)
            for p_g in unstack_groups(params["groups"], g, k):
                h = body(h, p_g)
            if r:
                body = B.remat_wrap(B.mamba_block, opts)
                for p_i in unstack(params["rem"], r):
                    h = body(p_i, h, cfg, ctx, opts)
        else:
            g, k, _ = _groups(cfg)
            img = batch["image_embeds"].to(dtype)

            def group(hh, p_self, p_cross):
                for p_i in p_self:
                    hh = B.dense_block(p_i, hh, cfg, ctx, opts,
                                       positions=positions)[0]
                return B.cross_block(p_cross, hh, img, cfg, ctx, opts)

            body = B.remat_wrap(group, opts)
            for p_self, p_cross in zip(
                    unstack_groups(params["self"], g, k),
                    unstack(params["cross"], g)):
                h = body(h, p_self, p_cross)
        return rmsnorm(params["ln_f"], h), aux

    def _forward_banded(self, params, h, cfg, ctx, opts, positions):
        """``model.py:185``: the stack as ``n_layers // (ratio + 1)``
        superblocks of ``ratio`` local layers on the banded attention and
        one global layer on the full causal one, then the local remainder.
        ``opts.remat`` wraps each superblock and each remainder layer.

        The reference gathers the superblocks' stacks from the layer
        stack; here the layers are the stack's ``unstack`` views, picked
        by index, so no leaf is copied.  The local layers keep the
        reference's default ``is_global=True``: ``banded_mha`` applies
        the window regardless."""
        r = cfg.local_global_ratio + 1
        n_groups = cfg.n_layers // r
        li = [[g * r + j for j in range(r - 1)] for g in range(n_groups)]
        gi = [g * r + r - 1 for g in range(n_groups)]
        rem = range(n_groups * r, cfg.n_layers)
        layers = unstack(params["layers"], cfg.n_layers)

        def local(hh, p_i):
            return B.dense_block(p_i, hh, cfg, ctx, opts,
                                 positions=positions, banded=True)

        def group(hh, p_loc, p_glob):
            aux = 0.0
            for p_i in p_loc:
                hh, a = local(hh, p_i)
                aux = aux + a
            hh, a = B.dense_block(p_glob, hh, cfg, ctx, opts,
                                  positions=positions, is_global=True)
            return hh, aux + a

        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        body = B.remat_wrap(group, opts)
        for loc, glob in zip(li, gi):
            h, a = body(h, [layers[i] for i in loc], layers[glob])
            aux = aux + a
        body = B.remat_wrap(local, opts)
        for i in rem:
            h, a = body(h, layers[i])
            aux = aux + a
        return h, aux

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
        """``model.py:234``: -> (last-position logits (B, V) f32, cache);
        audio, an encoder, returns per-frame logits (B, S, V) f32 and an
        empty cache (``model.py:302-307``).  The cache, K/V in the compute
        dtype, ssm states f32, conv tails in the compute dtype:

        * dense, moe: {"k", "v"}: (L, B, S, Hkv, D);
        * ssm: {"ssm": (L, B, H, P, N), "conv": (L, B, W-1, C)};
        * hybrid: {"ssm", "conv"} of (g, k, ...) and the shared block's
          {"k", "v"} of (g, B, S, Hkv, D), plus {"rem_ssm", "rem_conv"}
          of (r, ...) where the stack has a remainder;
        * vlm: {"k", "v"} of (g, k, B, S, Hkv, D) and the projected image
          K/V {"xk", "xv"} of (g, B, n_img, Hkv, D).

        Every Mamba layer runs ``ssd_reference``, as the reference does,
        whatever ``opts.use_kernel`` says."""
        self._check_family()
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        params = _top_weights(precast(params, dtype), ctx)
        if cfg.family == "audio":
            h, _ = self.forward(params, batch, ctx, opts)
            w = unembed_matrix(params["embed"], cfg, h.dtype)
            return ctx.matmul(h, w).float(), {}
        h = ctx.constrain(embed(params["embed"], batch["tokens"], dtype, ctx),
                          "batch", "seq", "act_embed")
        positions = torch.arange(h.shape[1], device=h.device)[None]

        def mamba_stack(layers):
            nonlocal h
            ssms, convs = [], []
            for p_i in layers:
                h, (st, conv) = _mamba_prefill(p_i, h, cfg, ctx)
                ssms.append(st)
                convs.append(conv)
            return torch.stack(ssms), torch.stack(convs)

        def dense_stack(layers, flags):
            nonlocal h
            ks, vs = [], []
            for p_i, flag in zip(layers, flags):
                h, (k, v) = _dense_prefill(p_i, h, cfg, ctx, opts, positions,
                                           bool(flag))
                ks.append(k)
                vs.append(v)
            return torch.stack(ks), torch.stack(vs)

        if cfg.family in ATTENTION_FAMILIES:
            k, v = dense_stack(unstack(params["layers"], cfg.n_layers),
                               self.global_flags())
            cache = {"k": k, "v": v}
        elif cfg.family == "ssm":
            ssm, conv = mamba_stack(unstack(params["layers"], cfg.n_layers))
            cache = {"ssm": ssm, "conv": conv}
        elif cfg.family == "hybrid":
            g, k, r = _groups(cfg)
            parts = []
            for p_g in unstack_groups(params["groups"], g, k):
                ssm, conv = mamba_stack(p_g)
                h, (kk, vv) = _dense_prefill(params["shared"], h, cfg, ctx,
                                             opts, positions, True)
                parts.append((ssm, conv, kk, vv))
            cache = dict(zip(("ssm", "conv", "k", "v"),
                             map(torch.stack, zip(*parts))))
            if r:
                cache["rem_ssm"], cache["rem_conv"] = mamba_stack(
                    unstack(params["rem"], r))
        else:
            g, k, _ = _groups(cfg)
            img = batch["image_embeds"].to(dtype)
            parts = []
            for p_self, p_cross in zip(
                    unstack_groups(params["self"], g, k),
                    unstack(params["cross"], g)):
                ks, vs = dense_stack(p_self, [True] * k)
                p_cross = ctx.weights(p_cross)
                xk, xv = attn_mod.project_kv(p_cross["xattn"], img, cfg,
                                             ctx)
                h = B.cross_block_cached(p_cross, h, xk, xv, cfg, ctx)
                parts.append((ks, vs, xk, xv))
            cache = dict(zip(("k", "v", "xk", "xv"),
                             map(torch.stack, zip(*parts))))
        h = rmsnorm(params["ln_f"], h)
        return logits_last(params["embed"], cfg, h[:, -1]), cache

    # ---------------- decode ----------------
    def init_cache(self, batch: int, seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Any = "cpu") -> Dict[str, torch.Tensor]:
        """``model.py:315``: zeros shaped as ``prefill``'s cache, K/V
        ``seq`` long (the ssm states are f32 whatever ``dtype`` is;
        the ssm family ignores ``seq``).  audio, an encoder, has no decode
        cache and raises ValueError, as the reference does."""
        self._check_family()
        cfg = self.cfg

        def kv(*lead):
            return torch.zeros(lead + (batch, seq, cfg.n_kv_heads,
                                       cfg.head_dim),
                               dtype=dtype, device=device)

        def mamba(*lead):
            m = ssm_mod.mamba_init_cache(cfg, batch, dtype, device)
            return {key: _tile(v, lead) for key, v in m.items()}

        if cfg.family in ATTENTION_FAMILIES:
            return {"k": kv(cfg.n_layers), "v": kv(cfg.n_layers)}
        if cfg.family == "ssm":
            return mamba(cfg.n_layers)
        if cfg.family == "hybrid":
            g, k, r = _groups(cfg)
            cache = {**mamba(g, k), "k": kv(g), "v": kv(g)}
            if r:
                cache.update({"rem_" + key: v
                              for key, v in mamba(r).items()})
            return cache
        if cfg.family == "vlm":
            g, k, _ = _groups(cfg)
            img = (g, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)
            return {"k": kv(g, k), "v": kv(g, k),
                    "xk": torch.zeros(img, dtype=dtype, device=device),
                    "xv": torch.zeros(img, dtype=dtype, device=device)}
        raise ValueError(f"{cfg.family} has no decode cache")

    @torch.no_grad()
    def decode_step(self, params, batch, cache, ctx: ShardCtx = NOSHARD,
                    opts: ModelOpts = ModelOpts()):
        """One token for every sequence in the batch (``model.py:351``).

        batch: {"token": (B,1) int, "pos": scalar int or (B,) int}
        -> (logits (B,V) f32, cache)

        A scalar ``pos`` is the lockstep path; a ``(B,)`` vector gives each
        slot its own position.  The ssm family's recurrent state has no
        position and ignores it (``model.py:402-411``); hybrid and vlm take
        a scalar only and raise NotImplementedError on a vector, as the
        reference does.  The cache is updated IN PLACE, one layer at a
        time, and returned; its final contents equal the reference's
        (``model.py:386-399``, ``:438-443``, ``:471-476``), each entry in
        its own dtype (where the reference's widens, the conv history of
        a float32 model on a bf16 cache, the port's holds the same values
        rounded).  Only the dense and moe stacks take ``opts.use_kernel``
        (the flash-decode kernel): the hybrid's shared block and the vlm's
        self-attention layers run ``decode_mha``, as the reference passes
        them no kernel.
        """
        self._check_family()
        cfg = self.cfg
        pos = batch["pos"]
        if cfg.family in GROUPED_FAMILIES and torch.as_tensor(pos).dim() == 1:
            raise NotImplementedError(
                f"per-slot decode positions: {cfg.family} family serves via "
                "the lockstep path")
        if cfg.family == "audio":
            raise ValueError(f"{cfg.family} has no decode step")
        dtype = compute_dtype(cfg)
        params = _top_weights(precast(params, dtype), ctx)
        h = ctx.constrain(embed(params["embed"], batch["token"], dtype, ctx),
                          "batch", "seq", "act_embed")      # (B,1,D)

        def mamba_layer(p_i, ssm, conv):
            nonlocal h
            h, new = B.mamba_block_decode(p_i, h, {"ssm": ssm, "conv": conv},
                                          cfg, ctx)
            ssm.copy_(new["ssm"])
            conv.copy_(new["conv"])

        def attention_layer(p_i, k_cache, v_cache, is_global=True,
                            use_kernel=False):
            nonlocal h
            h, _, _ = B.dense_block_decode(
                p_i, h, k_cache, v_cache, cfg, ctx, pos=pos,
                is_global=is_global, use_kernel=use_kernel)

        if cfg.family in ATTENTION_FAMILIES:
            for i, (p_i, flag) in enumerate(zip(
                    unstack(params["layers"], cfg.n_layers),
                    self.global_flags())):
                attention_layer(p_i, cache["k"][i], cache["v"][i],
                                bool(flag), opts.use_kernel)
        elif cfg.family == "ssm":
            for i, p_i in enumerate(unstack(params["layers"], cfg.n_layers)):
                mamba_layer(p_i, cache["ssm"][i], cache["conv"][i])
        elif cfg.family == "hybrid":
            g, k, r = _groups(cfg)
            for gi, p_g in enumerate(unstack_groups(params["groups"], g, k)):
                for j, p_i in enumerate(p_g):
                    mamba_layer(p_i, cache["ssm"][gi, j], cache["conv"][gi, j])
                attention_layer(params["shared"], cache["k"][gi],
                                cache["v"][gi])
            if r:
                for i, p_i in enumerate(unstack(params["rem"], r)):
                    mamba_layer(p_i, cache["rem_ssm"][i],
                                cache["rem_conv"][i])
        else:
            g, k, _ = _groups(cfg)
            for gi, (p_self, p_cross) in enumerate(zip(
                    unstack_groups(params["self"], g, k),
                    unstack(params["cross"], g))):
                for j, p_i in enumerate(p_self):
                    attention_layer(p_i, cache["k"][gi, j], cache["v"][gi, j])
                h = B.cross_block_cached(p_cross, h, cache["xk"][gi],
                                         cache["xv"][gi], cfg, ctx)
        h = rmsnorm(params["ln_f"], h)
        return logits_last(params["embed"], cfg, h[:, 0]), cache


def _dense_prefill(p, h, cfg, ctx, opts, positions, is_global):
    """``model.py:490``: a dense or MoE block that also returns its K/V."""
    p = ctx.weights(p)
    hn = rmsnorm(p["ln1"], h)
    q = attn_mod.project_q(p["attn"], hn, cfg, ctx)
    k, v = attn_mod.project_kv(p["attn"], hn, cfg, ctx)
    q = attn_mod.rope(q, positions, cfg.rope_theta)
    k = attn_mod.rope(k, positions, cfg.rope_theta)
    o = attn_mod.chunked_mha(
        q, k, v, ctx, causal=cfg.causal, is_global=is_global,
        window=cfg.sliding_window, chunk=opts.attn_chunk)
    h = h + attn_mod.out_proj(p["attn"], o, cfg, ctx)
    return h + B.ffn(p, rmsnorm(p["ln2"], h), cfg, ctx), (k, v)


def _mamba_prefill(p, h, cfg, ctx):
    """``model.py:510``: a Mamba block that also returns (final ssm state,
    conv tail).  The tail is the last W-1 rows of xBC before the conv.
    The scan is ``ssd_reference``, as in the reference."""
    p = ctx.weights(p)
    L = h.shape[1]
    y, state, xBC = ssm_mod._mixer(p["mixer"], rmsnorm(p["ln"], h), cfg, ctx,
                                   use_kernel=False)
    conv_tail = xBC[:, L - (cfg.ssm_conv_width - 1):, :]   # pre-activation
    return h + y, (state, conv_tail.to(h.dtype))


def _top_weights(params, ctx: ShardCtx):
    """The parameters outside the layer stacks (embedding, final norm,
    audio's frame projection) gathered once for the step
    (``ShardCtx.weights``); the stacks gather a layer at a time."""
    top = {k: params[k] for k in ("embed", "ln_f", "frame_proj")
           if k in params}
    return {**params, **ctx.weights(top)}


def _tile(x: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
    """``model.py:537``, nested: copies of x stacked over the leading
    dims ``lead`` (a new tensor, not a view)."""
    return x.repeat(lead + (1,) * x.dim())


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


# Logical axes of the decode caches, in ``Model.init_cache``'s structure
# (``model.py:568``).  "kv_heads" and "kv_hd" both map to "model"; the
# divisibility guard of ``logical_to_spec`` picks whichever divides (GQA
# kv=8 on a 16-way model axis falls through to the head dim).  "kv_seq"
# maps to "data" only in the single-sequence decode adaptation
# (``repro_torch.launch.steps.make_rules``).
KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "kv_hd")
SSM_AXES = ("layers", "batch", "ssm_heads", None, "state")
CONV_AXES = ("layers", "batch", None, "inner")


def cache_axes(cfg: ArchConfig) -> dict:
    if cfg.family in ATTENTION_FAMILIES:
        return {"k": KV_AXES, "v": KV_AXES}
    if cfg.family == "ssm":
        return {"ssm": SSM_AXES, "conv": CONV_AXES}
    if cfg.family == "hybrid":
        ax = {"ssm": ("layers",) + SSM_AXES,
              "conv": ("layers",) + CONV_AXES, "k": KV_AXES, "v": KV_AXES}
        if _groups(cfg)[2]:
            ax["rem_ssm"], ax["rem_conv"] = SSM_AXES, CONV_AXES
        return ax
    if cfg.family == "vlm":
        img_axes = ("layers", "batch", "img", "kv_heads", "kv_hd")
        return {"k": ("layers",) + KV_AXES, "v": ("layers",) + KV_AXES,
                "xk": img_axes, "xv": img_axes}
    raise ValueError(f"{cfg.family} has no decode cache")


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
