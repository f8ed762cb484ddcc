"""Model assembly for the dense family: specs, prefill, decode (port of
``repro/models/model.py``).

Parameters are an explicit nested dict of tensors with the reference's
keys and stacked per-layer layout (leading ``layers`` axis), so a JAX tree
loads as it is (``repro_torch.interop``).  The reference's ``lax.scan``
over the stack is a Python loop over its slices here.
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
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.layers import (
    embed, embed_spec, logits_last, mlp, rmsnorm, rmsnorm_spec)


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


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def _check_family(self) -> None:
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"{self.cfg.name}: family {self.cfg.family!r} is not ported "
                "yet; the port covers the dense family")

    def param_spec(self) -> dict:
        """``model.py:64`` for the dense family."""
        self._check_family()
        cfg = self.cfg
        return {"embed": embed_spec(cfg),
                "ln_f": rmsnorm_spec(cfg.d_model),
                "layers": stack_spec(B.dense_block_spec(cfg), cfg.n_layers)}

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
        """Seeded parameters on ``generator.device``."""
        return init_params(generator, self.param_spec(), dtype)

    def global_flags(self) -> np.ndarray:
        return np.array([g for _, g in self.cfg.layer_pattern()], bool)

    # ---------------- prefill (forward + KV cache) ----------------
    def prefill(self, params, batch, ctx: ShardCtx = NOSHARD,
                opts: ModelOpts = ModelOpts()):
        """``model.py:234``: -> (last-position logits (B, V) f32, cache)
        with cache {"k", "v"}: (L, B, S, Hkv, D) in the compute dtype."""
        self._check_family()
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        params = precast(params, dtype)
        h = embed(params["embed"], batch["tokens"], dtype)
        positions = torch.arange(h.shape[1], device=h.device)[None]
        ks, vs = [], []
        for i, flag in enumerate(self.global_flags()):
            h, (k, v) = _dense_prefill(layer_slice(params["layers"], i), h,
                                       cfg, ctx, opts, positions, bool(flag))
            ks.append(k)
            vs.append(v)
        h = rmsnorm(params["ln_f"], h)
        return (logits_last(params["embed"], cfg, h[:, -1]),
                {"k": torch.stack(ks), "v": torch.stack(vs)})

    # ---------------- decode ----------------
    def init_cache(self, batch: int, seq: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: Any = "cpu") -> Dict[str, torch.Tensor]:
        """``model.py:315``: zeros (L, B, S, Hkv, D) for k and v."""
        self._check_family()
        cfg = self.cfg
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def decode_step(self, params, batch, cache, ctx: ShardCtx = NOSHARD,
                    opts: ModelOpts = ModelOpts()):
        """One token for every sequence in the batch (``model.py:351``).

        batch: {"token": (B,1) int, "pos": scalar int or (B,) int}
        -> (logits (B,V) f32, cache)

        A scalar ``pos`` is the lockstep path; a ``(B,)`` vector gives each
        slot its own position.  The cache is updated IN PLACE, one layer at
        a time, and returned; its final contents equal the reference's
        single write after the layer scan (``model.py:386-399``).
        """
        self._check_family()
        cfg = self.cfg
        dtype = compute_dtype(cfg)
        params = precast(params, dtype)
        pos = batch["pos"]
        h = embed(params["embed"], batch["token"], dtype)   # (B,1,D)
        for i, flag in enumerate(self.global_flags()):
            h, _, _ = B.dense_block_decode(
                layer_slice(params["layers"], i), h, cache["k"][i],
                cache["v"][i], cfg, ctx, pos=pos, is_global=bool(flag),
                use_kernel=opts.use_kernel)
        h = rmsnorm(params["ln_f"], h)
        return logits_last(params["embed"], cfg, h[:, 0]), cache


def _dense_prefill(p, h, cfg, ctx, opts, positions, is_global):
    """``model.py:490``: a dense block that also returns its K/V."""
    hn = rmsnorm(p["ln1"], h)
    q = attn_mod.project_q(p["attn"], hn, cfg)
    k, v = attn_mod.project_kv(p["attn"], hn, cfg)
    q = attn_mod.rope(q, positions, cfg.rope_theta)
    k = attn_mod.rope(k, positions, cfg.rope_theta)
    o = attn_mod.chunked_mha(
        q, k, v, ctx, causal=cfg.causal, is_global=is_global,
        window=cfg.sliding_window, chunk=opts.attn_chunk)
    h = h + attn_mod.out_proj(p["attn"], o, cfg)
    return h + mlp(p["mlp"], rmsnorm(p["ln2"], h), cfg, ctx), (k, v)


def precast(params, dtype: torch.dtype):
    """Port of ``_precast`` (``model.py:541``): cast every f32 leaf with
    ``ndim >= 2`` to the compute dtype; 1-D leaves stay f32.

    On the stacked tree that rounds the per-layer norm scales and qkv
    biases, shaped (L, d), to bf16 while ``ln_f.scale``, shaped (d,),
    stays f32, exactly as the reference.  Casting is idempotent, so a
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
