"""Step factories, input specs and sharding assembly for every (arch x
shape) (port of ``repro/launch/steps.py``).

``input_specs(cfg, shape)`` returns ``meta`` stand-ins for every model
input, the reference's ``ShapeDtypeStruct``s: shapes and dtypes, no
allocation.  Shardings are DTensor placement tuples, one entry a mesh
dim, where the reference has ``NamedSharding``s.  ``build_plan`` bundles
a step with its abstract arguments and their placements; the dry-run
(``repro_torch.launch.dryrun``) traces it on fake DTensors.

The plan runs the plain path: ``ModelOpts`` defaults to
``use_kernel=False``, as the reference's does, and a CUDA kernel takes
no fake DTensor.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distrib.logical import (
    AxisRules, ShardCtx, abstract_params, axis_sizes, fsdp_tp_rules,
    param_shardings)
from repro_torch.models.blocks import ModelOpts
from repro_torch.models.model import Model, build_model, cache_axes
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, cosine_schedule)
from repro_torch.tree import leaves, unflatten

# ---------------------------------------------------------------------------
# Strategy -> AxisRules
# ---------------------------------------------------------------------------
STRATEGIES = ("fsdp_tp", "ddp_tp", "fsdp_tp_nosp", "tp_serve", "fsdp_dp")


def make_rules(cfg: ArchConfig, shape: ShapeSpec, mesh,
               strategy: str = "fsdp_tp") -> AxisRules:
    """``steps.py:31``: the rules of one strategy on ``mesh``."""
    sizes = axis_sizes(mesh)
    multi_pod = "pod" in sizes
    rules = fsdp_tp_rules(multi_pod)
    if strategy == "ddp_tp":
        rules = rules.replace(embed=None)          # params replicated over data
    elif strategy == "fsdp_tp_nosp":
        rules = rules.replace(seq=None)            # no residual seq sharding
    elif strategy == "tp_serve":
        rules = rules.replace(embed=None, seq=None)
    elif strategy == "fsdp_dp":
        # pure data parallelism over every mesh axis, FSDP weights over
        # 'data': activations never cross chips
        dp = ("pod", "data", "model") if multi_pod else ("data", "model")
        rules = rules.replace(
            batch=dp, seq=None, vocab=None, q_heads=None, kv_heads=None,
            kv_hd=None, ffn=None, inner=None, ssm_heads=None, ssm_hd=None,
            act_heads=None, act_ffn=None, experts=None)
    # decode adaptation: single-sequence long context shards the KV
    # sequence instead of the (too small) batch
    if shape.kind == "decode":
        if shape.global_batch % sizes.get("data", 1) != 0:
            rules = rules.replace(kv_seq="data", batch=None)
    return rules


# ---------------------------------------------------------------------------
# Input specs (meta stand-ins)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """``steps.py:68``: int32 tokens and labels, decode's (B, 1) token and
    scalar position, audio's frames and vlm's image embeddings in the
    compute dtype."""
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    if shape.kind == "train":
        batch: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32),
                                 "labels": _meta((B, S), torch.int32)}
    elif shape.kind == "prefill":
        batch = {"tokens": _meta((B, S), torch.int32)}
    elif shape.kind == "decode":
        return {"token": _meta((B, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    else:
        raise ValueError(shape.kind)
    if cfg.family == "audio":
        batch.pop("tokens", None)
        batch["frames"] = _meta((B, S, cfg.frame_dim), act)
    if cfg.family == "vlm":
        batch["image_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_model),
                                      act)
    return batch


def batch_axes(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Tuple]:
    ax: Dict[str, Tuple] = {}
    if shape.kind in ("train", "prefill"):
        ax["tokens"] = ("batch", "seq")
        ax["labels"] = ("batch", "seq")
        ax["frames"] = ("batch", "seq", None)
        ax["image_embeds"] = ("batch", "img", "act_embed")
    else:
        ax["token"] = ("batch", None)
        ax["pos"] = ()
    return ax


def abstract_cache(model: Model, shape: ShapeSpec,
                   dtype: torch.dtype = torch.bfloat16):
    return model.init_cache(shape.global_batch, shape.seq_len, dtype,
                            device="meta")


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------
def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_shardings(axes_tree, value_tree, ctx: ShardCtx):
    """Placements for an arbitrary (axes-annotated) value tree."""
    if _is_axes(axes_tree):
        return ctx.sharding_for(axes_tree, value_tree.shape)
    return {k: tree_shardings(axes_tree[k], v, ctx)
            for k, v in value_tree.items()}


def batch_shardings(cfg, shape, batch_sds, ctx: ShardCtx):
    axes = batch_axes(cfg, shape)
    return {k: ctx.sharding_for(axes[k], v.shape)
            for k, v in batch_sds.items()}


def cache_shardings(model: Model, cache_sds, ctx: ShardCtx):
    return tree_shardings(cache_axes(model.cfg), cache_sds, ctx)


# ---------------------------------------------------------------------------
# Step factories
# ---------------------------------------------------------------------------
def make_train_step(model: Model, ctx: ShardCtx, opts: ModelOpts,
                    ocfg: AdamWConfig = AdamWConfig(),
                    schedule_total: int = 10_000):
    """``steps.py:141``: the loss and its gradient with respect to the
    masters, the cosine schedule at the state's count and AdamW, which
    updates params and state IN PLACE (the reference donates them).  On
    a mesh each gradient is first redistributed to its master's
    placements (FSDP's reduce-scatter), where XLA propagates the
    masters' sharding to the update."""
    def train_step(params, opt_state, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = model.loss(params, batch, ctx, opts)
            grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        if ctx.mesh is not None:
            grads = [g.redistribute(ctx.mesh, p.placements)
                     for g, p in zip(grads, flat)]
        grads = unflatten(params, list(grads))
        lr_scale = cosine_schedule(opt_state["count"], total=schedule_total)
        metrics = adamw_update(grads, opt_state, params, ocfg, lr_scale)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model, ctx: ShardCtx, opts: ModelOpts):
    def prefill_step(params, batch):
        return model.prefill(params, batch, ctx, opts)

    return prefill_step


def make_decode_step(model: Model, ctx: ShardCtx, opts: ModelOpts):
    def decode_step(params, batch, cache):
        logits, cache = model.decode_step(params, batch, cache, ctx, opts)
        # dim 1, not -1: DTensor's argmax over a sharded vocab gathers
        # each shard's pick along the reduced dim, and torch 2.13's
        # all_gather_single mis-shapes a negative gather dim at batch 1
        next_token = torch.argmax(logits, dim=1).to(torch.int32)
        return next_token, logits, cache

    return decode_step


# ---------------------------------------------------------------------------
# One-call assembly for the dry-run and the tuner
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LoweringPlan:
    """A step, its abstract arguments (``meta`` trees) and their
    placements; ``donate`` names the arguments the step updates in
    place (the reference's ``donate_argnums``)."""
    fn: Any
    args: Tuple
    in_shardings: Tuple
    mesh: Any = None
    donate: Tuple[int, ...] = ()


def default_attn_chunk(cfg: ArchConfig) -> int:
    """Per-arch default attention chunk: smaller for archs whose
    (replicated-head) score blocks would dominate the per-chip transient
    footprint."""
    return 256 if cfg.family == "vlm" else 512


def build_plan(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               strategy: str = "fsdp_tp", opts: Optional[ModelOpts] = None,
               rules: Optional[AxisRules] = None) -> LoweringPlan:
    """``steps.py:196``: train steps on f32 masters with AdamW state,
    serving steps on bf16 parameters, decode on a bf16 cache."""
    model = build_model(cfg)
    rules = rules or make_rules(cfg, shape, mesh, strategy)
    ctx = ShardCtx(mesh=mesh, rules=rules)
    if opts is None:
        opts = ModelOpts(attn_chunk=default_attn_chunk(cfg))

    spec = model.param_spec()
    batch_sds = input_specs(cfg, shape)
    b_sh = batch_shardings(cfg, shape, batch_sds, ctx)

    if shape.kind == "train":
        params_sds = abstract_params(spec, torch.float32)
        p_sh = param_shardings(spec, ctx)
        opt_sds = adamw_init(params_sds)
        o_sh = {"m": p_sh, "v": p_sh, "count": ctx.sharding_for((), ())}
        fn = make_train_step(model, ctx, opts)
        return LoweringPlan(fn, (params_sds, opt_sds, batch_sds),
                            (p_sh, o_sh, b_sh), mesh, donate=(0, 1))

    params_sds = abstract_params(spec, torch.bfloat16)
    p_sh = param_shardings(spec, ctx)
    if shape.kind == "prefill":
        fn = make_prefill_step(model, ctx, opts)
        return LoweringPlan(fn, (params_sds, batch_sds), (p_sh, b_sh), mesh)

    cache_sds = abstract_cache(model, shape)
    c_sh = cache_shardings(model, cache_sds, ctx)
    fn = make_decode_step(model, ctx, opts)
    return LoweringPlan(fn, (params_sds, batch_sds, cache_sds),
                        (p_sh, b_sh, c_sh), mesh, donate=(2,))
