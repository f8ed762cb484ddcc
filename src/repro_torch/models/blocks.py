"""Dense transformer block, pre-norm residual (port of
``repro/models/blocks.py``; MoE, Mamba and cross-attention blocks belong
to later slices)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.distrib.logical import ShardCtx
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec


@dataclasses.dataclass(frozen=True)
class ModelOpts:
    """Run-time knobs of the serving path (``blocks.py:19``; the
    reference's training knobs come with the training slice)."""
    attn_chunk: int = 512        # query chunk of the prefill attention
    use_kernel: bool = False     # hand-written CUDA kernels


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE block is not ported yet")


def dense_block_spec(cfg: ArchConfig) -> dict:
    _dense_only(cfg)
    return {
        "ln1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attn_spec(cfg),
        "ln2": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_spec(cfg),
    }


def dense_block_decode(p, h, k_cache, v_cache, cfg: ArchConfig,
                       ctx: ShardCtx, *, pos, is_global=True,
                       use_kernel: bool = False):
    """One-token step (``blocks.py:73``).  Writes this token's K/V into the
    caches in place (see ``attention.decode_self_attention``).
    Returns (h, k_new, v_new)."""
    a, k_new, v_new = attn.decode_self_attention(
        p["attn"], rmsnorm(p["ln1"], h), k_cache, v_cache, cfg, ctx,
        pos=pos, is_global=is_global, use_kernel=use_kernel)
    h = h + a
    return h + mlp(p["mlp"], rmsnorm(p["ln2"], h), cfg, ctx), k_new, v_new
