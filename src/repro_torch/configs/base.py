"""Architecture configuration schema (copy of ``repro/configs/base.py``).

The port keeps its own copy so that it imports nothing from ``repro``.
Every assigned architecture is expressed as a :class:`ArchConfig`;
``cfg.reduced()`` (verbatim from the reference) shrinks every dimension
while preserving the family structure, for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds used by the layer-stack builders.
DENSE = "dense"            # self-attn + MLP
MOE = "moe"                # self-attn + MoE FFN
MAMBA = "mamba"            # Mamba2 SSD block
ENCODER = "encoder"        # bidirectional self-attn + MLP


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # --- attention pattern ---
    causal: bool = True              # False => encoder-only (bidirectional)
    sliding_window: int = 0          # >0 => local attention window
    local_global_ratio: int = 0      # e.g. 5 => pattern [local x5, global] (gemma3)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- MLP ---
    activation: str = "swiglu"       # swiglu | geglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2-style): shared attention block every k mamba layers ---
    shared_attn_every: int = 0
    # --- VLM: cross-attention block every k self-attn layers ---
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # --- audio: precomputed frame-embedding input dimension (stub frontend) ---
    frame_dim: int = 0
    # --- misc ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-context shape?

        SSM / hybrid archs are linear in context.  gemma3's 5:1
        local:global pattern is dominated by windowed (linear) layers and the
        500k cell is decode-only (O(S) per step), so it is included; pure
        full-attention archs are excluded (see DESIGN.md §6).
        """
        return self.family in ("ssm", "hybrid") or self.local_global_ratio > 0

    # ------------------------------------------------------------------
    def n_params(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and sanity)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.activation in ("swiglu", "geglu"):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        total = emb
        for kind, _ in self.layer_pattern():
            if kind in (DENSE, ENCODER):
                total += per_layer_attn + mlp + 2 * d
            elif kind == MOE:
                total += per_layer_attn + self.n_experts * mlp + d * self.n_experts + 2 * d
            elif kind == MAMBA:
                di, st, h = self.d_inner, self.ssm_state, self.ssm_heads
                conv_dim = di + 2 * st
                # in_proj [z, x, B, C, dt] + out_proj + conv + norms + A/D/dt
                total += d * (2 * di + 2 * st + h) + di * d + 2 * d \
                    + (self.ssm_conv_width + 1) * conv_dim + di + 3 * h
        if self.shared_attn_every:
            total += per_layer_attn + mlp + 2 * d      # one shared block
        if self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            total += n_cross * (per_layer_attn + 2 * d)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f if self.activation in ("swiglu", "geglu") else 2 * d * f
        inactive = sum(
            (self.n_experts - self.top_k) * mlp
            for kind, _ in self.layer_pattern() if kind == MOE
        )
        return self.n_params() - inactive

    # ------------------------------------------------------------------
    def layer_pattern(self):
        """Yield (kind, is_global) per layer, in order."""
        for i in range(self.n_layers):
            if self.family == "ssm" or (self.family == "hybrid"):
                yield (MAMBA, False)
            elif self.family == "audio":
                yield (ENCODER, True)
            elif self.n_experts:
                yield (MOE, True)
            elif self.local_global_ratio:
                r = self.local_global_ratio + 1
                yield (DENSE, (i % r) == (r - 1))
            else:
                yield (DENSE, True)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        r = min(self.local_global_ratio, 2)
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers)) if not self.shared_attn_every
            else 4,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            sliding_window=min(self.sliding_window, 8) if self.sliding_window else 0,
            local_global_ratio=r,
            shared_attn_every=2 if self.shared_attn_every else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            n_image_tokens=min(self.n_image_tokens, 8) if self.n_image_tokens else 0,
            frame_dim=32 if self.frame_dim else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell for an architecture."""
    name: str              # train_4k | prefill_32k | decode_32k | long_500k
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ArchConfig) -> Tuple[Tuple[ShapeSpec, Optional[str]], ...]:
    """All 4 assigned shapes with an optional skip-reason per cell."""
    out = []
    for s in ALL_SHAPES:
        reason = None
        if s.kind == "decode" and cfg.is_encoder_only:
            reason = "encoder-only arch has no decode step"
        elif s.name == "long_500k" and not cfg.sub_quadratic:
            reason = "pure full-attention arch; 500k context skipped (DESIGN.md §6)"
        out.append((s, reason))
    return tuple(out)
