"""The yardstick of a decode step: the card's peaks, and the operations
and bytes a step of a dense or MoE decoder needs, from the configuration
file and the lengths of the slots that carry a request.

A slot's length is the keys its attention reads: its position plus one.
Bytes count each weight a step reads once (the experts its tokens route
to, for an MoE), the K and V rows below each live slot's length once in
the cache's dtype, and the new rows written once.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from harness.weights import gated

# NVIDIA's data sheet, H100 SXM, dense rates at 700 W
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peak(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


def _elem(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]


def attn_params(cfg: Dict) -> int:
    d = cfg["d_model"]
    q = cfg["n_heads"] * cfg["head_dim"]
    kv = cfg["n_kv_heads"] * cfg["head_dim"]
    return 2 * d * q + 2 * d * kv


def expert_params(cfg: Dict) -> int:
    """One expert's (or the dense MLP's) FFN: three matrices if gated,
    two if not."""
    return (3 if gated(cfg) else 2) * cfg["d_model"] * cfg["d_ff"]


def active_params(cfg: Dict) -> int:
    """Weights a token multiplies, the embedding lookup left out: every
    layer's attention and FFN (``top_k`` experts and the router for an
    MoE) and the head."""
    ffn = expert_params(cfg)
    if cfg["family"] == "moe":
        ffn = cfg["top_k"] * ffn + cfg["d_model"] * cfg["n_experts"]
    return cfg["n_layers"] * (attn_params(cfg) + ffn) + \
        cfg["d_model"] * cfg["vocab"]


def experts_touched(cfg: Dict, tokens: int) -> float:
    """Experts of a layer that ``tokens`` tokens route to, expected under
    routing spread evenly: each expert is missed by one token with
    probability (E - k) / E."""
    E, k = cfg["n_experts"], cfg["top_k"]
    return E * (1.0 - ((E - k) / E) ** tokens)


def step_flops(cfg: Dict, lengths: np.ndarray) -> float:
    """Model operations of one step over the live slots' lengths: two a
    weight a token, and q.k and p.v over each slot's keys."""
    lengths = np.asarray(lengths, np.float64)
    attn = 4.0 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"] * \
        lengths.sum()
    return 2.0 * active_params(cfg) * len(lengths) + attn


def kv_bytes(cfg: Dict, lengths: np.ndarray) -> float:
    """K and V rows below each length, every layer, read once; the new
    rows written once."""
    lengths = np.asarray(lengths, np.float64)
    row = cfg["n_kv_heads"] * cfg["head_dim"] * _elem(cfg["kv_cache_dtype"])
    return 2.0 * cfg["n_layers"] * row * (lengths.sum() + len(lengths))


def step_bytes(cfg: Dict, lengths: np.ndarray) -> float:
    """Bytes one step needs: the weights it reads once, the embedding
    rows of its tokens, and the K and V of its slots."""
    n = len(lengths)
    d, w = cfg["d_model"], _elem(cfg["dtype"])
    ffn = expert_params(cfg)
    if cfg["family"] == "moe":
        ffn = experts_touched(cfg, n) * ffn + d * cfg["n_experts"]
    weights = cfg["n_layers"] * (attn_params(cfg) + ffn + 2 * d) + \
        d * cfg["vocab"] + d + n * d
    return weights * w + kv_bytes(cfg, lengths)


def decode_attn_bytes(cfg: Dict, lengths: np.ndarray) -> float:
    """What one layer's decode attention must move: K and V below each
    live slot's length, q read and the output written in the cache's
    dtype, and the lengths."""
    lengths = np.asarray(lengths, np.float64)
    e = _elem(cfg["kv_cache_dtype"])
    kv = 2.0 * lengths.sum() * cfg["n_kv_heads"] * cfg["head_dim"] * e
    qo = 2.0 * len(lengths) * cfg["n_heads"] * cfg["head_dim"] * e
    return kv + qo + 4.0 * len(lengths)
