"""llama4-scout-17b-a16e — 16-expert top-1 MoE (early-fusion text backbone).

48 layers, d_model=5120, 40 heads (GQA kv=8), per-expert d_ff=8192,
vocab=202048, MoE FFN in every layer, top-1 routing.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    rope_theta=500_000.0,
    activation="swiglu",
)
