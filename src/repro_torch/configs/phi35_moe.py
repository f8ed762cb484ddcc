"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.

32 layers, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=6400,
vocab=32064, MoE FFN in every layer.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    activation="swiglu",
)
