"""zamba2-7b — hybrid Mamba2 backbone + shared attention block.

81 Mamba2 layers, d_model=3584, ssm_state=64; a single weight-shared
attention+MLP block is applied after every 6th Mamba layer (simplified from
the per-invocation LoRA deltas of the released model; see DESIGN.md §6).
[arXiv:2411.15242; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    shared_attn_every=6,
    activation="swiglu",
)
