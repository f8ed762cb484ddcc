"""mamba2-130m — attention-free SSM with state-space duality (SSD).

24 Mamba2 layers, d_model=768, d_state=128, head_dim=64 (24 SSD heads at
expand=2), vocab=50280.  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    tie_embeddings=True,
)
