"""gemma3-27b — dense decoder with 5:1 local:global attention, 128k context.

62 layers, d_model=5376, 32 heads (GQA kv=16), d_ff=21504, vocab=262144.
Pattern: 5 sliding-window (1024) layers followed by 1 global layer.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    sliding_window=1024,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
    activation="geglu",
    tie_embeddings=True,
)
