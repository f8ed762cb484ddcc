"""gemma-7b — dense decoder, GeGLU, head_dim=256.

28 layers, d_model=3072, 16 heads (kv=16), d_ff=24576, vocab=256000.
[arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    activation="geglu",
    tie_embeddings=True,
)
