"""minitron-8b — width-pruned Nemotron-4 dense decoder.

32 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
[arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    activation="swiglu",
)
