"""qwen1.5-4b — dense decoder with QKV bias.

40 layers, d_model=2560, 20 heads (kv=20), d_ff=6912, vocab=151936.
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    activation="swiglu",
)
