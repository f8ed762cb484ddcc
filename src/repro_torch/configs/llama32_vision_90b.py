"""llama-3.2-vision-90b — VLM decoder with cross-attention image layers.

100 decoder layers, d_model=8192, 64 heads (GQA kv=8), d_ff=28672,
vocab=128256; a cross-attention block to precomputed image-patch embeddings
is inserted every 10th layer (10 cross blocks total).  The vision tower is a
STUB: ``input_specs()`` provides patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=10,
    n_image_tokens=1601,
    rope_theta=500_000.0,
    activation="swiglu",
)
