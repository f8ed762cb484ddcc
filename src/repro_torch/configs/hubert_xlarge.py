"""hubert-xlarge — audio encoder (wav2vec2-style backbone).

48-layer bidirectional encoder, d_model=1280, 16 heads, d_ff=5120,
vocab=504 (masked-unit prediction codebook).  The convolutional waveform
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings.
[arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    activation="gelu",
    frame_dim=512,
)
