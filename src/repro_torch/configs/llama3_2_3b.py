"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256, tied embeddings. The same numbers as the JAX package's config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3_072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8_192,
    vocab=128_256,
    act="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    remat="dots",
)
