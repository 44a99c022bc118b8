"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Backbone only: the vision frontend is a STUB — ``input_specs()`` supplies
precomputed patch embeddings (B, n_vision_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab=128_256,
    act="swiglu",
    cross_attn_every=5,          # 40 self-attn layers -> 8 cross-attn layers
    n_vision_tokens=1_600,
    rope_theta=500_000.0,
    remat="full",
)
