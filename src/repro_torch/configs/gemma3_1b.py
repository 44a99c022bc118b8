"""gemma3-1b [dense] — 26L d_model=1152 4H (MQA kv=1) d_ff=6912 vocab=262144.
5:1 local(sliding-window):global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Sliding-window local layers give a sub-quadratic path; the single global
layer per period uses a sequence-sharded KV cache at long_500k.
attn_pattern: 5 windowed layers then 1 global, cyclically.
"""
from repro_torch.configs.base import ModelConfig

_W = 1_024  # sliding window

CONFIG = ModelConfig(
    arch="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1_152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6_912,
    vocab=262_144,
    act="geglu",
    attn_pattern=(_W, _W, _W, _W, _W, 0),
    local_window=_W,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
    supports_long_context=True,
    remat="dots",
)
