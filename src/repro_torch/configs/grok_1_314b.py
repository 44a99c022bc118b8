"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]

8 experts < 16-way model axis: expert d_ff is tensor-parallel ("tp" mode).
314B params / ~86B active.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6_144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab=131_072,
    act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32_768,
                  capacity_factor=1.25, parallel_mode="tp"),
    optimizer_dtype="bfloat16",  # 314B: fp32 m/v would not fit 256 chips
    remat="full",
)
