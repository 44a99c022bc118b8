"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

128 experts over the 16-way model axis: 8 experts/device ("ep" mode).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4_096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1_536,
    vocab=151_936,
    act="swiglu",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1_536,
                  capacity_factor=1.25, parallel_mode="ep"),
    optimizer_dtype="bfloat16",
    remat="full",
)
