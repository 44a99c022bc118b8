"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000; squared-ReLU MLP. [arXiv:2402.16819; unverified]

340B dense: FSDP x TP, full remat, bf16 optimizer states are mandatory to fit
256 x 16 GiB chips.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab=256_000,
    act="relu2",
    optimizer_dtype="bfloat16",
    remat="full",
    remat_groups=12,  # 96 = 12 groups x 8 layers: two-level remat
)
