"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads per layer.
[arXiv:2411.13676; hf]

Per Hymba: layers 0, 15 and 31 use global attention, the rest sliding-window;
the SSM path is always global (bounded state) => long_500k applicable.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

_W = 1_024

# 32-entry pattern: global at 0, 15, 31.
_PATTERN = tuple(0 if i in (0, 15, 31) else _W for i in range(32))

CONFIG = ModelConfig(
    arch="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1_600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5_504,
    vocab=32_001,
    act="swiglu",
    attn_pattern=_PATTERN,
    local_window=_W,
    parallel_ssm=True,
    ssm=SSMConfig(state_dim=16, d_inner_mult=2, chunk=128),
    supports_long_context=True,
    remat="dots",
)
