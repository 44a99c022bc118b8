"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks (7:1 ratio — one sLSTM block every 8th layer).
[arXiv:2405.04517; unverified]

Recurrent matrix-memory state => O(1) decode; long_500k applicable.
mLSTM runs in chunkwise-parallel form (sub-quadratic training/prefill).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2_048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,                      # mLSTM blocks have no separate FFN
    vocab=50_304,
    slstm_every=8,
    ssm=SSMConfig(state_dim=512, chunk=128),
    supports_long_context=True,
    remat="full",
)
