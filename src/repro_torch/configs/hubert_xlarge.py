"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504.
Encoder-only (same backbone as wav2vec2). [arXiv:2106.07447; unverified]

The conv waveform frontend is a STUB — ``input_specs()`` supplies precomputed
frame embeddings (B, T, d_model). vocab=504 is the masked-prediction codebook.
Encoder-only: decode shape cells are skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1_280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5_120,
    vocab=504,
    act="gelu",
    encoder_only=True,
    embedding_inputs=True,
    remat="dots",
)
