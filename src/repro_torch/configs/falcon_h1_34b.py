"""falcon-h1-34b [hybrid] — 72L d_model=5120, GQA attention 20H (kv=4,
head 128) beside a Mamba-2 mixer (32 heads x 128, d_state 256, 2 groups)
in every block, SwiGLU d_ff=21504, vocab=261120 untied, muP multipliers.
[https://huggingface.co/tiiuae/Falcon-H1-34B-Instruct/blob/main/config.json]

``PUBLISHED`` holds the numbers of that ``config.json``; ``from_hf`` maps
such a dict (the published one, or a cut of it such as the benchmark's
``bench/configs/falcon-h1-34b-pp2.json``) onto the port's config.
"""
from repro_torch.configs.base import (Mamba2Config, Mamba2HybridConfig,
                                      MuPMultipliers)

PUBLISHED = {
    "attention_bias": False, "attention_in_multiplier": 1,
    "attention_out_multiplier": 0.0375, "attn_layer_indices": None,
    "embedding_multiplier": 5.656854249492381, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 5120, "intermediate_size": 21504,
    "key_multiplier": 0.011048543456039804,
    "lm_head_multiplier": 0.0078125, "mamba_chunk_size": 128,
    "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_head": 128,
    "mamba_d_ssm": 4096, "mamba_d_state": 256, "mamba_expand": 2,
    "mamba_n_groups": 2, "mamba_n_heads": 32,
    "mamba_norm_before_gate": False, "mamba_proj_bias": False,
    "mamba_rms_norm": True, "mamba_use_mlp": True,
    "max_position_embeddings": 262144, "mlp_bias": False,
    "mlp_expansion_factor": 8,
    "mlp_multipliers": [0.1767766952966369, 0.011160714285714284],
    "model_type": "falcon_h1", "num_attention_heads": 20,
    "num_hidden_layers": 72, "num_key_value_heads": 4,
    "num_logits_to_keep": 1, "projectors_bias": False,
    "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 100000000000, "ssm_in_multiplier": 0.25,
    "ssm_multipliers": [0.3535533905932738, 0.25, 0.1767766952966369, 0.5,
                        0.3535533905932738],
    "ssm_out_multiplier": 0.08838834764831845,
    "tie_word_embeddings": False, "vocab_size": 261120,
}


def from_hf(hf: dict, *, arch: str = "falcon-h1-34b"
            ) -> Mamba2HybridConfig:
    """The port's config from a Falcon-H1 ``config.json`` dict. Raises
    where the dict asks for a variant the port does not carry (biases on
    the projections, no conv bias, no gated norm or one that gates after
    the norm, attention on some layers only, RoPE scaling, no MLP)."""
    unsupported = {"attention_bias": False, "mlp_bias": False,
                   "mamba_proj_bias": False, "projectors_bias": False,
                   "mamba_rms_norm": True, "mamba_conv_bias": True,
                   "mamba_norm_before_gate": False,
                   "attn_layer_indices": None, "rope_scaling": None,
                   "hidden_act": "silu", "mamba_use_mlp": True}
    for k, want in unsupported.items():
        if hf.get(k, want) != want:
            raise ValueError(f"{arch}: {k}={hf[k]!r} is not supported")
    heads, d_head = hf["mamba_n_heads"], hf["mamba_d_head"]
    if hf["mamba_d_ssm"] != heads * d_head:
        raise ValueError(f"{arch}: mamba_d_ssm {hf['mamba_d_ssm']} is not "
                         f"{heads} heads x {d_head}")
    gate, down = hf["mlp_multipliers"]
    return Mamba2HybridConfig(
        arch=arch,
        family="hybrid",
        n_layers=hf["num_hidden_layers"],
        d_model=hf["hidden_size"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_key_value_heads"],
        head_dim=hf["head_dim"],
        d_ff=hf["intermediate_size"],
        vocab=hf["vocab_size"],
        act="swiglu",
        rope_theta=float(hf["rope_theta"]),
        norm_eps=hf["rms_norm_eps"],
        tie_embeddings=hf["tie_word_embeddings"],
        parallel_ssm=True,
        supports_long_context=True,
        remat="dots",
        mamba2=Mamba2Config(
            n_heads=heads, head_dim=d_head, n_groups=hf["mamba_n_groups"],
            state_dim=hf["mamba_d_state"], conv_width=hf["mamba_d_conv"],
            chunk=hf["mamba_chunk_size"]),
        mup=MuPMultipliers(
            embedding=hf["embedding_multiplier"],
            lm_head=hf["lm_head_multiplier"],
            attn_in=hf["attention_in_multiplier"],
            attn_out=hf["attention_out_multiplier"],
            key=hf["key_multiplier"],
            ssm_in=hf["ssm_in_multiplier"],
            ssm_out=hf["ssm_out_multiplier"],
            ssm_zxbcdt=tuple(hf["ssm_multipliers"]),
            mlp_gate=gate, mlp_down=down),
    )


CONFIG = from_hf(PUBLISHED)
