"""Work of Falcon-H1's route scoring, counted from the configuration's
published keys (``bench/configs/<config>.json``), not from the program.

FLOPs (two a multiply-add) of the matrix products a real token needs, a
layer: the attention projections and its scores (QK^T and PV over the
keys the token sees), the Mamba-2 in- and out-projections and the SSD's
products (in prefill, a row's own chunks of ``mamba_chunk_size``: C B^T
and the masked product with x over the whole chunk square, the chunk
state and the state's contribution to the output; in decode, the state's
outer-product update and its contraction with C), and the MLP; then the
head at each position whose logits are taken (the last of each prompt,
every decode step). Padding is not counted.

Bytes a decode step must move: the stage's weights and the head once
(bf16; ``dt_bias``, ``A_log`` and ``D`` float32), the embedding rows of
the step's tokens, each real row's conv and SSM state read and written
(float32), its keys and values up to the new position read and the new
ones written (bf16), and the logits written (bf16).
"""
from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM5 80GB, dense BF16 tensor-core rate (data sheet, without
# sparsity)
PEAK_BF16_FLOPS = 989.4e12


def _dims(c: dict) -> dict:
    D, H, K, hd = (c["hidden_size"], c["num_attention_heads"],
                   c["num_key_value_heads"], c["head_dim"])
    mh, mp, g, n = (c["mamba_n_heads"], c["mamba_d_head"],
                    c["mamba_n_groups"], c["mamba_d_state"])
    d_ssm = mh * mp
    conv = d_ssm + 2 * g * n
    return dict(D=D, H=H, K=K, hd=hd, mh=mh, mp=mp, g=g, n=n, d_ssm=d_ssm,
                conv=conv, in_dim=d_ssm + conv + mh,
                F=c["intermediate_size"], V=c["vocab_size"],
                L=c["num_hidden_layers"], W=c["mamba_d_conv"],
                Q=c["mamba_chunk_size"])


def _token_flops(d: dict) -> int:
    """A token's projections and MLP, one layer (no scores, no SSD)."""
    D = d["D"]
    attn = 2 * D * (d["H"] + 2 * d["K"]) * d["hd"] + 2 * d["H"] * d["hd"] * D
    mixer = 2 * D * d["in_dim"] + 2 * d["d_ssm"] * D
    return attn + mixer + 6 * D * d["F"]


def prefill_flops(c: dict, lens: Sequence[int]) -> int:
    """FLOPs of prefilling prompts of ``lens`` tokens, each row as alone,
    with the logits of each prompt's last position."""
    d = _dims(c)
    total = 0
    for n in lens:
        per = _token_flops(d) * n
        per += 4 * d["H"] * d["hd"] * n * (n + 1) // 2         # scores
        ssd = 0
        for s in range(0, n, d["Q"]):
            q = min(d["Q"], n - s)
            ssd += 2 * q * q * d["g"] * d["n"]                  # C B^T
            ssd += 2 * q * q * d["mh"] * d["mp"]                # masked . x
            ssd += 4 * q * d["mh"] * d["mp"] * d["n"]           # states, out
        total += d["L"] * (per + ssd) + 2 * d["D"] * d["V"]
    return total


def decode_flops(c: dict, lens: Sequence[int], step: int) -> int:
    """FLOPs of decode step ``step`` (0: the first after the prefill) for
    rows whose prompts had ``lens`` tokens."""
    d = _dims(c)
    total = 0
    for n in lens:
        keys = n + step + 1
        per = _token_flops(d) + 4 * d["H"] * d["hd"] * keys \
            + 4 * d["mh"] * d["mp"] * d["n"]
        total += d["L"] * per + 2 * d["D"] * d["V"]
    return total


def weight_bytes(c: dict) -> int:
    """The stage's blocks, final norm and head, as served."""
    d = _dims(c)
    D = d["D"]
    attn = D * (d["H"] + 2 * d["K"]) * d["hd"] + d["H"] * d["hd"] * D
    mixer = (D * d["in_dim"] + d["conv"] * (d["W"] + 1) + d["d_ssm"]
             + d["d_ssm"] * D)
    block = 2 * (attn + mixer + 3 * D * d["F"] + 2 * D) + 4 * 3 * d["mh"]
    return d["L"] * block + 2 * (D + d["V"] * D)


def decode_bytes(c: dict, lens: Sequence[int], step: int) -> int:
    """Bytes decode step ``step`` must move for rows whose prompts had
    ``lens`` tokens."""
    d = _dims(c)
    rows = len(lens)
    state = 4 * ((d["W"] - 1) * d["conv"] + d["mh"] * d["mp"] * d["n"])
    kv_pos = 2 * 2 * d["K"] * d["hd"]          # one position's k and v
    kv = sum(kv_pos * (n + step) for n in lens) + rows * kv_pos
    return (weight_bytes(c) + 2 * rows * d["D"]
            + d["L"] * (2 * rows * state + kv) + 2 * rows * d["V"])
