"""Dense FFN blocks: SwiGLU / GeGLU (gated) and squared-ReLU / GELU MLPs.

Port of ``repro.models.ffn``."""
from __future__ import annotations

import torch

from repro_torch.models.common import act_fn, dense_init, is_gated


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype: torch.dtype) -> dict:
    p = {"wi": dense_init(generator, d_model, d_ff, dtype),
         "wo": dense_init(generator, d_ff, d_model, dtype)}
    if is_gated(act):
        p["wg"] = dense_init(generator, d_model, d_ff, dtype)
    return p


def ffn_forward(params, x: torch.Tensor, act: str, shard=None,
                gate_scale=None, out_scale=None) -> torch.Tensor:
    """``gate_scale`` multiplies the gate projection before its activation
    and ``out_scale`` the output (Falcon-H1's MLP multipliers)."""
    f = act_fn(act)
    h = x @ params["wi"].to(x.dtype)
    if is_gated(act):
        g = x @ params["wg"].to(x.dtype)
        if gate_scale is not None:
            g = g * gate_scale
        h = f(g) * h
    else:
        h = f(h)
    if shard is not None:
        h = shard(h)
    out = h @ params["wo"].to(x.dtype)
    return out if out_scale is None else out * out_scale
