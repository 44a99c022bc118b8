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


def ffn_forward(params, x: torch.Tensor, act: str, shard=None
                ) -> torch.Tensor:
    f = act_fn(act)
    h = x @ params["wi"].to(x.dtype)
    if is_gated(act):
        h = f(x @ params["wg"].to(x.dtype)) * h
    else:
        h = f(h)
    if shard is not None:
        h = shard(h)
    return h @ params["wo"].to(x.dtype)
