"""Shared building blocks: norms, RoPE, initialisers, dtype policy.

Port of ``repro.models.common``. Weights keep the JAX package's layout,
``(d_in, d_out)``, so a projection is ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _trunc_normal(shape, generator: torch.Generator, scale: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """Truncated normal at +-2 sigma in float32 on the generator's device,
    scaled, then cast."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init, ``(d_in, d_out)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    return _trunc_normal((d_in, d_out), generator, scale, dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return _trunc_normal((vocab, d), generator, 0.02, dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def norm_apply(params, x: torch.Tensor, kind: str, eps: float
               ) -> torch.Tensor:
    if kind == "ln":
        return layer_norm(x, params["w"], params["b"], eps)
    return rms_norm(x, params["w"], eps)


def norm_init(d: int, kind: str, dtype: torch.dtype, device) -> dict:
    if kind == "ln":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    # rms: stored as an offset from 1, applied as (1 + w)
    return {"w": torch.zeros((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-halves rotation, angles in float32.

    x: (B, S, K, G, d) or (B, S, K, d); positions: (S,) or (B, S),
    broadcastable to x's S dim.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (d/2,)
    angles = positions.float()[..., None] * freqs             # (..., S, d/2)
    # broadcast angles over the head dims between S and d
    for _ in range(x.dim() + positions.dim() - 2 - angles.dim()):
        angles = angles[..., None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def act_fn(name: str):
    if name == "swiglu":
        return F.silu
    if name in ("geglu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: F.relu(x).square()
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Stable cross entropy in float32, the mean over the positions whose
    label is not ``ignore_id``. A negative label indexes from the end, as
    ``jnp.take_along_axis`` does; its position is masked out all the same
    when it is ``ignore_id``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    idx = labels.long() % logits.shape[-1]
    ll = torch.gather(logits, -1, idx[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
