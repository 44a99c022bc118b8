"""Single-token decode steps, prefill and KV-cache construction.

Port of ``repro.models.decode`` for the dense family. ``decode_step`` writes
the new token's keys and values into the cache in place and returns it, so
callers keep one cache per batch. ``cache_struct`` describes the cache with
meta tensors (shape and dtype, no storage), the analog of the reference's
ShapeDtypeStruct tree.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import dtype_of, norm_apply
from repro_torch.models.transformer import (_norm_kind, _unembed, apply_block,
                                            attn_runs, forward)


def cache_struct(cfg: ModelConfig, batch: int, seq_len: int
                 ) -> Dict[str, Any]:
    """Meta-tensor tree of the decode cache: one {"k", "v"} of shape
    (n, B, S, K, hd) in ``cfg.dtype`` per run of ``attn_runs``."""
    dt = dtype_of(cfg.dtype)
    shape = (batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"runs": [{name: torch.empty((n,) + shape, dtype=dt,
                                        device="meta")
                      for name in ("k", "v")}
                     for (n, _, _) in attn_runs(cfg)]}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    st = cache_struct(cfg, batch, seq_len)
    return {"runs": [{name: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                      for name, t in run.items()} for run in st["runs"]]}


def decode_step(params, cache, token: torch.Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """token: (B, 1) integer ids; pos: the write index into the cache.

    Returns (logits (B, 1, V), cache), the cache updated in place.
    """
    x = params["embed"][token].to(dtype_of(cfg.dtype))
    for run_p, run_c, (n, w, th) in zip(params["blocks"], cache["runs"],
                                        attn_runs(cfg)):
        for i, blk in enumerate(run_p):
            x, _ = apply_block(blk, x, cfg, window=w, theta=th,
                               mode="decode", pos=pos,
                               cache={"k": run_c["k"][i],
                                      "v": run_c["v"][i]})
    x = norm_apply(params["norm_f"], x, _norm_kind(cfg), cfg.norm_eps)
    return _unembed(params, cfg, x), cache


def prefill(params, batch, cfg: ModelConfig):
    """Full-sequence prefill. Returns (last-token logits (B, 1, V), the
    per-run caches of the prompt)."""
    h, caches = forward(params, batch, cfg, mode="prefill")
    return _unembed(params, cfg, h[:, -1:]), caches
