"""Dense transformer: block init / apply, parameter init, forward, logits.

Port of ``repro.models.transformer`` for the dense family. The reference
stacks each run of layers with equal (window, rope_theta) along a leading
axis and scans over it; the port keeps the runs (``attn_runs``) and holds
each run as a list of per-layer parameter dicts, applied in a Python loop.

The other families (MoE, SSM / xLSTM, hybrid, VLM cross-attention,
embedding inputs) are ROADMAP.md queue 1, item 9; the training loss and
rematerialisation wait for the training slice (item 10).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (dtype_of, embed_init, norm_apply,
                                       norm_init)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families the port does not carry yet."""
    if (cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None
            or cfg.parallel_ssm or cfg.slstm_every or cfg.cross_attn_every
            or cfg.embedding_inputs or cfg.encoder_only):
        raise NotImplementedError(
            f"{cfg.arch} ({cfg.family}) is not ported yet: the port carries "
            "the dense decoder family; the others are ROADMAP.md queue 1, "
            "item 9")


def _norm_kind(cfg: ModelConfig) -> str:
    return "ln" if cfg.family == "audio" else "rms"


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One transformer block (self-attn + ffn) on the generator's device."""
    dt = dtype_of(cfg.param_dtype)
    nk = _norm_kind(cfg)
    dev = generator.device
    p = {"norm1": norm_init(cfg.d_model, nk, dt, dev),
         "attn": attn.init_attn(generator, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, dt),
         "norm2": norm_init(cfg.d_model, nk, dt, dev)}
    if cfg.d_ff:
        p["ffn"] = ffn_mod.init_ffn(generator, cfg.d_model, cfg.d_ff,
                                    cfg.act, dt)
    return p


def attn_runs(cfg: ModelConfig):
    """Group consecutive layers with equal (window, rope_theta) into runs.

    Returns a list of (length, window, theta).
    """
    tg = cfg.rope_theta_global or cfg.rope_theta
    runs: List[list] = []
    for i in range(cfg.n_layers):
        w = cfg.window_for_layer(i)
        th = tg if w == 0 else cfg.rope_theta
        if runs and runs[-1][1] == w and runs[-1][2] == th:
            runs[-1][0] += 1
        else:
            runs.append([1, w, th])
    return [tuple(r) for r in runs]


def apply_block(p, x: torch.Tensor, cfg: ModelConfig, *, window: int,
                theta, positions=None, mode: str = "train",
                cache: Optional[dict] = None, pos: Optional[int] = None):
    """One block. mode: train | prefill (full sequence) or decode (one
    token, writing the cache in place at ``pos``).

    Returns (x, cache entry) where the entry is None in train mode.
    """
    nk, eps = _norm_kind(cfg), cfg.norm_eps
    h = norm_apply(p["norm1"], x, nk, eps)
    new_cache = None
    if mode in ("train", "prefill"):
        a_out, (k, v) = attn.attn_forward(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=theta, positions=positions,
            causal=not cfg.encoder_only, window=window)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    else:
        a_out, ck, cv = attn.attn_decode(
            p["attn"], h, cache["k"], cache["v"], pos=pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=theta, window=window)
        new_cache = {"k": ck, "v": cv}
    x = x + a_out
    if cfg.d_ff:
        x = x + ffn_mod.ffn_forward(p["ffn"],
                                    norm_apply(p["norm2"], x, nk, eps),
                                    cfg.act)
    return x, new_cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Parameters on the generator's device, one tensor at a time (each
    drawn in float32, then cast to ``cfg.param_dtype``)."""
    dt = dtype_of(cfg.param_dtype)
    p: Params = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(generator, cfg.vocab, cfg.d_model, dt)
    p["norm_f"] = norm_init(cfg.d_model, _norm_kind(cfg), dt,
                            generator.device)
    p["blocks"] = [[init_block(generator, cfg) for _ in range(n)]
                   for (n, _, _) in attn_runs(cfg)]
    return p


def _embed_in(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    return params["embed"][batch["tokens"]].to(dtype_of(cfg.dtype))


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor
             ) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return x @ w.to(x.dtype).T


def forward(params: Params, batch, cfg: ModelConfig, mode: str = "train"):
    """Full-sequence forward. Returns (h_final, aux): the pre-unembed hidden
    state, and in prefill mode one {"k", "v"} cache per run, each stacked
    to (n, B, S, K, hd)."""
    x = _embed_in(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    collect = mode == "prefill"
    aux = []
    for run_p, (n, w, th) in zip(params["blocks"], attn_runs(cfg)):
        ks, vs = [], []
        for blk in run_p:
            x, c = apply_block(blk, x, cfg, window=w, theta=th,
                               positions=positions,
                               mode="prefill" if collect else "train")
            if collect:
                ks.append(c["k"])
                vs.append(c["v"])
        if collect:
            aux.append({"k": torch.stack(ks), "v": torch.stack(vs)})
    x = norm_apply(params["norm_f"], x, _norm_kind(cfg), cfg.norm_eps)
    return x, (aux if collect else None)


def logits_fn(params: Params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Full logits (B, S, V) (for tests / small-scale evaluation)."""
    h, _ = forward(params, batch, cfg, mode="train")
    return _unembed(params, cfg, h)
