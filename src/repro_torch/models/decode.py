"""Single-token decode steps, prefill and cache construction for all
families.

Port of ``repro.models.decode``. ``decode_step`` updates the cache in place
(the new token's keys and values written at ``pos``, recurrent states
overwritten) and returns it, so callers keep one cache per batch.
``cache_struct`` describes the cache with meta tensors (shape and dtype, no
storage), the analog of the reference's ShapeDtypeStruct tree.

A Mamba-2 hybrid (Falcon-H1) also has ``prefill_ragged``: one
full-sequence pass over a batch of prompts of different lengths, padded on
the left, that writes the cache in place and leaves each row where it
would be alone; its cache carries each row's "start". ``cache_rows`` is a
view of a range of the cache's rows, so that several such passes (each at
its own ``offset``) can fill one cache.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import dtype_of, norm_apply
from repro_torch.models.transformer import (_norm_kind, _unembed, apply_block,
                                            attn_runs, embed_tokens, forward,
                                            vlm_segments, xlstm_segments)
from repro_torch.sharding.specs import merge_last, split_last


def cache_struct(cfg: ModelConfig, batch: int, seq_len: int
                 ) -> Dict[str, Any]:
    """Meta-tensor tree of the decode cache, the reference's layout:

    - ssm: mLSTM states "m_c", "m_n", "m_m" (n_seg, per - 1, B, H, ...) and
      sLSTM states "s_c", "s_n", "s_m", "s_h" (n_seg, B, H, dh), float32;
    - vlm: "k", "v" (n_seg, inner, B, S, K, hd) and the vision keys and
      values "xk", "xv" (n_seg, B, n_vision_tokens, K, hd);
    - otherwise {"runs": [...]}, one {"k", "v"} of (n, B, S, K, hd) per run
      of ``attn_runs``, with "mamba_conv" (n, B, W - 1, di) and "mamba_h"
      (n, B, di, N), float32, for hybrid runs; a Mamba-2 hybrid's are
      "mamba_conv" (n, B, W - 1, conv_dim) and "mamba_h" (n, B, heads,
      head_dim, state), float32, and its cache has "start" (B,) int64,
      each row's first real cache index (0 unless a ragged prefill wrote
      it).
    """
    dt = dtype_of(cfg.dtype)
    f32 = torch.float32
    B, S, K, hd = batch, seq_len, cfg.n_kv_heads, cfg.head_dim

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "ssm":
        n_seg, per = xlstm_segments(cfg)
        H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
        return {
            "m_c": sds((n_seg, per - 1, B, H, dh, dh), f32),
            "m_n": sds((n_seg, per - 1, B, H, dh), f32),
            "m_m": sds((n_seg, per - 1, B, H), f32),
            "s_c": sds((n_seg, B, H, dh), f32),
            "s_n": sds((n_seg, B, H, dh), f32),
            "s_m": sds((n_seg, B, H, dh), f32),
            "s_h": sds((n_seg, B, H, dh), f32),
        }
    if cfg.cross_attn_every:
        n_seg, inner = vlm_segments(cfg), cfg.cross_attn_every
        return {
            "k": sds((n_seg, inner, B, S, K, hd), dt),
            "v": sds((n_seg, inner, B, S, K, hd), dt),
            "xk": sds((n_seg, B, cfg.n_vision_tokens, K, hd), dt),
            "xv": sds((n_seg, B, cfg.n_vision_tokens, K, hd), dt),
        }
    runs = []
    m2 = cfg.mamba2
    for (n, _, _) in attn_runs(cfg):
        c = {"k": sds((n, B, S, K, hd), dt), "v": sds((n, B, S, K, hd), dt)}
        if m2 is not None:
            c["mamba_conv"] = sds((n, B, m2.conv_width - 1, m2.conv_dim), f32)
            c["mamba_h"] = sds((n, B, m2.n_heads, m2.head_dim, m2.state_dim),
                               f32)
        elif cfg.parallel_ssm:
            di = cfg.ssm.d_inner_mult * cfg.d_model
            W, N = cfg.ssm.conv_width, cfg.ssm.state_dim
            c["mamba_conv"] = sds((n, B, W - 1, di), f32)
            c["mamba_h"] = sds((n, B, di, N), f32)
        runs.append(c)
    if m2 is not None:
        return {"runs": runs, "start": sds((B,), torch.int64)}
    return {"runs": runs}


def cache_rows(cache: Dict[str, Any], r0: int, r1: int) -> Dict[str, Any]:
    """Rows ``r0 .. r1 - 1`` of a Mamba-2 hybrid's cache as views: what is
    written through them is written into ``cache``."""
    return {"runs": [{k: t[:, r0:r1] for k, t in run.items()}
                     for run in cache["runs"]],
            "start": cache["start"][r0:r1]}


def _zeros_like_meta(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _zeros_like_meta(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_meta(v, dev) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               device="cuda") -> Dict[str, Any]:
    """A zero cache on ``device``; the xLSTM stabilisers start at -1e30."""
    dev = resolve_device(device)
    z = _zeros_like_meta(cache_struct(cfg, batch, seq_len), dev)
    if cfg.family == "ssm":
        z["m_m"] -= 1e30
        z["s_m"] -= 1e30
    return z


def decode_step(params, cache, token: torch.Tensor, pos: int,
                cfg: ModelConfig, ctx=None) -> Tuple[torch.Tensor, Any]:
    """token: (B, 1) integer ids; pos: the write index into the cache.

    Returns (logits (B, 1, V), cache), the cache updated in place.
    """
    x = embed_tokens(params, cfg, token)
    if cfg.family == "ssm":
        x = _xlstm_decode(params, cache, x, cfg)
    elif cfg.cross_attn_every:
        x = _vlm_decode(params, cache, x, pos, cfg, ctx)
    else:
        start = cache.get("start")
        for run_p, run_c, (n, w, th) in zip(params["blocks"], cache["runs"],
                                            attn_runs(cfg)):
            for i, blk in enumerate(run_p):
                x, _ = apply_block(blk, x, cfg, window=w, theta=th, ctx=ctx,
                                   mode="decode", pos=pos, start=start,
                                   cache={k: t[i] for k, t in run_c.items()})
    x = norm_apply(params["norm_f"], x, _norm_kind(cfg), cfg.norm_eps)
    logits = _unembed(params, cfg, x)
    if ctx:
        logits = ctx.act_logits(logits)
    return logits, cache


def _vlm_decode(params, cache, x, pos, cfg, ctx=None):
    for s, (blks, cross) in enumerate(zip(params["blocks"], params["cross"])):
        for i, blk in enumerate(blks):
            x, _ = apply_block(blk, x, cfg, window=0, theta=cfg.rope_theta,
                               ctx=ctx, mode="decode", pos=pos,
                               cache={"k": cache["k"][s, i],
                                      "v": cache["v"][s, i]})
        h = norm_apply(cross["norm"], x, "rms", cfg.norm_eps)
        q = h @ cross["attn"]["wq"].to(h.dtype)
        B = q.shape[0]
        q = split_last(q, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                       cfg.head_dim)
        o = attn.attention_scores_decode(q, cache["xk"][s], cache["xv"][s],
                                         pos=cfg.n_vision_tokens)
        o = merge_last(o, 3)
        o = o @ cross["attn"]["wo"].to(h.dtype)
        x = x + torch.tanh(cross["gate"]).to(x.dtype) * o
    return x


def _xlstm_decode(params, cache, x, cfg):
    H = cfg.n_heads
    for s, (mblks, sblk) in enumerate(zip(params["mblocks"],
                                          params["sblocks"])):
        for i, blk in enumerate(mblks):
            st = xlstm_mod.MLSTMState(c=cache["m_c"][s, i],
                                      n=cache["m_n"][s, i],
                                      m=cache["m_m"][s, i])
            h = norm_apply(blk["norm"], x, "rms", cfg.norm_eps)
            y, st = xlstm_mod.mlstm_step(blk["m"], h, st, n_heads=H)
            x = x + y
            for name, t in zip(("m_c", "m_n", "m_m"), st):
                cache[name][s, i].copy_(t)
        st = xlstm_mod.SLSTMState(c=cache["s_c"][s], n=cache["s_n"][s],
                                  m=cache["s_m"][s], h=cache["s_h"][s])
        h = norm_apply(sblk["norm"], x, "rms", cfg.norm_eps)
        y, st = xlstm_mod.slstm_step(sblk["s"], h, st, n_heads=H)
        x = x + y
        for name, t in zip(("s_c", "s_n", "s_m", "s_h"), st):
            cache[name][s].copy_(t)
    return x


def prefill(params, batch, cfg: ModelConfig, ctx=None):
    """Full-sequence prefill. Returns (last-token logits (B, 1, V), the
    prompt's cache as ``forward`` collects it), or (logits, None) for an
    encoder-only arch."""
    h, caches = forward(params, batch, cfg, ctx, mode="prefill")
    logits = _unembed(params, cfg, h[:, -1:])
    if ctx:
        logits = ctx.act_logits(logits)
    if cfg.encoder_only:
        return logits, None
    return logits, caches


def prefill_ragged(params, cache, tokens: torch.Tensor, start: torch.Tensor,
                   cfg: ModelConfig, offset: int = 0
                   ) -> Tuple[torch.Tensor, Any]:
    """One full-sequence pass over a ragged batch of a Mamba-2 hybrid.

    tokens: (B, T) integer ids, each row's prompt at its right end and
    padding (any id) on its left; start: (B,) int64, the index of each
    row's first real token. Writes into ``cache`` (``init_cache``, or
    ``cache_rows`` of one, with at least ``offset`` + T positions) the keys
    and values at indices ``offset`` .. ``offset`` + T - 1, the conv and
    SSM states after the last, and ``start`` + ``offset``; decoding then
    goes on at ``pos`` = ``offset`` + T for every row. Returns (the logits
    at index T - 1 (B, 1, V), cache). Each row's logits and cache entries
    are those of the row prefilled alone (its padding masked, its
    positions counted from ``start``), wherever ``offset`` puts it."""
    if cfg.mamba2 is None:
        raise ValueError(f"{cfg.arch}: no ragged prefill (a Mamba-2 hybrid "
                         f"only)")
    T = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    cache["start"].copy_(start + offset)
    for run_p, run_c, (n, w, th) in zip(params["blocks"], cache["runs"],
                                        attn_runs(cfg)):
        for i, blk in enumerate(run_p):
            x, c = apply_block(blk, x, cfg, window=w, theta=th,
                               mode="prefill", start=start)
            run_c["k"][i, :, offset:offset + T] = c["k"]
            run_c["v"][i, :, offset:offset + T] = c["v"]
            run_c["mamba_conv"][i] = c["mamba_conv"]
            run_c["mamba_h"][i] = c["mamba_h"]
    x = norm_apply(params["norm_f"], x[:, -1:], "rms", cfg.norm_eps)
    return _unembed(params, cfg, x), cache
