"""Unified model: dense / MoE / SSM (xLSTM) / hybrid (hymba) / VLM / audio.

Port of ``repro.models.transformer``. The reference stacks layers along
leading axes and scans over them; the port holds the same stacks as nested
lists of per-layer parameter dicts, in layer order, applied in Python loops:

- uniform attention archs (dense, MoE, hybrid, audio): ``blocks`` is one
  list per run of equal (window, rope_theta) (``attn_runs``), each a list
  of that run's layers; a Mamba-2 hybrid (Falcon-H1) is one run, each
  block with "attn", "mamba2" (``models/mamba2.py``) and "ffn" side by
  side, its branches summed with their muP multipliers;
- vlm: ``blocks`` is one list per segment of ``cross_attn_every``
  self-attention layers, and ``cross`` one cross-attention block per
  segment, applied after the segment's layers;
- ssm (xLSTM): ``mblocks`` is one list per segment of ``slstm_every - 1``
  mLSTM blocks, and ``sblocks`` one sLSTM block per segment, after them.

``ctx`` (a ``sharding.specs.ShardCtx``) threads the reference's sharding
constraints through on DTensors: ``act_btd`` after each residual add,
``act_ff`` on the FFN's hidden, ``act_kv`` on attention's q, k, v in the
layout ``ctx.attn_layout`` picks, ``act_logits`` on the unembed, the MoE
layers' ``moe_forward`` over the mesh, and the sLSTM's local-gradient form
where ``ctx.slstm_local_grad``. Without a context the MoE layers run the
reference's unsharded path, ``moe_ref``.

Training: ``loss_fn`` is the reference's sequence-chunked cross entropy,
each chunk's unembed under a checkpoint so that autograd keeps no chunk's
float32 ``(B, chunk, vocab)`` logits. ``cfg.remat`` maps the reference's
``jax.checkpoint`` policies onto ``torch.utils.checkpoint`` layer by layer
(``_remat``), with the reference's two-level form where
``cfg.remat_groups`` is set. Rematerialisation applies only where autograd
records (``torch.is_grad_enabled()``); it changes no value.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba2 as mamba2_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       norm_apply, norm_init)
from repro_torch.sharding.specs import psum

Params = Dict[str, Any]


def _norm_kind(cfg: ModelConfig) -> str:
    return "ln" if cfg.family == "audio" else "rms"


# the weight products: unbatched matrix products, as
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves them
# (batched products, ``bmm``, are recomputed)
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn: Callable, **kw) -> Callable:
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``cfg.remat``: "none" keeps every activation, "full"
    recomputes the whole of ``fn`` in the backward pass, "dots" saves the
    outputs of its weight products and recomputes the rest."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        return _checkpointed(fn, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    if cfg.remat == "full":
        return _checkpointed(fn)
    raise ValueError(f"unknown remat {cfg.remat!r}; use none, full or dots")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One transformer block (self-attn [+ssm] + ffn/moe) on the
    generator's device."""
    dt = dtype_of(cfg.param_dtype)
    nk = _norm_kind(cfg)
    dev = generator.device
    if cfg.mamba2 is not None:
        return _init_mamba2_block(generator, cfg, dt, dev)
    p = {"norm1": norm_init(cfg.d_model, nk, dt, dev),
         "attn": attn.init_attn(generator, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.head_dim, dt)}
    if cfg.parallel_ssm:
        p["mamba"] = ssm_mod.init_mamba(generator, cfg.d_model, cfg.ssm, dt)
        p["norm_attn_o"] = norm_init(cfg.d_model, nk, dt, dev)
        p["norm_ssm_o"] = norm_init(cfg.d_model, nk, dt, dev)
    p["norm2"] = norm_init(cfg.d_model, nk, dt, dev)
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(generator, cfg.d_model, cfg.moe,
                                    cfg.act, dt)
    elif cfg.d_ff:
        p["ffn"] = ffn_mod.init_ffn(generator, cfg.d_model, cfg.d_ff,
                                    cfg.act, dt)
    return p


def _init_mamba2_block(generator: torch.Generator, cfg: ModelConfig, dt,
                       dev) -> dict:
    """A Falcon-H1 block. Each weight that a muP multiplier scales is
    drawn at its fan-in scale over that multiplier (the keys over
    ``key``, the branches' outputs over ``attn_out``, ``ssm_out`` and
    ``mlp_down``, the gate over ``mlp_gate``), so that random weights give
    attention scores and branch outputs of unit scale, as a trained
    model's do."""
    D, mup = cfg.d_model, cfg.mup
    r = 1.0 / math.sqrt(D * mup.attn_in)
    attn_p = {
        "wq": dense_init(generator, D, cfg.q_dim, dt, scale=r),
        "wk": dense_init(generator, D, cfg.kv_dim, dt, scale=r / mup.key),
        "wv": dense_init(generator, D, cfg.kv_dim, dt, scale=r),
        "wo": dense_init(generator, cfg.q_dim, D, dt, scale=1.0 / (
            math.sqrt(cfg.q_dim) * mup.attn_out)),
    }
    return {
        "norm1": norm_init(D, "rms", dt, dev),
        "attn": attn_p,
        "mamba2": mamba2_mod.init_mamba2(generator, D, cfg.mamba2, mup, dt),
        "norm2": norm_init(D, "rms", dt, dev),
        "ffn": {"wi": dense_init(generator, D, cfg.d_ff, dt),
                "wg": dense_init(generator, D, cfg.d_ff, dt, scale=1.0 / (
                    math.sqrt(D) * mup.mlp_gate)),
                "wo": dense_init(generator, cfg.d_ff, D, dt, scale=1.0 / (
                    math.sqrt(cfg.d_ff) * mup.mlp_down))},
    }


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
                theta, ctx=None, positions=None, mode: str = "train",
                cache: Optional[dict] = None, pos=None,
                start: Optional[torch.Tensor] = None):
    """One block. mode: train | prefill (full sequence) or decode (one
    token at ``pos``, the cache entry updated in place: keys and values
    written at ``pos``, the Mamba state overwritten). ``pos`` is an int,
    or a 0-d int64 tensor on the cache's device.

    ``start`` (B,), a Mamba-2 hybrid's ragged batch only: the index of
    each row's first real token, its left padding masked (see
    :func:`apply_mamba2_block`).

    Returns (x, cache entry) where the entry is None in train mode.
    """
    if cfg.mamba2 is not None:
        return apply_mamba2_block(p, x, cfg, theta=theta,
                                  positions=positions, mode=mode,
                                  cache=cache, pos=pos, start=start)
    nk, eps = _norm_kind(cfg), cfg.norm_eps
    h = norm_apply(p["norm1"], x, nk, eps)
    shard = ctx.act_kv if ctx else None
    layout = ctx.attn_layout(cfg.n_heads, cfg.n_kv_heads) if ctx \
        else "grouped"
    new_cache: Dict[str, torch.Tensor] = {}
    if mode in ("train", "prefill"):
        a_out, (k, v) = attn.attn_forward(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=theta, positions=positions,
            causal=not cfg.encoder_only, window=window, shard=shard,
            layout=layout, shard_qblocks=ctx.act_qblocks if ctx else None)
        if mode == "prefill":
            new_cache["k"], new_cache["v"] = k, v
    else:
        a_out, ck, cv = attn.attn_decode(
            p["attn"], h, cache["k"], cache["v"], pos=pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=theta, window=window,
            shard=shard)
        new_cache["k"], new_cache["v"] = ck, cv

    if cfg.parallel_ssm:
        if mode == "decode":
            st = ssm_mod.MambaState(conv=cache["mamba_conv"],
                                    h=cache["mamba_h"])
            s_out, st = ssm_mod.mamba_step(p["mamba"], h, st, cfg=cfg.ssm)
            cache["mamba_conv"].copy_(st.conv)
            cache["mamba_h"].copy_(st.h)
            new_cache["mamba_conv"] = cache["mamba_conv"]
            new_cache["mamba_h"] = cache["mamba_h"]
        elif mode == "prefill":
            s_out, st = ssm_mod_forward_with_state(p["mamba"], h, cfg)
            new_cache["mamba_conv"], new_cache["mamba_h"] = st.conv, st.h
        else:
            s_out = ssm_mod.mamba_forward(p["mamba"], h, cfg=cfg.ssm)
        a_out = 0.5 * (norm_apply(p["norm_attn_o"], a_out, nk, eps)
                       + norm_apply(p["norm_ssm_o"], s_out, nk, eps))
    x = x + a_out
    if ctx:
        x = ctx.act_btd(x)

    if cfg.moe is not None:
        h2 = norm_apply(p["norm2"], x, nk, eps)
        x = x + (moe_mod.moe_forward(
            p["moe"], h2, cfg=cfg.moe, act=cfg.act, mesh=ctx.mesh,
            batch_axes=ctx.batch_axes, fsdp_axis=ctx.fsdp_axis or "data",
            weight_stationary=ctx.moe_weight_stationary) if ctx else
            moe_mod.moe_ref(p["moe"], h2, cfg=cfg.moe, act=cfg.act))
    elif cfg.d_ff:
        x = x + ffn_mod.ffn_forward(p["ffn"],
                                    norm_apply(p["norm2"], x, nk, eps),
                                    cfg.act, shard=ctx.act_ff if ctx else None)
    if ctx:
        x = ctx.act_btd(x)
    return x, (new_cache or None)


def apply_mamba2_block(p, x: torch.Tensor, cfg: ModelConfig, *, theta,
                       positions=None, mode: str = "train",
                       cache: Optional[dict] = None, pos=None,
                       start: Optional[torch.Tensor] = None):
    """A Falcon-H1 block: one RMS norm, then GQA attention (keys times
    ``mup.key``) and the Mamba-2 mixer on the same normed input, their
    outputs times ``attn_out`` and ``ssm_out`` summed into the residual;
    then an RMS norm and the SwiGLU MLP with its gate and down multipliers.

    Ragged batches are padded on the left: with ``start`` (B,), row b's
    tokens sit at indices ``start[b]`` .. end, its RoPE positions count
    from there, attention masks the keys before it, and the mixer zeroes
    the pad positions' inputs and step sizes, so that every row computes
    what it would alone. In decode mode ``pos`` is the cache index
    written, the same for every row (an int, or a 0-d int64 tensor). Cache entry: "k", "v" (B, S, K, hd),
    "mamba_conv" (B, W - 1, conv_dim), "mamba_h" (B, H, P, N)."""
    mup, eps, m = cfg.mup, cfg.norm_eps, cfg.mamba2
    h = norm_apply(p["norm1"], x, "rms", eps)
    new_cache: Dict[str, torch.Tensor] = {}
    if mode == "decode":
        rope_pos = None if start is None else (pos - start)[:, None]
        a_out, ck, cv = attn.attn_decode(
            p["attn"], h * mup.attn_in, cache["k"], cache["v"], pos=pos,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=theta, key_scale=mup.key,
            kv_start=start, rope_pos=rope_pos)
        s_out = mamba2_mod.mamba2_step(p["mamba2"], h, cache["mamba_conv"],
                                       cache["mamba_h"], m, mup, eps=eps)
        new_cache = {"k": ck, "v": cv, "mamba_conv": cache["mamba_conv"],
                     "mamba_h": cache["mamba_h"]}
    else:
        valid = None
        if start is not None:
            idx = torch.arange(x.shape[1], device=x.device)
            valid = idx[None] >= start[:, None]
            positions = (idx[None] - start[:, None]).clamp(min=0)
        a_out, (k, v) = attn.attn_forward(
            p["attn"], h * mup.attn_in, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=theta, positions=positions, causal=True,
            key_scale=mup.key, kv_start=start)
        s_out, conv, state = mamba2_mod.mamba2_forward(
            p["mamba2"], h, m, mup, eps=eps, valid=valid)
        if mode == "prefill":
            new_cache = {"k": k, "v": v, "mamba_conv": conv,
                         "mamba_h": state}
    x = x + (a_out * mup.attn_out + s_out * mup.ssm_out)
    x = x + ffn_mod.ffn_forward(p["ffn"], norm_apply(p["norm2"], x, "rms",
                                                     eps),
                                cfg.act, gate_scale=mup.mlp_gate,
                                out_scale=mup.mlp_down)
    return x, (new_cache or None)


def ssm_mod_forward_with_state(params, x: torch.Tensor, cfg: ModelConfig):
    """mamba_forward and the exact final state (for prefill)."""
    return (ssm_mod.mamba_forward(params, x, cfg=cfg.ssm),
            ssm_mod.mamba_prefill_state(params, x, cfg=cfg.ssm))


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------


def init_xlstm_mblock(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg.param_dtype)
    return {"norm": norm_init(cfg.d_model, "rms", dt, generator.device),
            "m": xlstm_mod.init_mlstm(generator, cfg.d_model, cfg.n_heads,
                                      dt)}


def init_xlstm_sblock(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dt = dtype_of(cfg.param_dtype)
    return {"norm": norm_init(cfg.d_model, "rms", dt, generator.device),
            "s": xlstm_mod.init_slstm(generator, cfg.d_model, cfg.n_heads,
                                      dt)}


def xlstm_segments(cfg: ModelConfig):
    """(n_seg, per): segments of per - 1 mLSTM blocks and one sLSTM."""
    per = cfg.slstm_every or (cfg.n_layers + 1)
    n_seg, rem = divmod(cfg.n_layers, per)
    if rem:
        raise ValueError(f"{cfg.arch}: {cfg.n_layers} layers do not divide "
                         f"into segments of {per}")
    return n_seg, per


def vlm_segments(cfg: ModelConfig) -> int:
    """Segments of ``cross_attn_every`` self-attention layers."""
    n_seg, rem = divmod(cfg.n_layers, cfg.cross_attn_every)
    if rem:
        raise ValueError(f"{cfg.arch}: {cfg.n_layers} layers do not divide "
                         f"into segments of {cfg.cross_attn_every}")
    return n_seg


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Parameters on the generator's device, one tensor at a time (each
    drawn in float32, then cast to ``cfg.param_dtype``; the leaves the
    reference keeps in float32 stay float32)."""
    dt = dtype_of(cfg.param_dtype)
    dev = generator.device
    if cfg.mup is not None:
        # muP: embeddings of unit scale after ``embedding``, logits of unit
        # scale after ``lm_head``
        p: Params = {"embed": dense_init(
            generator, cfg.vocab, cfg.d_model, dt,
            scale=1.0 / cfg.mup.embedding)}
        if not cfg.tie_embeddings:
            p["unembed"] = dense_init(
                generator, cfg.vocab, cfg.d_model, dt,
                scale=1.0 / (math.sqrt(cfg.d_model) * cfg.mup.lm_head))
    else:
        p = {"embed": embed_init(generator, cfg.vocab, cfg.d_model, dt)}
        if not cfg.tie_embeddings:
            p["unembed"] = embed_init(generator, cfg.vocab, cfg.d_model, dt)
    p["norm_f"] = norm_init(cfg.d_model, _norm_kind(cfg), dt, dev)

    if cfg.family == "ssm":
        n_seg, per = xlstm_segments(cfg)
        p["mblocks"] = [[init_xlstm_mblock(generator, cfg)
                         for _ in range(per - 1)] for _ in range(n_seg)]
        p["sblocks"] = [init_xlstm_sblock(generator, cfg)
                        for _ in range(n_seg)]
        return p

    if cfg.cross_attn_every:
        n_seg = vlm_segments(cfg)
        p["blocks"] = [[init_block(generator, cfg)
                        for _ in range(cfg.cross_attn_every)]
                       for _ in range(n_seg)]
        p["cross"] = [{"norm": norm_init(cfg.d_model, "rms", dt, dev),
                       "attn": attn.init_attn(generator, cfg.d_model,
                                              cfg.n_heads, cfg.n_kv_heads,
                                              cfg.head_dim, dt),
                       "gate": torch.zeros((1,), dtype=torch.float32,
                                           device=dev)}
                      for _ in range(n_seg)]
        return p

    p["blocks"] = [[init_block(generator, cfg) for _ in range(n)]
                   for (n, _, _) in attn_runs(cfg)]
    return p


def _embed_in(params: Params, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.embedding_inputs:
        return batch["embeds"]
    return embed_tokens(params, cfg, batch["tokens"])


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """The input embeddings of integer tokens, times the muP embedding
    multiplier where the config has one."""
    x = embed_lookup(params["embed"], tokens).to(dtype_of(cfg.dtype))
    return x if cfg.mup is None else x * cfg.mup.embedding


def _unembed(params: Params, cfg: ModelConfig, x: torch.Tensor
             ) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = x @ w.to(x.dtype).T
    return logits if cfg.mup is None else logits * cfg.mup.lm_head


def _stack_caches(caches: List[dict]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def forward(params: Params, batch, cfg: ModelConfig, ctx=None,
            mode: str = "train"):
    """Full-sequence forward. Returns (h_final, aux): the pre-unembed hidden
    state, and in prefill mode the prompt's cache (None otherwise):

    - uniform archs: one dict per run, each leaf stacked to (n, ...): "k",
      "v" (B, S, K, hd) and, for hybrid runs, "mamba_conv" and "mamba_h";
    - vlm: {"k", "v"} stacked to (n_seg, inner, B, S, K, hd);
    - ssm: None (decoding rebuilds the recurrent state step by step).
    """
    x = _embed_in(params, cfg, batch)
    if ctx:
        x = ctx.act_btd(x)
    positions = torch.arange(x.shape[1], device=x.device)
    collect = mode == "prefill"
    blk_mode = "prefill" if collect else "train"

    if cfg.family == "ssm":
        x = _xlstm_stack(params, x, cfg, ctx)
        aux = None
    elif cfg.cross_attn_every:
        x, aux = _vlm_stack(params, x, batch["vision_embeds"], cfg, ctx,
                            positions, blk_mode)
    elif collect:
        aux = []
        for run_p, (n, w, th) in zip(params["blocks"], attn_runs(cfg)):
            caches = []
            for blk in run_p:
                x, c = apply_block(blk, x, cfg, window=w, theta=th, ctx=ctx,
                                   positions=positions, mode=blk_mode)
                caches.append(c)
            aux.append(_stack_caches(caches))
    else:
        for run_p, (n, w, th) in zip(params["blocks"], attn_runs(cfg)):
            def body(xc, blk, _w=w, _th=th):
                return apply_block(blk, xc, cfg, window=_w, theta=_th,
                                   ctx=ctx, positions=positions)[0]
            x = _run_layers(body, x, run_p, cfg)
        aux = None
    x = norm_apply(params["norm_f"], x, _norm_kind(cfg), cfg.norm_eps)
    return x, aux


def _run_layers(body, x: torch.Tensor, blocks, cfg: ModelConfig,
                grouped: bool = True) -> torch.Tensor:
    """``body(x, blk)`` for each block in order, each under ``_remat``.
    Where ``grouped`` and ``cfg.remat_groups`` g divides the run (and is
    smaller), each group of n / g blocks is also checkpointed whole, so
    that one residual a group stays saved (the reference's two-level
    remat of ``_scan_run``)."""
    layer = _remat(body, cfg)
    g, n = cfg.remat_groups, len(blocks)
    if grouped and g and n % g == 0 and n > g and torch.is_grad_enabled():
        inner = n // g

        def group(xc, *blks):
            for blk in blks:
                xc = layer(xc, blk)
            return xc

        outer = _checkpointed(group)
        for i in range(0, n, inner):
            x = outer(x, *blocks[i:i + inner])
        return x
    for blk in blocks:
        x = layer(x, blk)
    return x


def _vlm_stack(params, x, vis, cfg, ctx, positions, blk_mode):
    def body(xc, blk):
        return apply_block(blk, xc, cfg, window=0, theta=cfg.rope_theta,
                           ctx=ctx, positions=positions)[0]

    caches = []
    for blks, cross in zip(params["blocks"], params["cross"]):
        if blk_mode == "train":
            x = _run_layers(body, x, blks, cfg, grouped=False)
        else:
            seg = []
            for blk in blks:
                x, c = apply_block(blk, x, cfg, window=0,
                                   theta=cfg.rope_theta, ctx=ctx,
                                   positions=positions, mode=blk_mode)
                seg.append(c)
            caches.append(_stack_caches(seg))
        h = norm_apply(cross["norm"], x, "rms", cfg.norm_eps)
        c_out = attn.cross_attn_forward(
            cross["attn"], h, vis, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            shard=ctx.act_kv if ctx else None)
        x = x + torch.tanh(cross["gate"]).to(x.dtype) * c_out
    return x, (_stack_caches(caches) if caches else None)


def _xlstm_stack(params, x, cfg, ctx=None):
    chunk = cfg.ssm.chunk if cfg.ssm else 128

    def m_body(xc, blk):
        y = xc + xlstm_mod.mlstm_forward(
            blk["m"], norm_apply(blk["norm"], xc, "rms", cfg.norm_eps),
            n_heads=cfg.n_heads, chunk=chunk)
        return ctx.act_btd(y) if ctx else y

    for mblks, sblk in zip(params["mblocks"], params["sblocks"]):
        x = _run_layers(m_body, x, mblks, cfg, grouped=False)
        h_in = norm_apply(sblk["norm"], x, "rms", cfg.norm_eps)
        if ctx is not None and ctx.slstm_local_grad:
            h = xlstm_mod.slstm_forward_sharded(
                sblk["s"], h_in, n_heads=cfg.n_heads, mesh=ctx.mesh,
                batch_axes=ctx.batch_axes)
        else:
            h = xlstm_mod.slstm_forward(sblk["s"], h_in, n_heads=cfg.n_heads)
        x = x + h
        if ctx:
            x = ctx.act_btd(x)
    return x


# ---------------------------------------------------------------------------
# Loss (chunked CE)
# ---------------------------------------------------------------------------


def _slice_index(mesh, split) -> int:
    """This rank's index among the slices of a dim split (evenly, major
    mesh dim first) over the mesh dims where ``split`` is true."""
    coord, j = mesh.get_coordinate(), 0
    for i, s in enumerate(split):
        if s:
            j = j * mesh.size(i) + coord[i]
    return j


def embed_lookup(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """w[tokens]: the (V, D) table's rows at integer tokens.

    On a DTensor table the vocab keeps its split and the rest of the table
    is gathered (FSDP); each rank looks up the tokens inside its vocab
    slice, zero elsewhere, and the slices are summed over the axes that
    split the vocab (exact: one term is not zero). The output is laid out
    as the tokens, D whole. (DTensor's own rule leaves a masked partial
    that some versions cannot reduce.)"""
    if not isinstance(w, DTensor):
        return F.embedding(tokens, w)
    mesh = w.device_mesh
    wpl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in w.placements]
    split = [isinstance(p, Shard) for p in wpl]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tpl = [Replicate() if s else p for p, s in zip(tokens.placements, split)]
    # the table's gradient: its own vocab slice where the vocab is split;
    # a part from each rank's tokens where the tokens are split
    gpl = [Shard(0) if s else (Partial() if isinstance(p, Shard) else p)
           for p, s in zip(tpl, split)]
    wl = w.redistribute(mesh, wpl).to_local(grad_placements=gpl)
    tl = tokens.redistribute(mesh, tpl).to_local()
    n = wl.shape[0]
    idx = tl - _slice_index(mesh, split) * n
    inside = (idx >= 0) & (idx < n)
    out = F.embedding(idx.clamp(0, n - 1), wl)
    out = torch.where(inside[..., None], out, 0.0)
    out = psum(out, mesh, [a for a, s in zip(mesh.mesh_dim_names, split)
                           if s])
    return DTensor.from_local(out, mesh, tpl, run_check=False)


def _label_logit(logits: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """logits[..., lab]: (B, c, V) at labels (B, c).

    DTensor's rule for ``gather`` along a sharded vocab fails here, so on a
    DTensor each rank takes the labels inside its vocab slice from its
    local shard, zero elsewhere, and the slices are summed over the axes
    that split the vocab (exact: one term is not zero)."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, lab[..., None])[..., 0]
    mesh, last = logits.device_mesh, logits.ndim - 1
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    split = [isinstance(p, Shard) and p.dim == last for p in pl]
    out_pl = [Replicate() if s else p for p, s in zip(pl, split)]
    lg = logits.redistribute(mesh, pl).to_local()
    if not isinstance(lab, DTensor):
        lab = DTensor.from_local(lab, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    lb = lab.redistribute(mesh, out_pl).to_local()
    n = lg.shape[-1]
    idx = lb - _slice_index(mesh, split) * n
    inside = (idx >= 0) & (idx < n)
    val = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])
    val = torch.where(inside, val[..., 0], 0.0)
    val = psum(val, mesh, [a for a, s in zip(mesh.mesh_dim_names, split)
                           if s])
    return DTensor.from_local(val, mesh, out_pl, run_check=False)


def _chunk_nll(w: torch.Tensor, h: torch.Tensor, lab: torch.Tensor,
               ctx=None):
    """Summed negative log-likelihood and the count of unmasked positions
    of one chunk: h (B, c, D) against the unembedding w (V, D); labels < 0
    are masked."""
    logits = h @ w.to(h.dtype).T
    if ctx:
        logits = ctx.act_logits(logits)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = _label_logit(logits, torch.clamp(lab, min=0))
    mask = (lab >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def loss_fn(params: Params, batch, cfg: ModelConfig, ctx=None,
            ce_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross entropy (every position for an encoder-only arch)
    with the unembed chunked along the sequence: ``ce_chunk`` positions at
    a time, the last chunk padded with label -1 (masked)."""
    h, _ = forward(params, batch, cfg, ctx, mode="train")
    if cfg.encoder_only:
        h_in, lab = h, batch["labels"]
    else:
        h_in = h[:, :-1]
        lab = (batch["labels"] if "labels" in batch
               else batch["tokens"])[:, 1:]
    lab = lab.long()
    S = h_in.shape[1]
    ce_chunk = min(ce_chunk, S)
    # the last chunk is padded with masked positions; on a DTensor it is
    # cut short instead (the padded rows add nothing to either sum)
    pad = 0 if isinstance(h_in, DTensor) else (-S) % ce_chunk
    if pad:
        h_in = F.pad(h_in, (0, 0, 0, pad))
        lab = F.pad(lab, (0, pad), value=-1)
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    nll = functools.partial(_chunk_nll, ctx=ctx)
    if torch.is_grad_enabled():
        nll = _checkpointed(nll)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S + pad, ce_chunk):
        t, n = nll(w, h_in[:, c:c + ce_chunk], lab[:, c:c + ce_chunk])
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def logits_fn(params: Params, batch, cfg: ModelConfig, ctx=None
              ) -> torch.Tensor:
    """Full logits (B, S, V) (for tests / small-scale evaluation)."""
    h, _ = forward(params, batch, cfg, ctx, mode="train")
    return _unembed(params, cfg, h)
