"""Attention: blockwise (online-softmax) full-sequence attention with causal /
sliding-window / bidirectional masks, GQA grouped heads, single-token
decode against a KV cache, and the VLM's cross attention.

Port of ``repro.models.attention`` with its three layouts, which a sharding
context chooses (``ShardCtx.attn_layout``): ``grouped`` (GQA heads as the
cache holds them), ``expand`` (KV heads repeated up to the query heads, so
that the head dim shards over ``model`` when the KV heads do not divide
it) and ``qblock`` (query blocks as a batch-like dim, sharded over
``model`` when no head count divides it). On DTensors, ``shard`` and
``shard_qblocks`` redistribute; without a context the layout is grouped.
Attention is independent across batch rows and heads, so over a mesh the
blockwise and decode kernels run on each rank's (batch, head) shards
(``local_map``, as GSPMD partitions them with no collective); only a
sequence-split cache goes through DTensor's own rules. Scores, softmax and accumulation are float32, as the reference's
``preferred_element_type=jnp.float32`` makes them.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.common import apply_rope, dense_init
from repro_torch.sharding.specs import (merge_last, on_batch_head_shards,
                                       split_last)

NEG_INF = -1e30


def init_attn(generator: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, dtype: torch.dtype) -> dict:
    return {
        "wq": dense_init(generator, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(generator, d_model, n_kv_heads * head_dim, dtype),
        "wv": dense_init(generator, d_model, n_kv_heads * head_dim, dtype),
        "wo": dense_init(generator, n_heads * head_dim, d_model, dtype,
                         scale=1.0 / math.sqrt(n_heads * head_dim)),
    }


def _attn_local(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` on each rank's (batch, head) shards; a
    sequence-split k (a decode cache) goes through DTensor's rules."""
    if isinstance(k, DTensor) and any(
            isinstance(p, Shard) and p.dim == 1 for p in k.placements):
        return fn(q, k, v, **kw)
    return on_batch_head_shards(fn, q, k, v, **kw)


def _block_pairs(n_q: int, n_kv: int, block_q: int, block_kv: int,
                 causal: bool, window: int):
    """(qi, kj) block pairs that may contain unmasked entries, in the
    reference's visiting order."""
    pairs = []
    for qi in range(n_q):
        q_lo, q_hi = qi * block_q, qi * block_q + block_q - 1
        for kj in range(n_kv):
            k_lo, k_hi = kj * block_kv, kj * block_kv + block_kv - 1
            if causal and k_lo > q_hi:
                continue
            if window > 0 and k_hi < q_lo - window + 1:
                continue
            pairs.append((qi, kj))
    return pairs


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0, block_q: int = 512,
                        block_kv: int = 512, q_offset: int = 0,
                        kv_start=None) -> torch.Tensor:
    """Online-softmax attention over blocks, visiting only the block pairs
    that can hold unmasked entries.

    q: (B, Sq, K, G, d) grouped GQA layout (query head h = k * G + g);
    k, v: (B, Skv, K, d). window: 0 == unlimited, else a causal sliding
    window of that many positions. q_offset: absolute position of q[0]
    relative to k[0]. kv_start: None, or (B,) the first key each row may
    see (its left padding masked). Returns (B, Sq, K, G, d) in q's dtype.
    """
    B, Sq, K, G, d = q.shape
    Skv = k.shape[1]
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    n_q = -(-Sq // block_q)
    n_kv = -(-Skv // block_kv)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q32, k32, v32 = q.float(), k.float(), v.float()
    q_ids = torch.arange(block_q, device=dev)
    k_ids = torch.arange(block_kv, device=dev)
    pairs = _block_pairs(n_q, n_kv, block_q, block_kv, causal, window)

    # one query block at a time, its running max, sum and output held as
    # new tensors (nothing written in place, so autograd can differentiate)
    outs = []
    for qi in range(n_q):
        qs = qi * block_q
        qb = q32[:, qs:qs + block_q]
        nq = qb.shape[1]                        # the last block may be short
        acc = torch.zeros((B, nq, K, G, d), dtype=torch.float32, device=dev)
        m = torch.full((B, K, G, nq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, nq), dtype=torch.float32, device=dev)
        q_pos = qs + q_ids[:nq] + q_offset
        for kj in (kj for (i, kj) in pairs if i == qi):
            ks = kj * block_kv
            kb = k32[:, ks:ks + block_kv]
            vb = v32[:, ks:ks + block_kv]
            nk = kb.shape[1]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            k_pos = ks + k_ids[:nk]
            mask = torch.ones((nq, nk), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            if kv_start is not None:
                mask = (mask[None] & (k_pos[None, None, :]
                                      >= kv_start[:, None, None]))[
                    :, None, None]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            m = m_new
            pv = torch.einsum("bkgqs,bskd->bqkgd", p, vb)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        denom = l.permute(0, 3, 1, 2)[..., None]
        outs.append(acc / torch.clamp(denom, min=1e-30))
    return torch.cat(outs, dim=1).to(q.dtype)


def qblock_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window: int = 0, block_q: int = 512,
                     block_kv: int = 512, shard_blocks=None) -> torch.Tensor:
    """Query-block-PARALLEL attention: all query blocks are a batch-like dim
    (shardable over the model axis) instead of a sequential loop.

    Used when neither KV nor Q heads divide the model axis (hymba: 25
    heads). Windowed layers gather a per-block KV window (static indices);
    global layers run over KV blocks with online softmax and causal
    masking (up to 2x the triangle's FLOPs, in exchange for n-way
    sharding).

    q: (B, S, K, G, d); k, v: (B, S, K, d). Returns (B, S, K, G, d).
    """
    B, S, K, G, d = q.shape
    Skv = k.shape[1]
    dev = q.device
    block_q = min(block_q, S)
    pad = (-S) % block_q
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad)) if pad else q
    Sp = S + pad
    nb = Sp // block_q
    qb = qp.reshape(B, nb, block_q, K, G, d)
    if shard_blocks is not None:
        qb = shard_blocks(qb)
    qb = qb.float()
    scale = 1.0 / math.sqrt(d)
    q_pos = (torch.arange(nb, device=dev) * block_q)[:, None] \
        + torch.arange(block_q, device=dev)[None]

    if causal and window > 0:
        wp = window + block_q
        base = (torch.arange(nb, device=dev) * block_q)[:, None] - window \
            + torch.arange(wp, device=dev)[None, :]              # (nb, wp)
        idx = torch.clamp(base, 0, Skv - 1)
        kw = k[:, idx].float()                                # (B,nb,wp,K,d)
        vw = v[:, idx].float()
        s = torch.einsum("bnqkgd,bnwkd->bnkgqw", qb, kw) * scale
        mask = (base[:, None, :] <= q_pos[..., None]) \
            & (base[:, None, :] > q_pos[..., None] - window) \
            & (base >= 0)[:, None, :] & (base < Skv)[:, None, :]
        s = torch.where(mask[None, :, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bnkgqw,bnwkd->bnqkgd", p, vw)
    else:
        block_kv = min(block_kv, Skv)
        pk = (-Skv) % block_kv
        if pk:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        n_kv = (Skv + pk) // block_kv
        k_ids = torch.arange(block_kv, device=dev)
        acc = torch.zeros((B, nb, block_q, K, G, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, nb, K, G, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, nb, K, G, block_q), dtype=torch.float32,
                        device=dev)
        for j in range(n_kv):
            ks = j * block_kv
            kb = k[:, ks:ks + block_kv].float()
            vb = v[:, ks:ks + block_kv].float()
            s = torch.einsum("bnqkgd,bskd->bnkgqs", qb, kb) * scale
            k_pos = ks + k_ids
            mask = k_pos[None, None, :] < Skv
            if causal:
                mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
            s = torch.where(mask[None, :, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pexp = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pexp.sum(dim=-1)
            m = m_new
            pv = torch.einsum("bnkgqs,bskd->bnqkgd", pexp, vb)
            acc = acc * torch.movedim(corr, -1, 2)[..., None] + pv
        out = acc / torch.clamp(torch.movedim(l, -1, 2)[..., None],
                                min=1e-30)
    out = out.reshape(B, Sp, K, G, d)[:, :S]
    return out.to(q.dtype)


def attention_scores_decode(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, *, pos,
                            window: int = 0, kv_start=None) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, K, G, d); k_cache / v_cache: (B, S, K, d); pos: the number of
    valid cache entries (the new token's absolute position + 1), an int
    or a 0-d integer tensor on q's device; kv_start:
    None, or (B,) each row's first valid entry. q is
    rounded to the cache's dtype and the probabilities to v's before each
    product, as in the reference; the products run in float32.
    """
    B, _, K, G, d = q.shape
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(k_cache.dtype).float(),
                     k_cache.float()) * scale
    ids = torch.arange(S, device=q.device)
    valid = ids < pos
    if window > 0:
        valid &= ids > pos - 1 - window
    if kv_start is not None:
        valid = (valid[None] & (ids[None] >= kv_start[:, None]))[
            :, None, None, None]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


def _split_heads(x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int
                 ) -> torch.Tensor:
    """(B, S, H*hd) -> grouped (B, S, K, G, hd), query head h = k * G + g."""
    return split_last(x, n_kv, n_heads // n_kv, head_dim)


def _split_kv(x: torch.Tensor, n_kv: int, head_dim: int) -> torch.Tensor:
    return split_last(x, n_kv, head_dim)


def attn_forward(params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                 head_dim: int, rope_theta, positions=None,
                 causal: bool = True, window: int = 0, block_q: int = 512,
                 block_kv: int = 512, shard=None, layout: str = "grouped",
                 shard_qblocks=None, key_scale=None, kv_start=None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v)),
    the cache entries in the compact (B, S, K, hd) layout whatever the
    layout of the computation.

    layout="expand": KV heads are replicated up to n_heads so the head dim
    can be tensor-sharded when n_kv_heads does not divide the model axis.
    layout="qblock": :func:`qblock_attention`, its query blocks passed
    through ``shard_qblocks``. ``shard`` constrains q, k and v otherwise.
    ``key_scale`` multiplies the keys before RoPE (Falcon-H1's key
    multiplier); ``kv_start`` (B,) masks each row's left padding, with
    ``positions`` (B, S) its own positions (grouped layout).
    """
    B, S, _ = x.shape
    q = _split_heads(x @ params["wq"].to(x.dtype), n_heads, n_kv_heads,
                     head_dim)
    k = _split_kv(x @ params["wk"].to(x.dtype), n_kv_heads, head_dim)
    v = _split_kv(x @ params["wv"].to(x.dtype), n_kv_heads, head_dim)
    if key_scale is not None:
        k = k * key_scale
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    cache = (k, v)
    if layout == "qblock":
        out = qblock_attention(q, k, v, causal=causal, window=window,
                               block_q=block_q, block_kv=block_kv,
                               shard_blocks=shard_qblocks)
        out = merge_last(out, 3)
        return out @ params["wo"].to(x.dtype), cache
    if layout == "expand":
        G = n_heads // n_kv_heads
        q = q.reshape(B, S, n_heads, 1, head_dim)
        k = k[:, :, :, None].expand(B, S, n_kv_heads, G, head_dim) \
            .reshape(B, S, n_heads, head_dim)
        v = v[:, :, :, None].expand(B, S, n_kv_heads, G, head_dim) \
            .reshape(B, S, n_heads, head_dim)
    if shard is not None:
        q, k, v = shard(q), shard(k), shard(v)
    kw = {} if kv_start is None else {"kv_start": kv_start}
    out = _attn_local(blockwise_attention, q, k, v, causal=causal,
                      window=window, block_q=block_q, block_kv=block_kv, **kw)
    out = merge_last(out, 3)
    return out @ params["wo"].to(x.dtype), cache


def _write_pos(cache: torch.Tensor, pos, val: torch.Tensor) -> None:
    """cache[:, pos] = val in place; cache (B, S, K, hd), val (B, K, hd).

    ``pos`` is an int, or a 0-d int64 tensor on a plain cache's device
    (an index write, so that a captured CUDA graph reads it at replay).
    On a DTensor cache the write runs on the local shards, on the rank
    that holds position ``pos`` of a sequence-sharded cache."""
    if not isinstance(cache, DTensor):
        if isinstance(pos, torch.Tensor):
            cache.index_copy_(1, pos.view(1), val[:, None].to(cache.dtype))
        else:
            cache[:, pos] = val.to(cache.dtype)
        return
    mesh, pl = cache.device_mesh, cache.placements
    # the value's layout: the cache's, without its sequence dim
    vpl = [Replicate() if (isinstance(p, Shard) and p.dim == 1) else
           (Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p)
           for p in pl]
    if not isinstance(val, DTensor):
        val = DTensor.from_local(val, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    v_loc = val.redistribute(mesh, vpl).to_local()
    # this rank's slice of the sequence (the policy splits it evenly,
    # major mesh dim first)
    coord, idx, n = mesh.get_coordinate(), 0, 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    size = cache.shape[1] // n
    if idx * size <= pos < (idx + 1) * size:
        cache.to_local()[:, pos - idx * size] = v_loc.to(cache.dtype)


def attn_decode(params, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, *, pos, n_heads: int,
                n_kv_heads: int, head_dim: int, rope_theta, window: int = 0,
                shard=None, key_scale=None, kv_start=None, rope_pos=None):
    """One-token decode. x: (B, 1, D); cache: (B, S, K, hd), written in
    place at index ``pos`` (an int, or a 0-d int64 tensor on x's device).
    Returns (out, cache_k, cache_v).

    ``key_scale``: as in :func:`attn_forward`. ``kv_start`` (B,): each
    row's first valid cache entry; ``rope_pos`` (B, 1): each row's own
    position of the new token (``pos`` where None)."""
    B = x.shape[0]
    q = _split_heads(x @ params["wq"].to(x.dtype), n_heads, n_kv_heads,
                     head_dim)
    k = _split_kv(x @ params["wk"].to(x.dtype), n_kv_heads, head_dim)
    v = _split_kv(x @ params["wv"].to(x.dtype), n_kv_heads, head_dim)
    if key_scale is not None:
        k = k * key_scale
    if rope_theta is not None:
        if rope_pos is not None:
            p = rope_pos
        elif isinstance(pos, torch.Tensor):
            p = pos.view(1)
        else:
            p = torch.full((1,), pos, device=x.device)
        q = apply_rope(q, p, rope_theta)
        k = apply_rope(k, p, rope_theta)
    _write_pos(cache_k, pos, k[:, 0])
    _write_pos(cache_v, pos, v[:, 0])
    ck, cv = cache_k, cache_v
    if shard is not None:
        ck, cv = shard(ck), shard(cv)
    kw = {} if kv_start is None else {"kv_start": kv_start}
    out = _attn_local(attention_scores_decode, q, ck, cv, pos=pos + 1,
                      window=window, **kw)
    out = merge_last(out, 3)
    return out @ params["wo"].to(x.dtype), cache_k, cache_v


def cross_attn_forward(params, x: torch.Tensor, kv_src: torch.Tensor, *,
                       n_heads: int, n_kv_heads: int, head_dim: int,
                       shard=None) -> torch.Tensor:
    """Cross attention: queries from x (B, S, D), keys and values from
    kv_src (B, T, D), no mask and no RoPE. Returns (B, S, D)."""
    B, S, _ = x.shape
    q = _split_heads(x @ params["wq"].to(x.dtype), n_heads, n_kv_heads,
                     head_dim)
    k = _split_kv(kv_src @ params["wk"].to(kv_src.dtype), n_kv_heads,
                  head_dim)
    v = _split_kv(kv_src @ params["wv"].to(kv_src.dtype), n_kv_heads,
                  head_dim)
    if shard is not None:
        q, k, v = shard(q), shard(k), shard(v)
    out = _attn_local(blockwise_attention, q, k, v, causal=False, window=0)
    out = merge_last(out, 3)
    return out @ params["wo"].to(x.dtype)
