"""Single-token decode steps, prefill and cache construction for all
families.

Port of ``repro.models.decode``. ``decode_step`` updates the cache in place
(the new token's keys and values written at ``pos``, recurrent states
overwritten) and returns it, so callers keep one cache per batch.
``cache_struct`` describes the cache with meta tensors (shape and dtype, no
storage), the analog of the reference's ShapeDtypeStruct tree.

``prefill_prompts`` is how a batch of prompts becomes a decode cache, for
every decoder arch: every row's last prompt token at index P - 1 (P the
longest prompt), so that decoding goes on at ``pos`` = P. A Mamba-2 hybrid
(Falcon-H1) sorts its rows by length, splits them into groups
(``prefill_groups``) and runs one ``prefill_ragged`` a group: a
full-sequence pass over the group's prompts, padded on the left to its own
longest, written through an index of cache rows at its own offset, so that
each row is where it would be alone (its cache carries each row's
"start"). Every other arch runs ``decode_step`` once per prompt position
for every row, as the reference does.

``decoder`` is what a server keeps per device to run batches: it yields
each batch's cache for the prefill, then runs the decode steps. A Mamba-2
hybrid on a CUDA device gets a ``GraphDecoder`` (one cache kept across
batches, the step replayed as a CUDA graph per row bucket, the position a
0-d device tensor); every other arch, and every CPU run, an
``EagerDecoder`` (a fresh ``init_cache`` a batch, ``decode_step`` with an
``int`` pos). Both run the same ``decode_step`` arithmetic.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
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

# A ragged prefill pass's fixed cost, in tokens of prefill. Reading every
# weight once costs launch.roofline's PEAK_FLOPS / HBM_BW (~295) tokens of
# bf16 compute, but the host sets a larger floor: on one H100, one pass of
# 36 Falcon-H1-34B layers takes 115-150 ms to issue however few its tokens,
# the device time of ~1,500 prefill tokens. A pass costs the larger of the
# two clocks, not their sum, so for batches of 16-42 prompts of 32-384
# tokens the split that finishes first lies at 700-1,000 (PERF.md §6)
PASS_COST_TOKENS = 800


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


def decode_step(params, cache, token: torch.Tensor, pos,
                cfg: ModelConfig, ctx=None) -> Tuple[torch.Tensor, Any]:
    """token: (B, 1) integer ids; pos: the write index into the cache, an
    int or a 0-d int64 tensor on the cache's device (the same arithmetic:
    a tensor lets one captured CUDA graph serve every position).

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
                   cfg: ModelConfig, offset: int = 0,
                   rows: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """One full-sequence pass over a ragged batch of a Mamba-2 hybrid.

    tokens: (b, T) integer ids, each row's prompt at its right end and
    padding (any id) on its left; start: (b,) int64, the index of each
    row's first real token. Writes into the cache rows ``rows`` ((b,)
    int64; None: every row of the cache, b of them) of ``cache``
    (``init_cache``, with at least ``offset`` + T positions) the keys and
    values at indices ``offset`` .. ``offset`` + T - 1, the conv and SSM
    states after the last, and ``start`` + ``offset``; decoding then goes
    on at ``pos`` = ``offset`` + T for those rows. Returns (the logits at
    index T - 1 (b, 1, V), cache). Each row's logits and cache entries are
    those of the row prefilled alone (its padding masked, its positions
    counted from ``start``), wherever ``offset`` and ``rows`` put it."""
    if cfg.mamba2 is None:
        raise ValueError(f"{cfg.arch}: no ragged prefill (a Mamba-2 hybrid "
                         f"only)")
    T = tokens.shape[1]
    if rows is None:
        rows = torch.arange(tokens.shape[0], device=tokens.device)
    x = embed_tokens(params, cfg, tokens)
    cache["start"].index_copy_(0, rows, start + offset)
    for run_p, run_c, (n, w, th) in zip(params["blocks"], cache["runs"],
                                        attn_runs(cfg)):
        for i, blk in enumerate(run_p):
            x, c = apply_block(blk, x, cfg, window=w, theta=th,
                               mode="prefill", start=start)
            for k, dst in (("k", run_c["k"][i, :, offset:offset + T]),
                           ("v", run_c["v"][i, :, offset:offset + T]),
                           ("mamba_conv", run_c["mamba_conv"][i]),
                           ("mamba_h", run_c["mamba_h"][i])):
                dst.index_copy_(0, rows, c[k].to(dst.dtype))
    x = norm_apply(params["norm_f"], x[:, -1:], "rms", cfg.norm_eps)
    return _unembed(params, cfg, x), cache


def prefill_groups(lens: Sequence[int], cost: float
                   ) -> List[Tuple[int, int]]:
    """Split prompt lengths sorted in ascending order into contiguous
    groups ``[(r0, r1), ...]`` that minimise the tokens a padded prefill
    computes, sum over groups of rows x the group's longest prompt, plus
    ``cost`` a group: an exact dynamic program over the split points,
    O(len(lens) ** 2). Equal lengths give one group."""
    n = len(lens)
    best = [0.0] + [float("inf")] * n     # best[j]: rows 0 .. j - 1 split
    cut = [0] * (n + 1)
    for j in range(1, n + 1):
        for i in range(j):
            c = best[i] + (j - i) * lens[j - 1] + cost
            if c < best[j]:
                best[j], cut[j] = c, i
    groups, j = [], n
    while j > 0:
        groups.append((cut[j], j))
        j = cut[j]
    return groups[::-1]


def prefill_prompts(params, cache, toks: np.ndarray, lens: Sequence[int],
                    cfg: ModelConfig, ctx=None
                    ) -> Tuple[torch.Tensor, int, int]:
    """Fill ``cache`` (``init_cache`` of B rows) with a batch of prompts.

    toks: (B, >= P) host integer ids, row i's prompt in its first
    ``lens[i]`` columns and zeros after, P = max(lens). Every row's last
    prompt token ends at cache index P - 1; decoding goes on at ``pos`` =
    P. Rows keep the caller's order. Returns (the logits of each row's
    last prompt position (B, 1, V), the passes run, the prefill tokens
    computed, real and padding).

    A Mamba-2 hybrid: one ``prefill_ragged`` a group of ``prefill_groups``
    over the rows sorted by length (``PASS_COST_TOKENS`` a pass), each
    padded on the left to its own longest prompt and written at offset P -
    that, the longest group first so that the host can queue the others
    while the card runs it. Every other arch: ``decode_step`` over every
    position for every row, a shorter prompt running on into its zero
    padding, as in the reference."""
    B, P = len(lens), max(lens)
    dev = params["embed"].device
    if cfg.mamba2 is None:
        toks_d = torch.as_tensor(toks[:, :P], dtype=torch.long).to(dev)
        last = None
        for pos in range(P):
            last, cache = decode_step(params, cache, toks_d[:, pos:pos + 1],
                                      pos, cfg, ctx)
        return last, P, B * P
    order = sorted(range(B), key=lens.__getitem__)
    s = [lens[i] for i in order]
    # the rows in length order, each prompt at the right end of its row
    left = np.zeros((B, P), np.int32)
    for k, (i, n) in enumerate(zip(order, s)):
        left[k, P - n:] = toks[i, :n]
    left_d = torch.as_tensor(left, dtype=torch.long).to(dev)
    start_d = torch.as_tensor(P - np.asarray(s, np.int64)).to(dev)
    order_d = torch.as_tensor(order, dtype=torch.long).to(dev)
    groups = prefill_groups(s, PASS_COST_TOKENS)
    last = None
    for r0, r1 in reversed(groups):
        off = P - s[r1 - 1]
        rows = order_d[r0:r1]
        lg, _ = prefill_ragged(params, cache, left_d[r0:r1, off:],
                               start_d[r0:r1] - off, cfg, offset=off,
                               rows=rows)
        if last is None:
            last = lg.new_empty((B,) + lg.shape[1:])
        last.index_copy_(0, rows, lg)
    computed = sum((r1 - r0) * s[r1 - 1] for r0, r1 in groups)
    return last, len(groups), computed


# The captured decoder's row buckets: a batch of B rows decodes on the
# first B rounded up to a multiple of this, so that one CUDA graph serves
# every batch of a bucket (at most ROW_BUCKET - 1 rows of padding a step)
ROW_BUCKET = 8


def _bucket(rows: int) -> int:
    return -(-rows // ROW_BUCKET) * ROW_BUCKET


def decoder(params, max_seq: int, device, cfg: ModelConfig, step):
    """The decoder of ``device``, kept by its caller across batches: a
    Mamba-2 hybrid on a CUDA device gets a ``GraphDecoder``, every other
    arch and every CPU run an ``EagerDecoder`` over ``step`` (the model's
    bound ``decode_step``)."""
    dev = resolve_device(device)
    if cfg.mamba2 is not None and dev.type == "cuda":
        return GraphDecoder(params, cfg, max_seq, dev)
    return EagerDecoder(params, cfg, max_seq, dev, step)


class EagerDecoder:
    """A fresh ``init_cache`` of the batch's rows a batch, and an eager
    ``decode_step`` with an ``int`` pos a step. Holds no state between
    batches, so several threads may run batches at once."""

    n_captures = 0

    def __init__(self, params, cfg: ModelConfig, max_seq: int,
                 device: torch.device, step):
        self.params, self.cfg, self.max_seq = params, cfg, max_seq
        self.device, self._step = device, step

    def warm(self, rows: int) -> None:
        """Nothing to ready."""

    @contextlib.contextmanager
    def batch(self, rows: int):
        """The batch's decode cache, ``rows`` rows, for the prefill and
        ``step``."""
        yield init_cache(self.cfg, rows, self.max_seq, device=self.device)

    def step(self, cache, tokens: torch.Tensor, pos: int):
        """One step of the batch: tokens (B,) on the device. Returns
        (logits (B, 1, V), the greedy next tokens (B,), 0: no graph)."""
        logits, _ = self._step(self.params, cache, tokens[:, None], pos)
        return logits, logits[:, -1].argmax(dim=-1), 0


class GraphDecoder:
    """A Mamba-2 hybrid's decode on one device: one cache kept across
    batches, and the step replayed as a CUDA graph per row bucket.

    The cache holds R rows (the largest batch seen, rounded up to
    ``ROW_BUCKET``). A batch of B rows works on the first b = B rounded
    up: ``batch`` zeroes them (as ``init_cache`` would), the prefill
    writes the B real rows and the decode steps all b; rows B .. b - 1
    are padding, computed and thrown away. Each bucket's graph reads the
    static token and position buffers and the cache rows, runs
    ``decode_step`` with the position as a 0-d tensor and ends in the
    greedy argmax written back into the token buffer; its logits stay in
    the graph's output. Graphs of all buckets share one memory pool (they
    never run at once: ``lock`` covers a batch's prefill and decode).

    ``warm(rows)`` captures every bucket up to ``rows``; a batch larger
    than the kept cache grows it (the graphs go) and captures its own
    bucket when it opens, before its rows are written. A capture error
    raises. Off the card nothing is captured: the same steps run eagerly
    on the same buffers (the CPU tests)."""

    def __init__(self, params, cfg: ModelConfig, max_seq: int,
                 device: torch.device):
        self.params, self.cfg, self.max_seq = params, cfg, max_seq
        self.device = device
        self.lock = threading.Lock()
        self.rows = 0
        self.cache = self._tok = self._pos = None
        self.graphs: Dict[int, Tuple[Any, torch.Tensor]] = {}
        self._pool = None
        self.n_captures = 0

    def _reserve(self, rows: int) -> None:
        R = _bucket(rows)
        if R <= self.rows:
            return
        # the graphs read the old buffers: they go, and the old cache
        # before the new one is made
        self.graphs.clear()
        self._pool = self.cache = None
        self.cache = init_cache(self.cfg, R, self.max_seq,
                                device=self.device)
        self._tok = torch.zeros((R, 1), dtype=torch.long, device=self.device)
        self._pos = torch.zeros((), dtype=torch.long, device=self.device)
        self.rows = R

    def _view(self, b: int):
        """The cache's first b rows (views)."""
        c = self.cache
        return {"runs": [{k: t[:, :b] for k, t in run.items()}
                         for run in c["runs"]], "start": c["start"][:b]}

    def _step(self, b: int) -> torch.Tensor:
        logits, _ = decode_step(self.params, self._view(b), self._tok[:b],
                                self._pos, self.cfg)
        self._tok[:b, 0].copy_(logits[:, -1].argmax(dim=-1))
        return logits

    def _capture(self, b: int) -> None:
        with torch.cuda.device(self.device):
            # one eager step on a side stream first (library handles and
            # workspaces made outside the capture), as torch.cuda.graphs
            # asks; it writes only rows no batch holds yet
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._step(b)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=self._pool,
                                  capture_error_mode="thread_local"):
                logits = self._step(b)
        if self._pool is None:
            self._pool = g.pool()
        self.graphs[b] = (g, logits)
        self.n_captures += 1

    def _ready(self, b: int) -> None:
        if self.device.type == "cuda" and b not in self.graphs:
            self._capture(b)

    def warm(self, rows: int) -> None:
        """Keep a cache of ``rows`` rows (rounded up) and capture every
        bucket up to it."""
        with self.lock:
            self._reserve(rows)
            for b in range(ROW_BUCKET, _bucket(rows) + 1, ROW_BUCKET):
                self._ready(b)

    @contextlib.contextmanager
    def batch(self, rows: int):
        """Hold the device's decoder for one batch of ``rows`` rows and
        yield its cache: the kept cache's first b rows, zeroed."""
        b = _bucket(rows)
        with self.lock:
            self._reserve(b)
            self._ready(b)
            view = self._view(b)
            for run in view["runs"]:
                for t in run.values():
                    t.zero_()
            view["start"].zero_()
            yield view

    def step(self, cache, tokens: torch.Tensor, pos: int):
        """One step of the batch ``batch`` opened (``cache`` is what it
        yielded): tokens (B,) on the device (copying the last step's
        output onto itself is a no-op). Returns (logits (B, 1, V) and the greedy next
        tokens (B,), views of the static buffers that the next step
        overwrites, and the bucket replayed, 0 where no graph ran)."""
        B = tokens.shape[0]
        b = _bucket(B)
        self._tok[:B, 0].copy_(tokens)
        self._pos.fill_(pos)
        g = self.graphs.get(b)
        if g is None:
            logits = self._step(b)
        else:
            g[0].replay()
            logits = g[1]
        return logits[:B], self._tok[:B, 0], b if g is not None else 0
