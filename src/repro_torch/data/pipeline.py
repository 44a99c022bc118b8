"""Deterministic synthetic data pipeline with sharded, resumable iteration.

Tokens are a pure function of (seed, step, position) via a counter-based
threefry hash, so: (a) every data-parallel shard generates ONLY its slice —
no host reads the global batch; (b) restart-from-checkpoint resumes the
stream exactly (the step index is the cursor); (c) no filesystem dependency.
A background prefetch thread keeps `depth` batches ready (host-side input
pipelining — the paper's encode/execute overlap, applied to training).

Port of ``repro.data.pipeline``, numpy only, kept as the port's own copy:
batches are byte-equal to the reference's. ``repro_torch.train.loop``
moves them onto the device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def _threefry_like(x: np.ndarray, seed: int) -> np.ndarray:
    """Cheap counter-based hash (splitmix-ish), vectorised uint64 -> uint64."""
    mix = (seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = (x.astype(np.uint64) + np.uint64(mix)) \
        * np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return z


@dataclass
class ShardSpec:
    shard_id: int = 0
    n_shards: int = 1


def synth_batch(cfg: ModelConfig, step: int, batch: int, seq_len: int,
                seed: int = 0, shard: ShardSpec = ShardSpec()
                ) -> Dict[str, np.ndarray]:
    """The shard's slice of the global batch at `step`."""
    rows = batch // shard.n_shards
    row0 = shard.shard_id * rows
    # counter grid: (row, pos) -> global unique counter
    r = (np.arange(rows) + row0)[:, None].astype(np.uint64)
    p = np.arange(seq_len)[None, :].astype(np.uint64)
    ctr = (np.uint64(step) << np.uint64(40)) + (r << np.uint64(20)) + p
    h = _threefry_like(ctr, seed)
    out: Dict[str, np.ndarray] = {}
    if cfg.embedding_inputs:
        # frame embeddings: hash -> gaussian-ish floats via CLT of 2 uniforms
        d = cfg.d_model
        cols = np.arange(d)[None, None, :].astype(np.uint64)
        hh = _threefry_like(ctr[..., None] * np.uint64(131) + cols, seed + 1)
        u = (hh >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        out["embeds"] = ((u - 0.5) * 3.46).astype(np.float32)
        out["labels"] = (h % np.uint64(cfg.vocab)).astype(np.int32)
    else:
        # learnable structure: arithmetic token sequences with hash-derived
        # per-row offset/stride + 1/8 random-noise positions (so loss can
        # drop well below log(vocab) but not to zero)
        row_h = _threefry_like(r + np.uint64(step) * np.uint64(1 << 20),
                               seed + 3)
        offset = (row_h % np.uint64(cfg.vocab)).astype(np.int64)
        stride = (row_h >> np.uint64(17)) % np.uint64(2) + np.uint64(1)
        base = (offset + p.astype(np.int64) * stride.astype(np.int64)) \
            % cfg.vocab
        noise = (h % np.uint64(cfg.vocab)).astype(np.int64)
        is_noise = (h >> np.uint64(5)) % np.uint64(8) == 0
        toks = np.where(is_noise, noise, base).astype(np.int32)
        out["tokens"] = toks
        out["labels"] = toks  # LM: loss shifts internally
    if cfg.cross_attn_every:
        tv, d = cfg.n_vision_tokens, cfg.d_model
        sub = _threefry_like(ctr[:, :1] + np.uint64(7), seed + 2)
        rng = np.random.default_rng(int(sub[0, 0] % np.uint64(2**31)))
        out["vision_embeds"] = rng.standard_normal(
            (rows, tv, d)).astype(np.float32)
    return out


class Prefetcher:
    """Background-thread batch prefetch (depth-bounded)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, shard: ShardSpec = ShardSpec(),
                 start_step: int = 0, depth: int = 2):
        self.cfg, self.batch, self.seq = cfg, batch, seq_len
        self.seed, self.shard = seed, shard
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                b = synth_batch(self.cfg, self._step, self.batch, self.seq,
                                self.seed, self.shard)
            except Exception as e:  # propagate to the consumer
                self._q.put(e)
                return
            self._q.put((self._step, b))
            self._step += 1

    def next(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
