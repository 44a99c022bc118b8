"""Serving engine: batched prefill + decode with the paper's batch-formation
policy driving request aggregation.

Port of ``repro.serve.engine``. The server's front end is the
DeadlineAggregator (target batch + SLA deadline), and the MCT rule engine
plugs in as a request-filtering stage ahead of the LM (the paper's Table 3
deployment: MCT plus route scoring on one accelerator).

A batch is split into a host-side **prepare** stage (token-matrix assembly
and MCT query encoding, numpy only) and a device-side **execute** stage
(rule matching on the engine's device, then the decode loop).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.aggregator import DeadlineAggregator
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.registry import build_model


@dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    arrival: float = 0.0
    # MCT filtering stage inputs: connection queries + actual connect times
    mct_queries: List[Dict[str, int]] = field(default_factory=list)
    connect_minutes: List[int] = field(default_factory=list)


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray            # generated ids
    prefill_ms: float
    decode_ms: float
    batch_size: int
    truncated: bool = False       # hit the max_seq context limit before
                                  # max_new_tokens were produced


@dataclass
class PreparedBatch:
    """Host-side half of a batch: everything the device stage needs,
    assembled without touching the device."""
    requests: List[Request]
    toks: np.ndarray                      # (B, max_plen) int32
    plens: List[int]
    max_new: int
    mct_encoded: Optional[np.ndarray]     # (Q, C) int32 or None
    mct_owner: List[int] = field(default_factory=list)  # query -> request idx


def form_batch_groups(requests: Sequence[Request], *, target_batch: int = 8,
                      deadline: float = 0.05) -> List[List[Request]]:
    """Replay an arrival-ordered request stream through the paper's
    deadline policy; logical time, so batch composition is deterministic
    for a given stream."""
    agg = DeadlineAggregator(target_batch=target_batch, deadline=deadline)
    batches = []
    for r in sorted(requests, key=lambda x: x.arrival):
        batches.extend(agg.offer(r.rid, [r], now=r.arrival))
    batches.extend(agg.flush())
    return [list(b.queries) for b in batches]


class LMServer:
    """Batched prefill + decode-loop serving for a ported architecture.

    ``params=None`` draws the parameters on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, one tensor at a time.
    ``rule_filter`` is an optional ``ErbiumEngine`` (on its own device).
    """

    def __init__(self, cfg: ModelConfig, params=None, *, device="cuda",
                 max_seq: int = 256, seed: int = 0, rule_filter=None,
                 pad_batches: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, device=self.device)
        self.params = params
        self.max_seq = max_seq
        self.rule_filter = rule_filter
        # pad each batch to the next power of two, as the reference does to
        # bound its compiled variants; rows are independent (masked
        # attention), so padding never changes per-request results
        self.pad_batches = pad_batches
        self._dev_params: Dict[torch.device, object] = {}
        # replica workers call execute_prepared from their own threads: one
        # copy of the parameters per device, never two at once
        self._params_lock = threading.Lock()

    # -- host-side prepare stage ----------------------------------------------
    def prepare_batch(self, requests: Sequence[Request]) -> PreparedBatch:
        """Assemble the token matrix and encode MCT queries: host (numpy)
        work only, safe to run while the device executes another batch."""
        rs = list(requests)
        plens = [len(r.tokens) for r in rs]
        max_new = max((r.max_new_tokens for r in rs), default=0)
        toks = np.zeros((len(rs), max(plens, default=0)), np.int32)
        for i, r in enumerate(rs):
            toks[i, :plens[i]] = r.tokens
        mct_encoded, owner = None, []
        if self.rule_filter is not None:
            flat = []
            for i, r in enumerate(rs):
                for q in r.mct_queries:
                    flat.append(q)
                    owner.append(i)
            if flat:
                mct_encoded = self.rule_filter.encode_queries_host(flat)
        return PreparedBatch(requests=rs, toks=toks, plens=plens,
                             max_new=max_new, mct_encoded=mct_encoded,
                             mct_owner=owner)

    # -- device-side execute stage --------------------------------------------
    def execute_prepared(self, pb: PreparedBatch, *,
                         device=None) -> List[Completion]:
        """Run the device half: MCT rule matching (drops infeasible
        requests), then the batched prefill + decode loop on ``device``
        (default: the server's). Safe to call from several threads.

        Returns only after the card has finished the batch: the decode
        loop reads every step's tokens back with ``.cpu()`` (the prefill
        ends in ``synchronize``), and a batch the filter empties ends in
        the ``.cpu()`` copy of its decisions. The serving stack's worker
        threads time the device-busy interval on the host clock around this
        call and rely on that."""
        rs = pb.requests
        if not rs:
            return []
        toks, plens, max_new = pb.toks, pb.plens, pb.max_new
        if self.rule_filter is not None and pb.mct_encoded is not None:
            keep = self._mct_feasible(rs, pb.mct_encoded, pb.mct_owner)
            if not all(keep):
                # slice the prepared rows: no host re-encode here
                idx = [i for i, ok in enumerate(keep) if ok]
                if not idx:
                    return []
                rs = [rs[i] for i in idx]
                toks = toks[idx]
                plens = [plens[i] for i in idx]
                max_new = max(r.max_new_tokens for r in rs)
        return self._run_decode(rs, toks, plens, max_new, device=device)

    def generate_batch(self, requests: Sequence[Request]) -> List[Completion]:
        """prepare + execute in one synchronous call, with the MCT filter
        stage when the server has one."""
        if not requests:
            return []
        return self.execute_prepared(self.prepare_batch(requests))

    def warmup(self, batch_sizes: Sequence[int] = (1, 8), *,
               prompt_len: int = 4, max_new_tokens: int = 2) -> None:
        """Run each batch size once (allocator, library handles)."""
        for b in batch_sizes:
            reqs = [Request(rid=-1 - i, tokens=np.ones(prompt_len, np.int32),
                            max_new_tokens=max_new_tokens)
                    for i in range(b)]
            self._run_decode(reqs, np.ones((b, prompt_len), np.int32),
                             [prompt_len] * b, max_new_tokens)

    def _params_on(self, device: torch.device):
        """The parameters on ``device``, copied there once and cached."""
        with self._params_lock:
            if device not in self._dev_params:
                self._dev_params[device] = _tree_to(self.params, device)
            return self._dev_params[device]

    @torch.inference_mode()
    def _run_decode(self, rs: List[Request], toks: np.ndarray,
                    plens: List[int], max_new: int,
                    device=None) -> List[Completion]:
        dev = self.device if device is None else resolve_device(device)
        t0 = time.perf_counter()
        B = len(rs)
        total = self.max_seq
        max_p = max(plens)
        if max_p >= total:
            # an error, not an assert: proceeding would write past the cache
            raise ValueError(
                f"max_seq={total} too small for the prompt alone "
                f"(longest prompt: {max_p})")

        Bp = B
        if self.pad_batches and B > 1:
            Bp = 1 << (B - 1).bit_length()      # next power of two
        if Bp != B:
            toks = np.concatenate(
                [toks, np.zeros((Bp - B, toks.shape[1]), np.int32)])

        params = self._params_on(dev)
        cache = self.model.init_cache(Bp, total, device=dev)
        toks_d = torch.as_tensor(toks, dtype=torch.long).to(dev)
        # prefill through the decode step, token by token up to the longest
        # prompt for every row (a shorter prompt's first generated token
        # follows its zero padding, as in the reference)
        generated = [[] for _ in range(B)]
        last_logits = None
        for pos in range(max_p):
            last_logits, cache = self.model.decode_step(
                params, cache, toks_d[:, pos:pos + 1], pos)
        synchronize(dev)
        t1 = time.perf_counter()

        cur = last_logits[:, -1].argmax(dim=-1)
        cur_h = cur.cpu().numpy()
        for s in range(max_new):
            for i in range(B):
                if s < rs[i].max_new_tokens:
                    generated[i].append(int(cur_h[i]))
            pos = max_p + s
            if pos >= total - 1 or s == max_new - 1:
                break
            logits, cache = self.model.decode_step(params, cache,
                                                   cur[:, None], pos)
            cur = logits[:, -1].argmax(dim=-1)
            cur_h = cur.cpu().numpy()
        t2 = time.perf_counter()

        return [Completion(rid=r.rid, tokens=np.asarray(g, np.int32),
                           prefill_ms=(t1 - t0) * 1e3,
                           decode_ms=(t2 - t1) * 1e3, batch_size=B,
                           truncated=len(g) < r.max_new_tokens)
                for r, g in zip(rs, generated)]

    # -- continuous batching front end ----------------------------------------
    def form_batches(self, requests: Sequence[Request], *,
                     target_batch: int = 8, deadline: float = 0.05
                     ) -> List[List[Request]]:
        """Replay an arrival-ordered request stream through the paper's
        deadline policy (see :func:`form_batch_groups`)."""
        return form_batch_groups(requests, target_batch=target_batch,
                                 deadline=deadline)

    def _mct_feasible(self, rs: List[Request], encoded: np.ndarray,
                      owner: List[int]) -> List[bool]:
        """MCT filtering stage: all connection queries of the batch were
        encoded on the host into one kernel input; match on the engine's
        device, bring the decisions back with one copy, then drop requests
        with an infeasible connection (connect time < MCT)."""
        dec, _, _ = self.rule_filter.match(encoded)
        dec = dec.cpu().numpy()
        feasible = [True] * len(rs)
        pos = {i: 0 for i in range(len(rs))}
        for j, i in enumerate(owner):
            mct = int(dec[j])
            if mct < 0:
                mct = self.rule_filter.table.default_decision
            have = rs[i].connect_minutes[pos[i]] \
                if pos[i] < len(rs[i].connect_minutes) else 10 ** 6
            pos[i] += 1
            if have < mct:
                feasible[i] = False
        return feasible


def _tree_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
