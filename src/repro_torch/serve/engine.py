"""Serving engine: batched prefill + decode with the paper's batch-formation
policy driving request aggregation.

Port of ``repro.serve.engine``. The server's front end is the
DeadlineAggregator (target batch + SLA deadline), and the MCT rule engine
plugs in as a request-filtering stage ahead of the LM (the paper's Table 3
deployment: MCT plus route scoring on one accelerator).

A batch is split into a host-side **prepare** stage (token-matrix assembly
and MCT query encoding, numpy only) and a device-side **execute** stage
(rule matching on the engine's device, then the decode loop).

The prefill and the decode belong to the model: the execute stage opens a
batch on the device's decoder (``Model.decoder``, kept per device: it
yields the batch's decode cache and runs the steps, captured as CUDA
graphs where the model chooses to), has ``Model.prefill_prompts`` fill the
cache with the prompts (the model chooses how, and counts its passes and
the tokens they compute), then decodes from it. With a ``Tracer``
(``LMServer(tracer=)``, or the server's through ``build``) the execute
stage emits ``lm.filter``, ``lm.prefill`` and one ``lm.decode`` a step, on
shared clock readings so that they tile it; ``prefill_counts`` counts the
prefill's real and padded tokens, ``n_prefill_passes`` its passes,
``decode_counts`` the graph replays, eager steps and captures. A request
marked ``capture`` leaves its MCT answers and the float32 logits of every
step in ``LMServer.captured``.
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
    # keep this request's MCT answers and its float32 logits of every step
    # in LMServer.captured (for checks against a reference)
    capture: bool = False


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
    """Batched prefill + decode-loop serving for any decoder architecture of
    the registry.

    An encoder-only arch (``hubert-xlarge``) raises at construction: it has
    no decode step, and the reference's server would run its bidirectional
    layers as causal decode steps. ``params=None`` draws the parameters on ``device`` from a
    ``torch.Generator`` seeded with ``seed``, one tensor at a time.
    ``rule_filter`` is an optional ``ErbiumEngine`` (on its own device).
    ``tracer`` (a ``serve.trace.Tracer``, None: no span and no extra
    clock read) receives the execute stage's spans.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, device="cuda",
                 max_seq: int = 256, seed: int = 0, rule_filter=None,
                 tracer=None):
        if cfg.encoder_only:
            raise ValueError(
                f"{cfg.arch} is encoder-only: it has no decode step to serve")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, device=self.device)
        self.params = params
        self.max_seq = max_seq
        self.rule_filter = rule_filter
        self._dev_params: Dict[torch.device, object] = {}
        # the model's decoder of each device, kept across batches
        self._decoders: Dict[torch.device, object] = {}
        # replica workers call execute_prepared from their own threads: one
        # copy of the parameters and one decoder per device, never two
        self._params_lock = threading.Lock()
        self.tracer = tracer
        # prefill tokens computed: prompt tokens, and the padding beside
        # them (rows padded to the longest prompt of their pass); prefill
        # passes: the model's (``Model.prefill_prompts``)
        self._count_lock = threading.Lock()
        self.n_prefill_real = 0
        self.n_prefill_padded = 0
        self.n_prefill_passes = 0
        # decode steps replayed as a CUDA graph, and run eagerly
        self.n_decode_graph = 0
        self.n_decode_eager = 0
        self._n_batches = 0
        # rid -> {"mct": (decisions, weights, rule ids), "logits": (steps,
        # V) float32} of the requests marked ``capture``
        self.captured: Dict[int, dict] = {}

    def prefill_counts(self) -> tuple:
        """(real, padded) prefill tokens computed so far."""
        with self._count_lock:
            return self.n_prefill_real, self.n_prefill_padded

    def decode_counts(self) -> tuple:
        """(graph replays, eager steps, captures) of the decode so far."""
        with self._params_lock:
            captures = sum(d.n_captures for d in self._decoders.values())
        with self._count_lock:
            return self.n_decode_graph, self.n_decode_eager, captures

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
        tr = self.tracer
        t_open = time.perf_counter() if tr is not None else None
        with self._count_lock:
            self._n_batches += 1
            batch = self._n_batches
        toks, plens, max_new = pb.toks, pb.plens, pb.max_new
        if self.rule_filter is not None and pb.mct_encoded is not None:
            keep = self._mct_feasible(rs, pb.mct_encoded, pb.mct_owner)
            if tr is not None:
                t = time.perf_counter()
                tr.span("lm.filter", t_open, t, batch=batch,
                        queries=len(pb.mct_owner),
                        dropped=len(keep) - sum(keep))
                t_open = t
            if not all(keep):
                # slice the prepared rows: no host re-encode here
                idx = [i for i, ok in enumerate(keep) if ok]
                if not idx:
                    return []
                rs = [rs[i] for i in idx]
                toks = toks[idx]
                plens = [plens[i] for i in idx]
                max_new = max(r.max_new_tokens for r in rs)
        return self._run_decode(rs, toks, plens, max_new, device=device,
                                batch=batch, t_open=t_open)

    def generate_batch(self, requests: Sequence[Request]) -> List[Completion]:
        """prepare + execute in one synchronous call, with the MCT filter
        stage when the server has one."""
        if not requests:
            return []
        return self.execute_prepared(self.prepare_batch(requests))

    @torch.inference_mode()
    def warmup(self, batch_sizes: Sequence[int] = (1, 8), *,
               prompt_len: int = 4, max_new_tokens: int = 2) -> None:
        """Ready the server's device's decoder for the largest batch size
        (``warm``: a captured decoder keeps its cache and captures every
        row bucket up to it), then run each batch size once (allocator,
        library handles)."""
        self._decoder_on(self.device).warm(max(batch_sizes, default=0))
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

    def _decoder_on(self, device: torch.device):
        """The model's decoder of ``device``, made once and kept."""
        params = self._params_on(device)
        with self._params_lock:
            if device not in self._decoders:
                self._decoders[device] = self.model.decoder(
                    params, self.max_seq, device)
            return self._decoders[device]

    @torch.inference_mode()
    def _run_decode(self, rs: List[Request], toks: np.ndarray,
                    plens: List[int], max_new: int,
                    device=None, *, batch: int = 0,
                    t_open: Optional[float] = None) -> List[Completion]:
        """Prefill then decode ``rs`` (token rows ``toks`` padded on the
        right, prompt lengths ``plens``); the completions follow the order
        of ``rs``. ``batch`` and ``t_open`` (where the ``lm.prefill`` span
        starts) are the tracer's."""
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
        params = self._params_on(dev)
        dec = self._decoder_on(dev)
        n_graph = n_eager = 0
        with dec.batch(B) as cache:
            last_logits, passes, computed = self.model.prefill_prompts(
                params, cache, toks, plens)
            synchronize(dev)
            t1 = time.perf_counter()
            real = sum(plens)
            with self._count_lock:
                self.n_prefill_real += real
                self.n_prefill_padded += computed - real
                self.n_prefill_passes += passes

            cap = [i for i, r in enumerate(rs) if r.capture]
            caps = [last_logits[cap, -1].float()] if cap else []
            cur = last_logits[:, -1].argmax(dim=-1)
            cur_h = cur.cpu().numpy()
            tr = self.tracer
            if tr is not None:
                t_prev = time.perf_counter()
                tr.span("lm.prefill", t0 if t_open is None else t_open,
                        t_prev, batch=batch, rows=B, real_tokens=real,
                        padded_tokens=computed - real, lens=plens,
                        passes=passes)
            generated = [[] for _ in range(B)]
            for s in range(max_new):
                for i in range(B):
                    if s < rs[i].max_new_tokens:
                        generated[i].append(int(cur_h[i]))
                pos = max_p + s
                if pos >= total - 1 or s == max_new - 1:
                    break
                # logits and cur are the decoder's: the next step may
                # overwrite them (the captures below index out copies)
                logits, cur, graph = dec.step(cache, cur, pos)
                if graph:
                    n_graph += 1
                else:
                    n_eager += 1
                if cap:
                    caps.append(logits[cap, -1].float())
                cur_h = cur.cpu().numpy()
                if tr is not None:
                    t = time.perf_counter()
                    tr.span("lm.decode", t_prev, t, batch=batch, rows=B,
                            pos=pos, graph=graph)
                    t_prev = t
        t2 = time.perf_counter()
        with self._count_lock:
            self.n_decode_graph += n_graph
            self.n_decode_eager += n_eager
        if cap:
            got = torch.stack(caps, dim=1).cpu().numpy()
            with self._count_lock:
                for k, i in enumerate(cap):
                    self.captured.setdefault(rs[i].rid, {})["logits"] = \
                        got[k]

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
        dec, w, rid = self.rule_filter.match(encoded)
        dec = dec.cpu().numpy()
        cap = [i for i, r in enumerate(rs) if r.capture]
        if cap:
            w, rid = w.cpu().numpy(), rid.cpu().numpy()
            own = np.asarray(owner)
            with self._count_lock:
                for i in cap:
                    j = own == i
                    self.captured.setdefault(rs[i].rid, {})["mct"] = \
                        (dec[j].copy(), w[j].copy(), rid[j].copy())
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
