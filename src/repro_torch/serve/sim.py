"""Simulated serving engine for host-device balance studies.

``SimServer`` implements the same prepare/execute protocol as ``LMServer``
but spends *wall-clock sleep* instead of FLOPs: host prepare costs
``host_ms_per_batch + host_ms_per_request * B`` on the calling (dispatcher)
thread, device execute costs ``device_ms_per_batch + device_ms_per_token *
B * max_new`` on the replica worker thread. Sleeps release the GIL, so
replica pipelines genuinely overlap — which is the point: with R replicas
behind one admission path, aggregate throughput scales with R until the
*serial host prepare path* saturates, and the CPU-bound plateau the paper
predicts (§5–6) emerges from real thread timing, not from arithmetic.

Used by ``benchmarks/fig13_endtoend.py --replicas`` (host-device
simulation sweep) and the replica-routing tests, where real accelerators
per replica aren't available in the container.

Outputs are deterministic functions of the request's *content* (prompt
tokens + decode budget — never the rid), so bit-identity checks work
across replica counts and routing policies, and a cached result minted
for one rid is exactly what re-executing a content-equal request under a
different rid would have produced.

Port of ``repro.serve.sim``.
"""
from __future__ import annotations

import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serve.engine import Completion, Request


@dataclass
class SimPreparedBatch:
    """Host-side half of a simulated batch (mirrors ``PreparedBatch`` in
    the fields the pipeline layer touches)."""
    requests: List[Request]
    max_new: int


@dataclass(frozen=True)
class SimProfile:
    """A named host/device speed ratio — one of the paper's box shapes.

    The paper's Tables 2–3 argue the FPGA deployment's economics hinge on
    this ratio: an f1.2xlarge-style box (8 vCPUs feeding a big FPGA) is
    host-bound, a c5.12xlarge-style box (48 vCPUs) is balanced. These
    profiles reproduce both regimes (plus the inverse) in ``SimServer``
    milliseconds, so the capacity subsystem can be exercised against each
    without hand-picking sleep times."""
    name: str
    host_ms_per_batch: float
    host_ms_per_request: float
    device_ms_per_batch: float
    device_ms_per_token: float


SIM_PROFILES = {
    # weak 8-vCPU host feeding fast accelerators: the paper's imbalanced
    # cloud box — serial host prepare saturates long before the devices
    "weak_host": SimProfile("weak_host", 4.0, 0.25, 2.0, 0.0),
    # 48-vCPU host, device does real work per batch: neither side idles
    # grossly at moderate load
    "balanced": SimProfile("balanced", 1.0, 0.02, 6.0, 0.0),
    # fast host, slow accelerator: device-bound (more replicas help)
    "weak_device": SimProfile("weak_device", 0.5, 0.0, 12.0, 0.5),
}


@dataclass
class SimServer:
    """LMServer-compatible engine with dialable host/device costs.

    Warm-content model (``warm_factor < 1``): each instance remembers the
    last ``warm_keys`` content keys it executed; re-executing one of them
    costs ``warm_factor`` of the cold per-request device cost — the
    accelerator-local warm state (resident rule tables, primed buffers)
    that makes recomputing expired content cheaper *on the replica that
    produced it*. With per-replica SimServer instances this is exactly the
    placement signal hit-aware routing exploits; ``warm_factor=1.0``
    (default) disables the model and keeps costs purely size-driven.
    Tokens remain content-pure either way — warmth changes *time*, never
    *bits*."""
    vocab: int = 256
    host_ms_per_batch: float = 1.0
    host_ms_per_request: float = 0.0
    device_ms_per_batch: float = 4.0
    device_ms_per_token: float = 0.0
    warm_factor: float = 1.0
    warm_keys: int = 512
    sleep: object = field(default=time.sleep, repr=False)
    _warm: "OrderedDict" = field(default_factory=OrderedDict, init=False,
                                 repr=False)

    @classmethod
    def from_profile(cls, profile, **overrides) -> "SimServer":
        """Build from a :class:`SimProfile` or a ``SIM_PROFILES`` name."""
        if isinstance(profile, str):
            profile = SIM_PROFILES[profile]
        kw = dict(host_ms_per_batch=profile.host_ms_per_batch,
                  host_ms_per_request=profile.host_ms_per_request,
                  device_ms_per_batch=profile.device_ms_per_batch,
                  device_ms_per_token=profile.device_ms_per_token)
        kw.update(overrides)
        return cls(**kw)

    # -- host-side prepare stage --------------------------------------------
    def prepare_batch(self, requests: Sequence[Request]) -> SimPreparedBatch:
        rs = list(requests)
        cost = (self.host_ms_per_batch
                + self.host_ms_per_request * len(rs)) * 1e-3
        if cost > 0:
            self.sleep(cost)
        return SimPreparedBatch(
            requests=rs,
            max_new=max((r.max_new_tokens for r in rs), default=0))

    # -- device-side execute stage ------------------------------------------
    def execute_prepared(self, pb: SimPreparedBatch, *,
                         device=None) -> List[Completion]:
        rs = pb.requests
        if not rs:
            return []
        per_req = self.device_ms_per_token * pb.max_new
        if self.warm_factor < 1.0:
            # warm rows run at a discount; every executed row (re)warms
            # its content key. _warm is touched only from this instance's
            # replica worker thread, so no lock is needed
            keys = [self._content_key(r) for r in rs]
            n_warm = sum(1 for k in keys if k in self._warm)
            row_cost = per_req * (len(rs) - n_warm
                                  + n_warm * self.warm_factor)
            for k in keys:
                self._warm.pop(k, None)
                self._warm[k] = True
            while len(self._warm) > max(1, self.warm_keys):
                self._warm.popitem(last=False)
        else:
            row_cost = per_req * len(rs)
        cost = (self.device_ms_per_batch + row_cost) * 1e-3
        if cost > 0:
            self.sleep(cost)
        return [Completion(rid=r.rid,
                           tokens=self._tokens(r),
                           prefill_ms=0.0,
                           decode_ms=cost * 1e3,
                           batch_size=len(rs))
                for r in rs]

    def generate_batch(self, requests: Sequence[Request]) -> List[Completion]:
        if not requests:
            return []
        return self.execute_prepared(self.prepare_batch(requests))

    def _content_key(self, r: Request) -> tuple:
        # same content notion as cache.request_key (tokens + decode
        # budget), cheap enough to compute per executed row
        return (zlib.crc32(np.ascontiguousarray(
            np.asarray(r.tokens, np.int64)).tobytes()),
            int(r.max_new_tokens))

    def _tokens(self, r: Request) -> np.ndarray:
        # deterministic in the request's CONTENT alone (never the rid):
        # identical across replicas, routing policies, batch compositions,
        # and rid renumbering — the bit-identity anchor that also makes
        # result-cache substitution exact for content-equal requests
        n = r.max_new_tokens
        base = zlib.crc32(
            np.ascontiguousarray(np.asarray(r.tokens, np.int64)).tobytes())
        return ((int(base) * 1009 + n * 131
                 + np.arange(n, dtype=np.int64) * 31 + 7)
                % self.vocab).astype(np.int32)


def sim_requests(n: int, *, max_new_tokens: int = 4, prompt_len: int = 8,
                 arrivals: Optional[np.ndarray] = None,
                 rid_base: int = 0, vocab: int = 256,
                 skew: Optional[Sequence[int]] = None,
                 unique_keys: int = 0, repeat_alpha: float = 0.0,
                 content_seed: Optional[int] = None) -> List[Request]:
    """Deterministic request stream for simulation runs.

    ``skew`` cycles per-request decode lengths (e.g. ``(16, 1)`` alternates
    heavy/light). ``unique_keys``/``repeat_alpha`` switch to repeat-heavy
    traffic: contents drawn from ``unique_keys`` prototypes under
    Zipf(``repeat_alpha``) popularity (cache studies). ``content_seed``
    pins the content RNG independently of ``rid_base`` so a second wave of
    fresh rids can replay the *same* key population (defaults to
    ``rid_base + 7``, the original behavior).
    """
    rng = np.random.default_rng(content_seed if content_seed is not None
                                else rid_base + 7)
    protos: Optional[List[np.ndarray]] = None
    choice: Optional[np.ndarray] = None
    if unique_keys > 0:
        from repro_torch.serve.loadgen import zipf_probs
        protos = [rng.integers(1, vocab, prompt_len).astype(np.int32)
                  for _ in range(unique_keys)]
        choice = rng.choice(unique_keys, size=n,
                            p=zipf_probs(unique_keys, repeat_alpha))
    out = []
    for i in range(n):
        # in prototype mode, decode length follows the prototype (not the
        # stream position) so content-equal requests stay cache-equal
        j = int(choice[i]) if choice is not None else i
        mn = skew[j % len(skew)] if skew else max_new_tokens
        toks = protos[j].copy() if protos is not None \
            else rng.integers(1, vocab, prompt_len).astype(np.int32)
        out.append(Request(
            rid=rid_base + i,
            tokens=toks,
            max_new_tokens=int(mn),
            arrival=float(arrivals[i]) if arrivals is not None else 0.0))
    return out
