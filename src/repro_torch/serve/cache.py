"""Content-addressed result cache + in-flight request coalescing.

The paper's central serving finding (§5–6) — and what PR 2's replica sweep
reproduced — is that the *serial host prepare path* caps aggregate
throughput no matter how many accelerator replicas sit behind it. Travel-
search traffic is highly repetitive (the same origin/destination/date
query recurs within seconds), so the highest-leverage fix is to stop
re-encoding and re-executing identical work at all: the caching-near-the-
accelerator pattern that "Data Processing with FPGAs on Modern
Architectures" identifies as key to cost-effective deployments. Two
mechanisms, both content-addressed by :func:`request_key` (a canonical
hash of everything that determines a request's result — prompt tokens,
decode budget, MCT queries + connect times; never the rid or arrival
time):

- :class:`ResultCache` — completed results, TTL + byte-bounded LRU.
  A hit costs zero host encode and zero device time. Fully deterministic:
  eviction is strict LRU over insertion/touch order and TTL expiry is
  judged against the caller's clock (logical replay time in
  ``Server.serve``, pipeline time in ``AsyncScheduler``), so a seeded run
  always produces the same hit/miss/eviction sequence.
- :class:`Coalescer` — single-flight dedup of identical *concurrent*
  requests ahead of admission: the first request with a given key is the
  **leader** and flows through the pipeline; identical requests that
  arrive while it is in flight become **followers** that subscribe to its
  completion. Followers never occupy admission-queue space, so they can
  never be rejected, blocked, or shed independently of their leader — if
  the leader is shed (``shed_oldest``) or MCT-filtered, its followers are
  dropped with it, atomically.

Because every engine replica serves the same model and results are pure
functions of request content, a minted cache/coalesce completion is
bit-identical (tokens, truncated flag) to what re-executing the request
would have produced — which is what lets measured throughput climb
*above* the serial-host prepare cap without breaking the serving stack's
bit-identity guarantee.

Port of ``repro.serve.cache``.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.serve.config import Coercible
from repro_torch.serve.engine import Completion, Request

# accounting overhead per entry (key, OrderedDict slot, dataclass) so a
# cache full of tiny completions still has a meaningful byte bound
_ENTRY_OVERHEAD = 96


def request_key(req: Request) -> str:
    """Canonical content hash of a request: everything that determines its
    result (prompt tokens, decode budget, MCT queries, connect times) and
    nothing that doesn't (rid, arrival time). Two requests with equal keys
    are interchangeable — the cache/coalescer substitutes one's result for
    the other's."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(np.asarray(req.tokens, np.int64)).tobytes())
    h.update(int(req.max_new_tokens).to_bytes(8, "little", signed=True))
    for q in req.mct_queries:
        for k in sorted(q):
            h.update(str(k).encode())
            h.update(int(q[k]).to_bytes(8, "little", signed=True))
        h.update(b";")
    for m in req.connect_minutes:
        h.update(int(m).to_bytes(8, "little", signed=True))
    return h.hexdigest()


@dataclass
class CacheConfig(Coercible):
    """Serving-layer result cache knobs (attach to ``ServeConfig.cache``
    / ``SchedulerConfig.cache``; ``None`` keeps caching fully off and the
    serving stack bit-identical to its uncached behavior).

    ``max_bytes``       — resident-size bound; strict LRU eviction above it.
    ``ttl``             — seconds (in the caller's clock) before an entry
                          goes stale; ``None`` disables expiry.
    ``coalesce``        — single-flight dedup of identical in-flight
                          requests.
    ``negative_ttl``    — seconds to remember that a content key was
                          MCT-*filtered* (dropped by the engine without a
                          completion), so the same doomed content doesn't
                          re-encode and re-execute on its next arrival;
                          ``None`` disables negative caching.
    ``promote_on_shed`` — when ``shed_oldest`` evicts a coalescing leader,
                          promote its first follower to leader so the
                          flight survives and only one request's worth of
                          work is shed.
    ``max_affinity``    — bound on the replica-affinity tombstone map:
                          when a TTL-expired entry is evicted, the replica
                          that produced it survives as a tombstone hint so
                          ``hit_aware`` routing can send the recompute back
                          to the owning replica (0 disables tombstones).
    """
    max_bytes: int = 64 << 20
    ttl: Optional[float] = None
    coalesce: bool = True
    negative_ttl: Optional[float] = None
    promote_on_shed: bool = True
    max_affinity: int = 4096


@dataclass
class CachedResult:
    """One cached completion payload: the content-determined fields only
    (tokens, truncated, the batch size it was produced at), plus the
    replica that produced it (per-replica hit-rate accounting) and the
    byte/TTL accounting."""
    tokens: np.ndarray
    truncated: bool
    batch_size: int
    replica: Optional[int]
    stored_at: float
    nbytes: int

    @classmethod
    def of(cls, comp: Completion, *, replica: Optional[int] = None,
           now: float = 0.0) -> "CachedResult":
        toks = np.array(comp.tokens, np.int32, copy=True)
        return cls(tokens=toks, truncated=comp.truncated,
                   batch_size=comp.batch_size, replica=replica,
                   stored_at=now, nbytes=int(toks.nbytes) + _ENTRY_OVERHEAD)

    def mint(self, rid: int) -> Completion:
        """A completion for ``rid`` served from this entry: zero host
        encode, zero device time (prefill/decode report 0 ms)."""
        return Completion(rid=rid, tokens=self.tokens.copy(),
                          prefill_ms=0.0, decode_ms=0.0,
                          batch_size=self.batch_size,
                          truncated=self.truncated)


@dataclass
class NegativeResult:
    """A remembered *filtered* verdict: the engine's MCT feasibility check
    dropped this content without producing a completion, so re-submitting
    the same content within ``negative_ttl`` is doomed — the scheduler
    drops it at submit time, spending zero queue space, host encode, or
    device time. Lives in the same LRU as positive entries (a later real
    ``put`` under the key replaces it)."""
    stored_at: float
    nbytes: int = _ENTRY_OVERHEAD


class ResultCache:
    """Thread-safe content-addressed completion cache with TTL + strict
    byte-bounded LRU eviction. Shared across replicas (one instance per
    ``Server``, visible to every session and serve() call), so a result
    computed on any replica serves hits for all of them.

    The optional ``metrics`` argument on :meth:`get`/:meth:`put` forwards
    stale/eviction/bytes-resident events to that run's
    ``MetricsCollector``; the optional ``tracer``/``rid`` pair likewise
    emits ``cache_lookup``/``cache_store`` marks into that run's
    :class:`~repro_torch.serve.trace.Tracer`. The cache also keeps its own
    lifetime :meth:`stats` since one cache may outlive many sessions.
    """

    def __init__(self, config: Union[None, bool, dict, CacheConfig] = None):
        self.cfg = CacheConfig.coerce(config) or CacheConfig()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, CachedResult]" = OrderedDict()
        # replica-affinity tombstones: key -> replica that produced the
        # (since-expired) entry. A TTL expiry is not amnesia about *where*
        # the content lived — hit_aware routing reads these to send the
        # recompute back to the owning replica (LRU-bounded separately
        # from the byte budget; entries are two machine words)
        self._affinity: "OrderedDict[str, int]" = OrderedDict()
        self.bytes_resident = 0
        self._counts = {"hits": 0, "misses": 0, "stale": 0,
                        "evictions": 0, "stores": 0,
                        "negative_hits": 0, "negative_stores": 0,
                        "affinity_rehomes": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: str, now: float, *, metrics=None, tracer=None,
            rid=None) -> Union[None, CachedResult, NegativeResult]:
        """Look up ``key`` at time ``now`` (caller's clock). Returns the
        entry (touching its LRU position) or None on miss/TTL expiry; a
        :class:`NegativeResult` means the content is known-filtered (its
        TTL is ``negative_ttl``). Misses are counted internally only — the
        caller decides whether a miss turns into an admitted leader (see
        AsyncScheduler.submit)."""
        outcome = None
        try:
            with self._lock:
                e = self._entries.get(key)
                if e is None:
                    self._counts["misses"] += 1
                    outcome = "miss"
                    return None
                negative = isinstance(e, NegativeResult)
                ttl = self.cfg.negative_ttl if negative else self.cfg.ttl
                if ttl is not None and now - e.stored_at > ttl:
                    del self._entries[key]
                    self.bytes_resident -= e.nbytes
                    self._counts["stale"] += 1
                    outcome = "stale"
                    if not negative and e.replica is not None:
                        # the result is stale but its *placement* is not:
                        # leave a tombstone so the recompute can be routed
                        # back to the replica that produced it
                        self._remember_affinity_locked(key, e.replica)
                    if metrics is not None:
                        metrics.on_cache("stale")
                        metrics.note_cache_bytes(self.bytes_resident,
                                                 len(self._entries))
                    return None
                self._entries.move_to_end(key)
                self._counts["negative_hits" if negative else "hits"] += 1
                outcome = "negative_hit" if negative else "hit"
                return e
        finally:
            if tracer is not None:
                tracer.mark("cache_lookup", now, rid=rid, outcome=outcome)

    def put(self, key: str, entry: CachedResult, *, metrics=None,
            tracer=None, rid=None) -> None:
        """Insert/replace ``key``, then evict strictly-LRU until the byte
        bound holds (an entry larger than ``max_bytes`` evicts itself)."""
        if tracer is not None:
            tracer.mark("cache_store", entry.stored_at, rid=rid)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_resident -= old.nbytes
            # a live entry is the authoritative owner record; any stale
            # tombstone for the key would shadow it after the next expiry
            self._affinity.pop(key, None)
            self._entries[key] = entry
            self.bytes_resident += entry.nbytes
            self._counts["stores"] += 1
            evicted = 0
            while self.bytes_resident > self.cfg.max_bytes and self._entries:
                _, e = self._entries.popitem(last=False)
                self.bytes_resident -= e.nbytes
                evicted += 1
            if evicted:
                self._counts["evictions"] += evicted
            if metrics is not None:
                if evicted:
                    metrics.on_cache("evictions", evicted)
                metrics.note_cache_bytes(self.bytes_resident,
                                         len(self._entries))

    def put_negative(self, key: str, now: float, *, metrics=None,
                     tracer=None, rid=None) -> bool:
        """Remember that ``key`` was MCT-filtered. No-op (returns False)
        unless ``negative_ttl`` is configured; shares the LRU/byte bound
        with positive entries."""
        if self.cfg.negative_ttl is None:
            return False
        if tracer is not None:
            tracer.mark("cache_store", now, rid=rid, negative=True)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_resident -= old.nbytes
            e = NegativeResult(stored_at=now)
            self._entries[key] = e
            self.bytes_resident += e.nbytes
            self._counts["negative_stores"] += 1
            evicted = 0
            while self.bytes_resident > self.cfg.max_bytes and self._entries:
                _, old = self._entries.popitem(last=False)
                self.bytes_resident -= old.nbytes
                evicted += 1
            if evicted:
                self._counts["evictions"] += evicted
            if metrics is not None:
                metrics.on_cache("negative_stores")
                if evicted:
                    metrics.on_cache("evictions", evicted)
                metrics.note_cache_bytes(self.bytes_resident,
                                         len(self._entries))
        return True

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    # -- replica affinity (hit_aware routing) --------------------------------
    def _remember_affinity_locked(self, key: str, replica: int) -> None:
        self._affinity.pop(key, None)
        self._affinity[key] = int(replica)
        while len(self._affinity) > max(0, self.cfg.max_affinity):
            self._affinity.popitem(last=False)

    def owner_hint(self, key: str) -> Optional[int]:
        """The replica whose result last covered ``key``: a live entry's
        producer, else the tombstone left behind by its TTL expiry. Pure
        lookup — never counts as a hit/miss, never touches LRU order (a
        routing probe must not keep an entry artificially fresh)."""
        with self._lock:
            e = self._entries.get(key)
            if isinstance(e, CachedResult) and e.replica is not None:
                return e.replica
            return self._affinity.get(key)

    def rehome(self, key: str, replica: int) -> None:
        """Move ``key``'s affinity to ``replica`` — called when hit_aware
        routing *spills* away from a straggling/overloaded owner, so
        subsequent recomputes of the same content follow the work to its
        new home instead of hammering the old one."""
        with self._lock:
            self._counts["affinity_rehomes"] += 1
            self._remember_affinity_locked(key, replica)

    def stats(self) -> Dict[str, int]:
        """Lifetime counters (across every session sharing this cache)."""
        with self._lock:
            return dict(self._counts, bytes_resident=self.bytes_resident,
                        entries=len(self._entries),
                        affinity_entries=len(self._affinity))


class Coalescer:
    """Single-flight table for identical concurrent requests.

    ``claim(key, rid)`` marks an admitted request as the in-flight leader
    for its content key; ``attach(key, req)`` registers a later identical
    request as a follower of that leader (returns the leader rid, or None
    when nothing is in flight / coalescing is disabled — the caller then
    admits it normally). ``resolve(rid)`` / ``fail(rid)`` retire a leader
    on completion / shed-or-drop, handing back its followers so the
    scheduler can mint their completions or drop them *with* the leader.

    With ``enabled=False`` the table still tracks rid -> key so completed
    leaders can fill the :class:`ResultCache`, but never coalesces.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._flights: Dict[str, Tuple[int, List[Request]]] = {}
        self._key_of: Dict[int, str] = {}

    def attach(self, key: str, req: Request) -> Optional[int]:
        if not self.enabled:
            return None
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                return None
            flight[1].append(req)
            return flight[0]

    def claim(self, key: str, rid: int) -> None:
        with self._lock:
            self._key_of[rid] = key
            if self.enabled and key not in self._flights:
                self._flights[key] = (rid, [])

    def _retire(self, rid: int) -> Tuple[Optional[str], List[Request]]:
        with self._lock:
            key = self._key_of.pop(rid, None)
            if key is None:
                return None, []
            flight = self._flights.get(key)
            if flight is not None and flight[0] == rid:
                del self._flights[key]
                return key, flight[1]
            return key, []

    def resolve(self, rid: int) -> Tuple[Optional[str], List[Request]]:
        """Leader ``rid`` completed: returns (key, followers to mint)."""
        return self._retire(rid)

    def fail(self, rid: int) -> Tuple[Optional[str], List[Request]]:
        """Leader ``rid`` was shed/dropped: returns (key, followers to
        drop with it). The key is released so the next identical request
        becomes a fresh leader."""
        return self._retire(rid)

    def promote(self, rid: int) -> Optional[Request]:
        """Leader ``rid`` is about to be shed: promote its first follower
        to flight leader so the flight survives and only the old leader's
        single request is lost. Returns the promoted :class:`Request`
        (the caller re-admits it in the shed leader's place) or None when
        ``rid`` leads no flight / has no followers (the caller then sheds
        the whole flight via :meth:`fail`)."""
        with self._lock:
            key = self._key_of.get(rid)
            if key is None:
                return None
            flight = self._flights.get(key)
            if flight is None or flight[0] != rid or not flight[1]:
                return None
            followers = flight[1]
            promoted = followers.pop(0)
            self._flights[key] = (promoted.rid, followers)
            self._key_of[promoted.rid] = key
            del self._key_of[rid]
            return promoted

    def in_flight(self) -> int:
        with self._lock:
            return len(self._flights)
