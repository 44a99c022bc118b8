"""Serving metrics: per-request latency breakdown + device utilisation.

The paper's key end-to-end signal (§5–6) is *imbalance*: the accelerator
only pays off when the host can keep it fed, so the numbers that matter are
(a) where each request's latency goes — queue wait vs host encode vs device
execution vs drain — and (b) what fraction of the run the device sat idle.
``MetricsCollector`` is thread-safe and shared by the synchronous baseline,
the pipelined executor, and the live async scheduler, so all three report
comparable numbers.

Port of ``repro.serve.metrics``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class RequestTrace:
    rid: int
    arrival: Optional[float] = None
    admitted: Optional[float] = None
    encode_start: Optional[float] = None
    encode_end: Optional[float] = None
    device_start: Optional[float] = None
    device_end: Optional[float] = None
    completed: Optional[float] = None
    rejected: bool = False
    shed: bool = False
    replica: Optional[int] = None     # which replica executed it
    cache_hit: bool = False           # served from the result cache
    coalesced: bool = False           # follower of an in-flight leader

    def _ms(self, a: Optional[float], b: Optional[float]) -> Optional[float]:
        return (b - a) * 1e3 if a is not None and b is not None else None

    @property
    def queue_wait_ms(self):
        return self._ms(self.arrival if self.arrival is not None
                        else self.admitted, self.encode_start)

    @property
    def encode_ms(self):
        return self._ms(self.encode_start, self.encode_end)

    @property
    def device_ms(self):
        return self._ms(self.device_start, self.device_end)

    @property
    def drain_ms(self):
        return self._ms(self.device_end, self.completed)

    @property
    def total_ms(self):
        return self._ms(self.arrival if self.arrival is not None
                        else self.admitted, self.completed)


@dataclass
class LatencyStats:
    n: int
    mean_ms: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float

    @classmethod
    def of(cls, values_ms: List[float]) -> "LatencyStats":
        if not values_ms:
            return cls(0, 0.0, 0.0, 0.0, 0.0, 0.0)
        v = np.asarray(values_ms, np.float64)
        return cls(n=len(values_ms), mean_ms=float(v.mean()),
                   p50_ms=float(np.percentile(v, 50)),
                   p95_ms=float(np.percentile(v, 95)),
                   p99_ms=float(np.percentile(v, 99)),
                   max_ms=float(v.max()))

    def as_dict(self) -> Dict[str, float]:
        return {"n": self.n, "mean_ms": self.mean_ms, "p50_ms": self.p50_ms,
                "p95_ms": self.p95_ms, "p99_ms": self.p99_ms,
                "max_ms": self.max_ms}


def _merged_span(intervals: List[Tuple[float, float]]) -> float:
    """Total covered time of possibly-overlapping intervals (overlap happens
    with multi-device round-robin execution)."""
    if not intervals:
        return 0.0
    out = 0.0
    cur_a, cur_b = None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                out += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    out += cur_b - cur_a
    return out


@dataclass(frozen=True)
class SignalSnapshot:
    """Cumulative totals at one instant — the capacity subsystem diffs two
    of these to get window rates (``CapacitySignals.between``). Totals
    only; no derived rates, so diffing is exact and lock-free."""
    t: float
    n_arrivals: int
    n_completions: int
    n_rejected: int
    n_shed: int
    n_encoded_batches: int
    encode_busy_s: float          # serial host-prepare time (batcher thread)
    device_busy_s: float          # summed across replicas (not merged)
    cache_hits: int
    cache_misses: int
    cache_coalesced: int


@dataclass
class ReplicaStats:
    """Per-replica serving statistics (the sharded-serving view: which
    replicas did the work, how idle each sat, how deep its pipeline ran)."""
    replica: int
    n_batches: int
    n_requests: int
    busy_s: float
    idle_fraction: float
    max_pipeline_depth: int       # prepared batches queued in its handoff
    max_outstanding_work: int     # routing's work-unit view at dispatch
    cache_hits: int = 0           # hits served from results this replica made
    cache_hit_rate: float = 0.0   # hits / (hits + requests it executed)

    def as_dict(self) -> Dict[str, object]:
        return {"replica": self.replica, "n_batches": self.n_batches,
                "n_requests": self.n_requests, "busy_s": self.busy_s,
                "idle_fraction": self.idle_fraction,
                "max_pipeline_depth": self.max_pipeline_depth,
                "max_outstanding_work": self.max_outstanding_work,
                "cache_hits": self.cache_hits,
                "cache_hit_rate": self.cache_hit_rate}


@dataclass
class RunReport:
    n_requests: int
    n_completed: int
    n_rejected: int
    n_shed: int
    offered_qps: Optional[float]
    achieved_qps: float
    span_s: float
    device_busy_s: float
    device_idle_fraction: float
    max_queue_depth: int
    batch_sizes: List[int]
    breakdown: Dict[str, LatencyStats]
    per_replica: Dict[int, ReplicaStats] = field(default_factory=dict)
    routing: Dict[str, int] = field(default_factory=dict)
    # result-cache counters (empty dict when no cache was configured):
    # hits/misses/coalesced/evictions/stale/follower_drops, bytes_resident,
    # entries, hit_rate = (hits+coalesced)/(hits+misses+coalesced), plus
    # negative_hits/negative_stores and leader_promotions when those
    # features fire
    cache: Dict[str, object] = field(default_factory=dict)
    # capacity-controller view (empty dict when capacity=None): diagnosis,
    # diagnosis history, controller actions, final knob values,
    # mean_active_replicas
    capacity: Dict[str, object] = field(default_factory=dict)

    @property
    def affinity_hits(self) -> int:
        """Batches hit_aware routed to their content's owning replica."""
        return self.routing.get("affinity_hit", 0)

    @property
    def affinity_spills(self) -> int:
        """Batches whose owner preference was overridden (straggler or
        outstanding-work gap) and whose keys were re-homed."""
        return self.routing.get("affinity_spill", 0)

    def as_dict(self) -> Dict[str, object]:
        return {
            "n_requests": self.n_requests,
            "n_completed": self.n_completed,
            "n_rejected": self.n_rejected,
            "n_shed": self.n_shed,
            "offered_qps": self.offered_qps,
            "achieved_qps": self.achieved_qps,
            "span_s": self.span_s,
            "device_busy_s": self.device_busy_s,
            "device_idle_fraction": self.device_idle_fraction,
            "max_queue_depth": self.max_queue_depth,
            "mean_batch": float(np.mean(self.batch_sizes))
            if self.batch_sizes else 0.0,
            "breakdown": {k: v.as_dict() for k, v in self.breakdown.items()},
            "per_replica": {k: v.as_dict()
                            for k, v in sorted(self.per_replica.items())},
            "routing": dict(self.routing),
            "cache": dict(self.cache),
            "capacity": dict(self.capacity),
        }

    def summary(self) -> str:
        t = self.breakdown.get("total")
        return (f"{self.n_completed}/{self.n_requests} done "
                f"({self.n_rejected} rejected, {self.n_shed} shed) "
                f"achieved {self.achieved_qps:.1f} q/s"
                + (f" of offered {self.offered_qps:.1f}"
                   if self.offered_qps else "")
                + f", device idle {self.device_idle_fraction * 100:.0f}%"
                + (f" over {len(self.per_replica)} replicas"
                   if len(self.per_replica) > 1 else "")
                + (f", cache hit {self.cache['hit_rate'] * 100:.0f}%"
                   if self.cache else "")
                + (f", affinity {self.affinity_hits} hit"
                   f"/{self.affinity_spills} spill"
                   if self.affinity_hits or self.affinity_spills else "")
                + (f", diagnosed {self.capacity['diagnosis']}"
                   if self.capacity.get("diagnosis") else "")
                + (f", p50/p95/p99 {t.p50_ms:.0f}/{t.p95_ms:.0f}/"
                   f"{t.p99_ms:.0f} ms" if t and t.n else ""))


class MetricsCollector:
    """Thread-safe event sink for the serving pipeline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._traces: Dict[int, RequestTrace] = {}
        self._device_busy: List[Tuple[float, float]] = []
        self._batch_sizes: List[int] = []
        self.max_queue_depth = 0
        # sharded-serving state: per-replica busy intervals / load counters
        # and routing-decision counts (reason -> n)
        self._replica_busy: Dict[int, List[Tuple[float, float]]] = {}
        self._replica_batches: Dict[int, int] = {}
        self._replica_requests: Dict[int, int] = {}
        self._replica_max_depth: Dict[int, int] = {}
        self._replica_max_work: Dict[int, int] = {}
        self._routing: Dict[str, int] = {}
        # result-cache state: event counters, resident-size snapshot, and
        # per-replica hit attribution (hits credited to the replica that
        # produced the cached entry)
        self._cache_counts: Dict[str, int] = {}
        self._cache_bytes = 0
        self._cache_entries = 0
        self._cache_seen = False
        self._replica_cache_hits: Dict[int, int] = {}
        # capacity-subsystem state: cumulative totals for window diffing
        # (SignalSnapshot) + the controller-action log
        self._n_arrivals = 0
        self._n_completions = 0
        self._n_rejected = 0
        self._n_shed = 0
        self._n_encoded_batches = 0
        self._encode_busy_s = 0.0
        self._device_busy_total_s = 0.0
        self._capacity_log: List[Dict[str, object]] = []

    def _t(self, rid: int) -> RequestTrace:
        tr = self._traces.get(rid)
        if tr is None:
            tr = self._traces[rid] = RequestTrace(rid)
        return tr

    # -- event hooks (called from submitter / batcher / device threads) ------
    def on_arrival(self, rid: int, t: float):
        with self._lock:
            self._t(rid).arrival = t
            self._n_arrivals += 1

    def on_admit(self, rid: int, t: float):
        with self._lock:
            tr = self._t(rid)
            tr.admitted = t
            if tr.arrival is None:
                tr.arrival = t

    def on_reject(self, rid: int, t: float):
        with self._lock:
            tr = self._t(rid)
            tr.rejected = True
            self._n_rejected += 1
            if tr.arrival is None:
                tr.arrival = t

    def on_shed(self, rid: int, t: float):
        with self._lock:
            self._t(rid).shed = True
            self._n_shed += 1

    def on_encode(self, rids: List[int], t0: float, t1: float):
        with self._lock:
            self._n_encoded_batches += 1
            self._encode_busy_s += max(0.0, t1 - t0)
            for rid in rids:
                tr = self._t(rid)
                tr.encode_start, tr.encode_end = t0, t1
                if tr.arrival is None:
                    tr.arrival = t0

    def on_device(self, rids: List[int], t0: float, t1: float,
                  replica: Optional[int] = None):
        with self._lock:
            self._device_busy.append((t0, t1))
            self._device_busy_total_s += max(0.0, t1 - t0)
            self._batch_sizes.append(len(rids))
            if replica is not None:
                self._replica_busy.setdefault(replica, []).append((t0, t1))
                self._replica_batches[replica] = \
                    self._replica_batches.get(replica, 0) + 1
                self._replica_requests[replica] = \
                    self._replica_requests.get(replica, 0) + len(rids)
            for rid in rids:
                tr = self._t(rid)
                tr.device_start, tr.device_end = t0, t1
                if replica is not None:
                    tr.replica = replica

    def on_complete(self, rids: List[int], t: float):
        with self._lock:
            self._n_completions += len(rids)
            for rid in rids:
                self._t(rid).completed = t

    # -- capacity-subsystem hooks -------------------------------------------
    def snapshot(self, now: float) -> SignalSnapshot:
        """Cumulative totals at ``now`` — the capacity controller diffs two
        of these into one sliding window of rates."""
        with self._lock:
            g = self._cache_counts.get
            return SignalSnapshot(
                t=now,
                n_arrivals=self._n_arrivals,
                n_completions=self._n_completions,
                n_rejected=self._n_rejected,
                n_shed=self._n_shed,
                n_encoded_batches=self._n_encoded_batches,
                encode_busy_s=self._encode_busy_s,
                device_busy_s=self._device_busy_total_s,
                cache_hits=g("hits", 0),
                cache_misses=g("misses", 0),
                cache_coalesced=g("coalesced", 0),
            )

    def on_capacity(self, entry: Dict[str, object]):
        """One controller action (as_dict of a ControllerAction)."""
        with self._lock:
            self._capacity_log.append(dict(entry))

    def capacity_actions(self) -> List[Dict[str, object]]:
        with self._lock:
            return [dict(e) for e in self._capacity_log]

    # -- result-cache events ---------------------------------------------------
    def on_cache(self, event: str, n: int = 1):
        """Generic cache counter bump (stale / evictions / follower_drops
        — forwarded by ResultCache/AsyncScheduler)."""
        with self._lock:
            self._cache_seen = True
            self._cache_counts[event] = self._cache_counts.get(event, 0) + n

    def on_cache_hit(self, rid: int, t: float,
                     replica: Optional[int] = None):
        """Request served straight from the result cache; ``replica`` is
        the replica that produced the cached entry (per-replica hit-rate
        attribution)."""
        with self._lock:
            self._cache_seen = True
            self._cache_counts["hits"] = self._cache_counts.get("hits", 0) + 1
            tr = self._t(rid)
            tr.cache_hit = True
            if tr.arrival is None:
                tr.arrival = t
            if replica is not None:
                self._replica_cache_hits[replica] = \
                    self._replica_cache_hits.get(replica, 0) + 1

    def on_cache_miss(self, rid: int):
        """Admitted leader: content not in cache, flows through the full
        pipeline (and fills the cache on completion)."""
        with self._lock:
            self._cache_seen = True
            self._cache_counts["misses"] = \
                self._cache_counts.get("misses", 0) + 1

    def on_coalesce(self, rid: int, leader_rid: int, t: float):
        """Follower attached to in-flight leader ``leader_rid``: costs no
        admission-queue space, no host encode, no device time."""
        with self._lock:
            self._cache_seen = True
            self._cache_counts["coalesced"] = \
                self._cache_counts.get("coalesced", 0) + 1
            tr = self._t(rid)
            tr.coalesced = True
            if tr.arrival is None:
                tr.arrival = t

    def note_cache_bytes(self, bytes_resident: int, entries: int):
        with self._lock:
            self._cache_seen = True
            self._cache_bytes = bytes_resident
            self._cache_entries = entries

    def replica_of(self, rid: int) -> Optional[int]:
        """Which replica executed ``rid`` (None if it never hit a
        device)."""
        with self._lock:
            tr = self._traces.get(rid)
            return tr.replica if tr is not None else None

    def arrival_of(self, rid: int) -> Optional[float]:
        """The arrival timestamp recorded for ``rid`` (None if unseen) —
        the tracer uses it so queue-wait spans start at the exact value
        the latency breakdown uses."""
        with self._lock:
            tr = self._traces.get(rid)
            return tr.arrival if tr is not None else None

    def note_queue_depth(self, depth: int):
        with self._lock:
            if depth > self.max_queue_depth:
                self.max_queue_depth = depth

    def note_replica_depth(self, replica: int, pipeline_depth: int,
                           outstanding_work: int):
        """Routing-time snapshot of one replica's pipeline: queued prepared
        batches and outstanding work units."""
        with self._lock:
            if pipeline_depth > self._replica_max_depth.get(replica, 0):
                self._replica_max_depth[replica] = pipeline_depth
            if outstanding_work > self._replica_max_work.get(replica, 0):
                self._replica_max_work[replica] = outstanding_work

    def on_route(self, replica: int, reason: str):
        """One routing decision: ``reason`` is the router's justification
        (single / sticky / least_loaded / tie_break / affinity_hit /
        affinity_spill)."""
        with self._lock:
            self._routing[reason] = self._routing.get(reason, 0) + 1
            # replicas that never execute (all work routed away) must still
            # appear in the per-replica report
            self._replica_batches.setdefault(replica, 0)
            self._replica_requests.setdefault(replica, 0)

    # -- aggregation ---------------------------------------------------------
    def report(self, *, offered_qps: Optional[float] = None) -> RunReport:
        with self._lock:
            traces = list(self._traces.values())
            busy = list(self._device_busy)
            batch_sizes = list(self._batch_sizes)
            max_depth = self.max_queue_depth
            replica_busy = {k: list(v) for k, v in self._replica_busy.items()}
            replica_batches = dict(self._replica_batches)
            replica_requests = dict(self._replica_requests)
            replica_max_depth = dict(self._replica_max_depth)
            replica_max_work = dict(self._replica_max_work)
            routing = dict(self._routing)
            cache_counts = dict(self._cache_counts)
            cache_bytes, cache_entries = self._cache_bytes, \
                self._cache_entries
            cache_seen = self._cache_seen
            replica_cache_hits = dict(self._replica_cache_hits)
            capacity_log = [dict(e) for e in self._capacity_log]
        done = [t for t in traces if t.completed is not None]
        starts = [t.arrival for t in traces if t.arrival is not None]
        ends = [t.completed for t in done]
        span = (max(ends) - min(starts)) if starts and ends else 0.0
        busy_s = _merged_span(busy)
        idle = 1.0 - busy_s / span if span > 0 else 0.0
        breakdown = {
            "queue_wait": LatencyStats.of(
                [t.queue_wait_ms for t in done
                 if t.queue_wait_ms is not None]),
            "encode": LatencyStats.of(
                [t.encode_ms for t in done if t.encode_ms is not None]),
            "device": LatencyStats.of(
                [t.device_ms for t in done if t.device_ms is not None]),
            "drain": LatencyStats.of(
                [t.drain_ms for t in done if t.drain_ms is not None]),
            "total": LatencyStats.of(
                [t.total_ms for t in done if t.total_ms is not None]),
        }
        per_replica = {}
        for k in sorted(set(replica_batches) | set(replica_busy)
                        | set(replica_cache_hits)):
            rb = _merged_span(replica_busy.get(k, []))
            ridle = 1.0 - rb / span if span > 0 else 0.0
            ch = replica_cache_hits.get(k, 0)
            served = ch + replica_requests.get(k, 0)
            per_replica[k] = ReplicaStats(
                replica=k,
                n_batches=replica_batches.get(k, 0),
                n_requests=replica_requests.get(k, 0),
                busy_s=rb,
                idle_fraction=max(0.0, min(1.0, ridle)),
                max_pipeline_depth=replica_max_depth.get(k, 0),
                max_outstanding_work=replica_max_work.get(k, 0),
                cache_hits=ch,
                cache_hit_rate=ch / served if served else 0.0,
            )
        cache: Dict[str, object] = {}
        if cache_seen:
            g = cache_counts.get
            tracked = g("hits", 0) + g("misses", 0) + g("coalesced", 0)
            cache = {
                "hits": g("hits", 0), "misses": g("misses", 0),
                "coalesced": g("coalesced", 0),
                "evictions": g("evictions", 0), "stale": g("stale", 0),
                "follower_drops": g("follower_drops", 0),
                "bytes_resident": cache_bytes, "entries": cache_entries,
                "hit_rate": (g("hits", 0) + g("coalesced", 0)) / tracked
                if tracked else 0.0,
            }
            for extra in ("negative_hits", "negative_stores",
                          "leader_promotions"):
                if g(extra, 0):
                    cache[extra] = g(extra, 0)
        capacity: Dict[str, object] = {}
        if capacity_log:
            capacity = {"actions": capacity_log}
        return RunReport(
            n_requests=len(traces),
            n_completed=len(done),
            n_rejected=sum(t.rejected for t in traces),
            n_shed=sum(t.shed for t in traces),
            offered_qps=offered_qps,
            achieved_qps=len(done) / span if span > 0 else 0.0,
            span_s=span,
            device_busy_s=busy_s,
            device_idle_fraction=max(0.0, min(1.0, idle)),
            max_queue_depth=max_depth,
            batch_sizes=batch_sizes,
            breakdown=breakdown,
            per_replica=per_replica,
            routing=routing,
            cache=cache,
            capacity=capacity,
        )
