"""End-to-end request tracing: structured spans across the serving stack.

The paper's end-to-end analysis (§5–6) is precisely that aggregate
throughput hides *where* requests spend their time — a deployment can look
fine at the window level while every request queues behind a saturated
host prepare path. The metrics layer reports window aggregates
(:class:`~repro_torch.serve.metrics.RunReport`); this module records the raw
per-request timeline those aggregates are computed from:

    submit -> cache_lookup/coalesce -> admit -> queue_wait -> encode
           -> dispatch(replica=r) -> device_execute
           -> complete | reject | shed | drop | negative_drop

plus ``controller`` events from the capacity subsystem, so batch-target
doubling and replica parking are visible on the same timeline as the
requests they affect.

Design rules:

- **Off by default, bit-identical off.** Every emission site in
  ``scheduler``/``cache``/``group``/``server``/``capacity`` is guarded by
  ``if tracer is not None``; with ``ServeConfig(trace=None)`` (the
  default) not a single extra call runs and the stack behaves exactly as
  it did without this module.
- **Bounded and thread-safe.** Spans land in a ring buffer
  (``TraceConfig.capacity`` entries, oldest evicted first) behind one
  lock; emission is an append, never an allocation-heavy aggregation.
  ``n_dropped`` says how much history the ring evicted.
- **Same clocks as metrics.** Emission sites reuse the *exact* timestamp
  values they hand to ``MetricsCollector`` (the worker's device t0/t1,
  the batcher's encode t0/t1, the submit-time arrival), so a
  :class:`TraceReport` derived from spans reconciles with the
  ``RunReport`` computed from the same run — tests assert it.

Exporters: Chrome ``trace_event`` JSON (load in ``chrome://tracing`` or
Perfetto — one lane per replica, async lanes for queue wait, instants
for lifecycle and controller events) and JSONL (one span per line).

Port of ``repro.serve.trace``.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.config import Coercible
from repro_torch.serve.metrics import LatencyStats

# canonical stage names, in lifecycle order (exporters and reports keep
# this order; emission sites must not invent ad-hoc spellings)
LIFECYCLE_STAGES = (
    "submit", "cache_lookup", "coalesce", "admit", "queue_wait", "encode",
    "dispatch", "device_execute", "complete",
    "reject", "shed", "drop", "follower_drop", "negative_drop",
    "cache_store", "controller",
)


@dataclass
class TraceConfig(Coercible):
    """Tracing knobs (attach to ``ServeConfig.trace`` /
    ``SchedulerConfig.trace``; ``None`` keeps tracing fully off and the
    stack bit-identical to its untraced behavior).

    ``capacity`` — ring-buffer bound in spans; the oldest spans are
    evicted first once full (``TraceReport.n_dropped`` reports how many).
    """
    capacity: int = 65536


@dataclass
class Span:
    """One traced event. A *span* covers ``[t0, t1]``; a *mark* is a
    zero-duration span (``t1 == t0``). ``rid`` ties it to a request,
    ``replica`` to an engine replica; batch-level spans carry the batch's
    rids in ``meta["rids"]`` instead of a single ``rid``."""
    stage: str
    t0: float
    t1: float
    rid: Optional[int] = None
    replica: Optional[int] = None
    meta: Optional[dict] = None

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    @property
    def is_mark(self) -> bool:
        return self.t1 == self.t0

    def as_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {"stage": self.stage,
                                "t0": self.t0, "t1": self.t1}
        if self.rid is not None:
            d["rid"] = int(self.rid)
        if self.replica is not None:
            d["replica"] = int(self.replica)
        if self.meta:
            d["meta"] = {k: _json_safe(v) for k, v in self.meta.items()}
        return d


def _json_safe(v):
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


class Tracer:
    """Thread-safe bounded span sink shared by every layer of one serving
    stack (``Server`` owns one; sessions, replica workers, the cache, and
    the capacity controller all emit into it)."""

    def __init__(self, config=None):
        self.cfg = TraceConfig.coerce(config) or TraceConfig()
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=max(1, self.cfg.capacity))
        self.n_emitted = 0

    def span(self, stage: str, t0: float, t1: float, *,
             rid: Optional[int] = None, replica: Optional[int] = None,
             **meta) -> Span:
        """Record a duration span (``mark`` for zero-duration events)."""
        s = Span(stage, t0, t1, rid=rid, replica=replica,
                 meta=meta or None)
        with self._lock:
            self._spans.append(s)
            self.n_emitted += 1
        return s

    def mark(self, stage: str, t: float, *, rid: Optional[int] = None,
             replica: Optional[int] = None, **meta) -> Span:
        """Record an instantaneous event."""
        return self.span(stage, t, t, rid=rid, replica=replica, **meta)

    def spans(self) -> List[Span]:
        """Snapshot of the ring's contents, oldest first."""
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def n_dropped(self) -> int:
        """Spans evicted by the ring bound so far."""
        with self._lock:
            return self.n_emitted - len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.n_emitted = 0

    # -- derived views --------------------------------------------------------
    def report(self) -> "TraceReport":
        spans = self.spans()
        return TraceReport.from_spans(spans, n_dropped=self.n_dropped)

    def timeline(self, rid: int) -> str:
        return render_timeline(self.spans(), rid)

    def to_chrome_events(self) -> List[Dict[str, object]]:
        return chrome_events(self.spans())

    def export_chrome(self, path: str) -> str:
        """Write a Chrome ``trace_event`` JSON file (open in
        ``chrome://tracing`` / Perfetto). Returns ``path``."""
        payload = {"traceEvents": self.to_chrome_events(),
                   "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(payload, f)
        return path

    def export_jsonl(self, path: str) -> str:
        """Write one span per line as JSON. Returns ``path``."""
        with open(path, "w") as f:
            for s in self.spans():
                f.write(json.dumps(s.as_dict()) + "\n")
        return path


# ---------------------------------------------------------------------------
# Report: per-stage percentiles + per-replica straggler attribution
# ---------------------------------------------------------------------------


@dataclass
class ReplicaTraceStats:
    """Per-replica view derived from ``dispatch``/``device_execute``
    spans — the straggler-attribution counterpart of
    :class:`~repro_torch.serve.metrics.ReplicaStats`."""
    replica: int
    n_dispatches: int
    n_batches: int
    n_requests: int
    busy_s: float
    mean_batch_ms: float
    p95_batch_ms: float
    slowdown: float     # mean batch time / fleet mean (1.0 = typical,
                        # >1 = straggler)

    def as_dict(self) -> Dict[str, object]:
        return {"replica": self.replica,
                "n_dispatches": self.n_dispatches,
                "n_batches": self.n_batches,
                "n_requests": self.n_requests, "busy_s": self.busy_s,
                "mean_batch_ms": self.mean_batch_ms,
                "p95_batch_ms": self.p95_batch_ms,
                "slowdown": self.slowdown}


# stages whose per-request durations the report aggregates (and that can
# be compared against RunReport.breakdown's same-named entries)
_DURATION_STAGES = ("queue_wait", "encode", "device_execute", "total")


@dataclass
class TraceReport:
    """Aggregates derived purely from raw spans: per-stage latency
    percentiles over *completed* requests (comparable to
    ``RunReport.breakdown``), lifecycle/outcome counts, and per-replica
    straggler attribution."""
    stages: Dict[str, LatencyStats]
    counts: Dict[str, int]
    per_replica: Dict[int, ReplicaTraceStats] = field(default_factory=dict)
    n_spans: int = 0
    n_dropped: int = 0
    span_s: float = 0.0

    @classmethod
    def from_spans(cls, spans: Sequence[Span], *,
                   n_dropped: int = 0) -> "TraceReport":
        counts: Dict[str, int] = {}
        submit_t: Dict[int, float] = {}
        complete_t: Dict[int, float] = {}
        queue_wait: Dict[int, float] = {}
        encode: Dict[int, float] = {}
        device: Dict[int, float] = {}
        disp_by_replica: Dict[int, int] = {}
        dev_spans: Dict[int, List[Span]] = {}
        for s in spans:
            counts[s.stage] = counts.get(s.stage, 0) + 1
            if s.stage == "cache_lookup" and s.meta:
                out = s.meta.get("outcome")
                if out:
                    k = f"cache_{out}"
                    counts[k] = counts.get(k, 0) + 1
            if s.stage == "dispatch" and s.meta:
                # routing-reason breakdown (affinity_hit/affinity_spill/
                # least_loaded/...) — reconciles with RunReport.routing
                reason = s.meta.get("reason")
                if reason:
                    k = f"dispatch_{reason}"
                    counts[k] = counts.get(k, 0) + 1
            rids = (s.meta or {}).get("rids")
            if s.stage == "submit" and s.rid is not None:
                submit_t[s.rid] = s.t0
            elif s.stage == "complete" and s.rid is not None:
                complete_t[s.rid] = s.t0
            elif s.stage == "queue_wait" and s.rid is not None:
                queue_wait[s.rid] = s.duration_ms
            elif s.stage == "encode" and rids:
                for rid in rids:
                    encode[rid] = s.duration_ms
            elif s.stage == "device_execute":
                r = s.replica if s.replica is not None else 0
                dev_spans.setdefault(r, []).append(s)
                for rid in rids or ():
                    device[rid] = s.duration_ms
            elif s.stage == "dispatch":
                r = s.replica if s.replica is not None else 0
                disp_by_replica[r] = disp_by_replica.get(r, 0) + 1
        # percentiles over completed requests only — the same population
        # RunReport.breakdown aggregates
        done = set(complete_t)
        stages = {
            "queue_wait": LatencyStats.of(
                [v for r, v in queue_wait.items() if r in done]),
            "encode": LatencyStats.of(
                [v for r, v in encode.items() if r in done]),
            "device_execute": LatencyStats.of(
                [v for r, v in device.items() if r in done]),
            "total": LatencyStats.of(
                [(complete_t[r] - submit_t[r]) * 1e3
                 for r in done if r in submit_t]),
        }
        all_batch_ms = [s.duration_ms
                        for ss in dev_spans.values() for s in ss]
        fleet_mean = float(np.mean(all_batch_ms)) if all_batch_ms else 0.0
        per_replica: Dict[int, ReplicaTraceStats] = {}
        for r in sorted(set(dev_spans) | set(disp_by_replica)):
            ss = dev_spans.get(r, [])
            ms = [s.duration_ms for s in ss]
            mean = float(np.mean(ms)) if ms else 0.0
            per_replica[r] = ReplicaTraceStats(
                replica=r,
                n_dispatches=disp_by_replica.get(r, 0),
                n_batches=len(ss),
                n_requests=sum(len((s.meta or {}).get("rids") or ())
                               for s in ss),
                busy_s=sum(s.t1 - s.t0 for s in ss),
                mean_batch_ms=mean,
                p95_batch_ms=float(np.percentile(ms, 95)) if ms else 0.0,
                slowdown=mean / fleet_mean if fleet_mean > 0 else 0.0,
            )
        span_s = (max(s.t1 for s in spans) - min(s.t0 for s in spans)) \
            if spans else 0.0
        return cls(stages=stages, counts=counts, per_replica=per_replica,
                   n_spans=len(spans), n_dropped=n_dropped, span_s=span_s)

    def dominant_stage(self) -> Optional[str]:
        """The per-request stage (queue_wait / encode / device_execute)
        with the largest mean — where requests spend their time. None
        when no completed request was traced."""
        cands = [(k, self.stages[k].mean_ms)
                 for k in ("queue_wait", "encode", "device_execute")
                 if self.stages.get(k) is not None and self.stages[k].n]
        if not cands:
            return None
        return max(cands, key=lambda kv: kv[1])[0]

    def as_dict(self) -> Dict[str, object]:
        return {
            "stages": {k: v.as_dict() for k, v in self.stages.items()},
            "counts": dict(self.counts),
            "per_replica": {k: v.as_dict()
                            for k, v in sorted(self.per_replica.items())},
            "dominant_stage": self.dominant_stage(),
            "n_spans": self.n_spans,
            "n_dropped": self.n_dropped,
            "span_s": self.span_s,
        }

    def summary(self) -> str:
        dom = self.dominant_stage()
        parts = [f"{self.n_spans} spans"
                 + (f" ({self.n_dropped} dropped)" if self.n_dropped else "")]
        for k in ("queue_wait", "encode", "device_execute"):
            st = self.stages.get(k)
            if st is not None and st.n:
                parts.append(f"{k} p50/p95 {st.p50_ms:.2f}/{st.p95_ms:.2f} ms"
                             + (" <-- dominant" if k == dom else ""))
        return "; ".join(parts)


# ---------------------------------------------------------------------------
# Rendering + exporters
# ---------------------------------------------------------------------------


def render_timeline(spans: Sequence[Span], rid: int) -> str:
    """One request's lifecycle as a single human-readable line (marks show
    ``stage@t``, spans ``stage[t0..t1]``; times are ms relative to the
    request's first event)."""
    rel = [s for s in spans
           if s.rid == rid or rid in ((s.meta or {}).get("rids") or ())]
    if not rel:
        return f"rid {rid}: (no spans)"
    rel.sort(key=lambda s: (s.t0, s.t1))
    base = rel[0].t0
    parts = []
    for s in rel:
        tag = s.stage
        if s.replica is not None:
            tag += f"(replica={s.replica})"
        if s.meta and "outcome" in s.meta:
            tag += f"[{s.meta['outcome']}]"
        if s.is_mark:
            parts.append(f"{tag}@{(s.t0 - base) * 1e3:.2f}ms")
        else:
            parts.append(f"{tag}[{(s.t0 - base) * 1e3:.2f}"
                         f"..{(s.t1 - base) * 1e3:.2f}ms]")
    return f"rid {rid}: " + " -> ".join(parts)


# Chrome trace lane layout: fixed tids for the shared host-side lanes,
# 10+replica for per-replica device lanes
_TID_ADMISSION = 0
_TID_HOST = 1
_TID_LIFECYCLE = 2
_TID_CONTROLLER = 3
_TID_REPLICA_BASE = 10
_PID = 1


def _lane_of(s: Span) -> tuple:
    if s.stage in ("device_execute", "dispatch"):
        r = s.replica if s.replica is not None else 0
        return _TID_REPLICA_BASE + r, f"replica-{r}"
    if s.stage == "encode":
        return _TID_HOST, "host-encode"
    if s.stage == "controller":
        return _TID_CONTROLLER, "controller"
    if s.stage in ("complete", "drop", "follower_drop"):
        return _TID_LIFECYCLE, "lifecycle"
    return _TID_ADMISSION, "admission"


def chrome_events(spans: Sequence[Span]) -> List[Dict[str, object]]:
    """Spans -> Chrome ``trace_event`` list. Duration spans become ``X``
    events, marks become ``i`` instants, queue waits become async ``b``/
    ``e`` pairs keyed by rid (they overlap arbitrarily, which thread
    lanes cannot render), and ``M`` metadata names the lanes."""
    if not spans:
        return []
    origin = min(s.t0 for s in spans)

    def us(t: float) -> float:
        return (t - origin) * 1e6

    lanes: Dict[int, str] = {}
    evs: List[Dict[str, object]] = []
    for s in spans:
        args: Dict[str, object] = {}
        if s.rid is not None:
            args["rid"] = int(s.rid)
        if s.replica is not None:
            args["replica"] = int(s.replica)
        if s.meta:
            args.update({k: _json_safe(v) for k, v in s.meta.items()})
        if s.stage == "queue_wait":
            common = {"pid": _PID, "cat": "queue_wait",
                      "name": "queue_wait",
                      "id": int(s.rid) if s.rid is not None else 0}
            evs.append({**common, "ph": "b", "ts": us(s.t0), "args": args})
            evs.append({**common, "ph": "e", "ts": us(s.t1)})
            continue
        tid, lane = _lane_of(s)
        lanes.setdefault(tid, lane)
        if s.is_mark:
            evs.append({"pid": _PID, "tid": tid, "ph": "i", "s": "t",
                        "name": s.stage, "ts": us(s.t0), "args": args})
        else:
            evs.append({"pid": _PID, "tid": tid, "ph": "X", "name": s.stage,
                        "ts": us(s.t0),
                        "dur": max(0.0, (s.t1 - s.t0) * 1e6),
                        "args": args})
    meta: List[Dict[str, object]] = [
        {"pid": _PID, "tid": _TID_ADMISSION, "ph": "M",
         "name": "process_name", "args": {"name": "repro_torch.serve"}}]
    for tid, lane in sorted(lanes.items()):
        meta.append({"pid": _PID, "tid": tid, "ph": "M",
                     "name": "thread_name", "args": {"name": lane}})
    return meta + evs
