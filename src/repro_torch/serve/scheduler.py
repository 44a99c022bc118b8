"""Asynchronous submission pipeline with bounded admission + backpressure.

Port of ``repro.serve.scheduler``.

The paper's deployment lesson (§5–6): the accelerator's headline gains
evaporate when the host submission path can't keep it fed — batches form
too slowly, the CPU saturates first, and end-to-end the system gets slower
*and* more expensive. This module makes that regime reproducible:

    submit() --bounded queue / backpressure--> [batcher thread]
        host prepare (token matrix + MCT encode, numpy)
              --replica routing--> [per-replica device threads]
        rule match + decode loop on the accelerator(s)

The batcher routes each prepared batch to one replica of an
:class:`~repro_torch.serve.group.EngineGroup` (least-outstanding-work by default,
``sticky`` for deterministic replay, ``hit_aware`` for cache-ownership
affinity with a straggler-guarded spill — see
:class:`~repro_torch.serve.group.RoutingPolicy`). Every replica keeps its own
depth-``pipeline_depth`` handoff queue (2 = classic double buffering), so
host-side encode of batch N+1 overlaps device execution of batch N — and
with several replicas, host work for one replica overlaps device work on
the others. The device stage ends on the host: ``LMServer.execute_prepared``
returns only after the card has finished the batch (the decode loop reads
each step's tokens back with ``.cpu()`` after a ``synchronize`` that closes
the prefill, and a batch the MCT filter empties ends in the ``.cpu()`` copy
of its decisions), so the worker's clock marks the true device-busy
interval for the per-replica idle-fraction metric. Replicas colocated on
one card share its default stream; ``synchronize`` waits for the whole
card, so one replica's interval can include another's queued work.

Backpressure policies (:class:`BackpressurePolicy`) when the admission
queue (pending + aggregator buffer) is at ``max_queue``:

- ``REJECT``      — refuse the new request (submit returns False)
- ``SHED_OLDEST`` — evict the oldest queued request, admit the new one
- ``BLOCK``       — make the submitter wait (closed-loop behaviour)

With a :class:`~repro_torch.serve.cache.CacheConfig` on the config, ``submit``
checks the content-addressed :class:`~repro_torch.serve.cache.ResultCache`
first (a hit completes immediately — zero host encode, zero device time)
and then the single-flight :class:`~repro_torch.serve.cache.Coalescer` (an
identical in-flight request adopts the new one as a follower). Hits and
followers never occupy admission-queue space, so they are exempt from all
three backpressure policies; a shed leader drops its followers with it.

With a :class:`~repro_torch.serve.trace.TraceConfig` on the config (or a shared
:class:`~repro_torch.serve.trace.Tracer` passed in), every lifecycle step —
submit, cache lookup, admission, queue wait, encode, dispatch, device
execute, completion/shed/drop — lands as a span on one timeline, using
the same timestamps the metrics layer records. ``trace=None`` (default)
emits nothing and keeps the stack bit-identical to its untraced behavior.
"""
from __future__ import annotations

import enum
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

from repro_torch.core.aggregator import DeadlineAggregator
from repro_torch.serve.cache import (CacheConfig, CachedResult, Coalescer,
                               NegativeResult, ResultCache, request_key)
from repro_torch.serve.capacity import CapacityConfig, CapacityController
from repro_torch.serve.config import coerce_enum
from repro_torch.serve.engine import Completion, LMServer, Request
from repro_torch.serve.group import EngineGroup, RoutingPolicy
from repro_torch.serve.metrics import MetricsCollector
from repro_torch.serve.trace import TraceConfig, Tracer, TraceReport


class BackpressurePolicy(str, enum.Enum):
    """What happens to a new request when the admission queue is full."""
    REJECT = "reject"
    SHED_OLDEST = "shed_oldest"
    BLOCK = "block"

    def __str__(self) -> str:            # StrEnum parity on py3.10
        return self.value


# legacy tuple kept for callers that introspected the valid policy strings
POLICIES = tuple(p.value for p in BackpressurePolicy)


@dataclass
class SchedulerConfig:
    target_batch: int = 8
    deadline: float = 0.05          # seconds a request may wait for peers
    max_queue: int = 64             # bounded admission depth (requests)
    policy: Union[str, BackpressurePolicy] = BackpressurePolicy.REJECT
    pipeline_depth: int = 2         # prepared batches in flight per replica
                                    # (2 = double buffering)
    devices: Optional[Sequence] = None  # one replica per device
    replicas: Optional[int] = None      # colocated replicas (simulation)
    routing: Union[str, RoutingPolicy] = RoutingPolicy.LEAST_LOADED
    # hit_aware guard knobs (inert under other routing policies):
    # outstanding-work gap over the least-loaded candidate beyond which
    # the affinity preference spills; latency-EWMA multiple of the other
    # replicas' mean that marks the owner a straggler; EWMA smoothing
    spill_threshold: int = 96
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.25
    # result cache + coalescing (None/False = off, True = defaults,
    # dict/CacheConfig = explicit knobs)
    cache: Union[None, bool, dict, CacheConfig] = None
    # capacity control loop (None/False = off — bit-identical to the
    # uncontrolled stack, True = defaults, dict/CapacityConfig = knobs)
    capacity: Union[None, bool, dict, CapacityConfig] = None
    # per-request tracing (None/False = off — zero emission, bit-identical
    # stack; True = defaults, dict/TraceConfig = knobs)
    trace: Union[None, bool, dict, TraceConfig] = None

    def __post_init__(self):
        # every optional subsystem uses the one shared coercion rule
        # (repro_torch.serve.config.coerce): None/False off, True defaults,
        # dict kwargs, instance as-is
        self.cache = CacheConfig.coerce(self.cache)
        self.capacity = CapacityConfig.coerce(self.capacity)
        self.trace = TraceConfig.coerce(self.trace)
        self.policy = coerce_enum(BackpressurePolicy, self.policy,
                                  field="policy")
        self.routing = coerce_enum(RoutingPolicy, self.routing,
                                   field="routing")
        if self.spill_threshold < 0:
            raise ValueError(f"spill_threshold must be >= 0, "
                             f"got {self.spill_threshold}")
        if self.straggler_factor < 1.0:
            raise ValueError(f"straggler_factor must be >= 1.0, "
                             f"got {self.straggler_factor}")
        if not (0.0 < self.ewma_alpha <= 1.0):
            raise ValueError(f"ewma_alpha must be in (0, 1], "
                             f"got {self.ewma_alpha}")


class AsyncScheduler:
    """Live continuous-batching front end with bounded admission.

    Accepts a single ``LMServer`` (wrapped into a one-replica
    :class:`EngineGroup`; ``devices``/``replicas`` in the config expand it)
    or an ``EngineGroup`` built explicitly. Thread layout: submitters call
    :meth:`submit`; a batcher thread drains the admission queue through a
    :class:`DeadlineAggregator` (wall-clock deadline), host-prepares one
    batch at a time, and routes it to a replica pipeline. Draining one
    batch per poll is what makes backpressure real — overload accumulates
    in the *bounded* admission queue instead of an unbounded internal
    buffer.
    """

    def __init__(self, server: Union[LMServer, EngineGroup],
                 config: Optional[SchedulerConfig] = None, *,
                 metrics: Optional[MetricsCollector] = None,
                 on_complete: Optional[Callable[[Completion], None]] = None,
                 cache: Optional[ResultCache] = None,
                 tracer: Optional[Tracer] = None,
                 **overrides):
        if config is None:
            config = SchedulerConfig(**overrides)
        elif overrides:
            raise ValueError("pass either config or keyword overrides")
        self.cfg = config
        if isinstance(server, EngineGroup):
            self.group = server         # config.routing/devices ignored:
                                        # the group already encodes them
        else:
            self.group = EngineGroup.from_server(
                server, devices=config.devices, replicas=config.replicas,
                routing=config.routing,
                spill_threshold=config.spill_threshold,
                straggler_factor=config.straggler_factor,
                ewma_alpha=config.ewma_alpha)
        self.server = self.group.replicas[0].server
        self.metrics = metrics if metrics is not None else MetricsCollector()
        # result cache: an explicit instance (Server shares one across
        # sessions and replicas) wins over the config's CacheConfig
        if cache is not None:
            self.cache = cache
        elif config.cache is not None:
            self.cache = ResultCache(config.cache)
        else:
            self.cache = None
        self._coalescer = Coalescer(enabled=self.cache.cfg.coalesce) \
            if self.cache is not None else None
        # tracer: an explicit instance (Server shares one across sessions)
        # wins over the config's TraceConfig; None = zero emission
        if tracer is not None:
            self.tracer = tracer
        elif config.trace is not None:
            self.tracer = Tracer(config.trace)
        else:
            self.tracer = None
        # queue-wait start per admitted rid (the same arrival value handed
        # to metrics.on_arrival) — maintained only when tracing is on
        self._admit_t: Dict[int, float] = {}
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._pending: deque = deque()
        self._agg = DeadlineAggregator(target_batch=config.target_batch,
                                       deadline=config.deadline)
        # live admission limit — the capacity controller's AIMD knob;
        # starts at (and without a controller stays at) config.max_queue
        self._max_queue = config.max_queue
        self._closed = False
        self.n_submitted = 0
        self.n_rejected = 0
        self.n_shed = 0
        self.n_cache_hits = 0
        self.n_coalesced = 0
        self.n_negative_hits = 0
        # completions minted off the pipeline (cache hits + resolved
        # followers), merged into result()
        self._extra: List[Completion] = []
        # the run always gets the scheduler's own hooks; user callbacks
        # (closed-loop generators chain onto the properties below) live in
        # these slots so cache/coalescer bookkeeping can't be displaced
        self._user_on_complete = on_complete
        self._user_on_drop: Optional[Callable[[int], None]] = None
        self._run = self.group.open(pipeline_depth=config.pipeline_depth,
                                    metrics=self.metrics,
                                    clock=self._now,
                                    on_complete=self._complete_hook,
                                    on_drop=self._drop_hook,
                                    tracer=self.tracer,
                                    cache=self.cache)
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
        self._batcher_error: Optional[BaseException] = None
        self._started = False
        self._results: Optional[List[Completion]] = None
        # capacity control loop (None = fully unwired: every knob keeps
        # its configured value and the stack is bit-identical)
        self._controller: Optional[CapacityController] = None
        if config.capacity is not None:
            self._controller = CapacityController(
                self, config.capacity, metrics=self.metrics,
                clock=self._now, tracer=self.tracer)

    # -- time ----------------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    # completion/drop hooks (closed-loop generators chain onto these).
    # The GroupRun always calls the scheduler's internal hooks, which do
    # cache fill + follower resolution and then forward to these user
    # slots — so chaining can never displace the cache bookkeeping.
    @property
    def on_complete(self):
        return self._user_on_complete

    @on_complete.setter
    def on_complete(self, cb):
        self._user_on_complete = cb

    @property
    def on_drop(self):
        return self._user_on_drop

    @on_drop.setter
    def on_drop(self, cb):
        self._user_on_drop = cb

    # -- cache/coalescer plumbing (run on the replica worker threads) --------
    def _complete_hook(self, comp: Completion):
        """Leader completed: fill the cache, mint follower completions,
        then forward everything to the user callback."""
        minted: List[Completion] = []
        if self.cache is not None:
            now = self._now()
            key, followers = self._coalescer.resolve(comp.rid)
            if key is not None:
                entry = CachedResult.of(
                    comp, replica=self.metrics.replica_of(comp.rid), now=now)
                self.cache.put(key, entry, metrics=self.metrics,
                               tracer=self.tracer, rid=comp.rid)
                for freq in followers:
                    minted.append(entry.mint(freq.rid))
                    self.metrics.on_complete([freq.rid], now)
                    if self.tracer is not None:
                        self.tracer.mark("complete", now, rid=freq.rid,
                                         source="coalesce")
            if minted:
                with self._lock:
                    self._extra.extend(minted)
        cb = self._user_on_complete
        if cb is not None:
            cb(comp)
            for fc in minted:
                cb(fc)

    def _drop_hook(self, rid: int, *, filtered: bool = True):
        """Leader shed or dropped: its followers are dropped with it —
        never independently — and the key is released so the next
        identical request becomes a fresh leader. ``filtered`` is True on
        the engine-drop path (the GroupRun calls this positionally for
        rids the MCT feasibility check removed), where the verdict is a
        property of the *content* and worth negative-caching; a shed is
        a property of the *moment* and is not."""
        followers: List[Request] = []
        if self._coalescer is not None:
            key, followers = self._coalescer.fail(rid)
            if followers:
                self.metrics.on_cache("follower_drops", len(followers))
                if self.tracer is not None:
                    now = self._now()
                    for freq in followers:
                        self.tracer.mark("follower_drop", now,
                                         rid=freq.rid, leader=rid)
            if filtered and key is not None and self.cache is not None:
                self.cache.put_negative(key, self._now(),
                                        metrics=self.metrics,
                                        tracer=self.tracer, rid=rid)
        cb = self._user_on_drop
        if cb is not None:
            cb(rid)
            for freq in followers:
                cb(freq.rid)

    # -- public API ------------------------------------------------------------
    def start(self) -> "AsyncScheduler":
        with self._lock:
            if self._started:
                return self
            self._started = True
        self._run.start()
        self._batcher.start()
        if self._controller is not None:
            self._controller.start()
        return self

    # -- capacity actuator protocol (driven by CapacityController) -----------
    def capacity_state(self) -> dict:
        """Live knob values + load state for the capacity controller."""
        with self._lock:
            depth = self._depth_locked()
            tb = self._agg.target_batch
            limit = self._max_queue
        return {"queue_depth": depth, "target_batch": tb,
                "admission_limit": limit,
                "n_active": self._run.n_active,
                "n_replicas": len(self.group.replicas),
                "replica_depths": tuple(self._run.outstanding())}

    def set_target_batch(self, n: int) -> None:
        """Retarget batch formation live (next poll sees it)."""
        with self._lock:
            self._agg.target_batch = max(1, int(n))
            self._have_work.notify()    # a smaller target may make a
                                        # buffered batch ready now

    def set_admission_limit(self, n: int) -> None:
        """Rescale the bounded admission depth live (AIMD knob)."""
        with self._lock:
            self._max_queue = max(1, int(n))
            self._space.notify_all()    # a raised limit unblocks waiters

    def set_active_replicas(self, n: int) -> int:
        """Activate/park replicas (parked ones drain, attract no new
        dispatches)."""
        return self._run.set_active(n)

    def _depth_locked(self) -> int:
        return len(self._pending) + self._agg.pending()

    def _pipeline_dead(self) -> bool:
        return self._batcher_error is not None \
            or self._run.error is not None

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    def submit(self, req: Request, *, arrival: Optional[float] = None) -> bool:
        """Offer a request; returns False when rejected by backpressure.

        With a result cache configured, the content-addressed fast paths
        run first, ahead of admission: a cache hit completes immediately
        and an identical in-flight request adopts this one as a follower.
        Neither consumes queue space, so neither can be rejected, shed, or
        blocked — backpressure only ever acts on leaders."""
        self.start()                 # idempotent, lock-guarded
        now = self._now()
        tr = self.tracer
        arr = arrival if arrival is not None else now
        shed_rid: Optional[int] = None
        promoted_drops: List[int] = []
        hit: Optional[Completion] = None
        negative = False
        key: Optional[str] = None
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self.cache is not None:
                key = request_key(req)
                entry = self.cache.get(key, now, metrics=self.metrics,
                                       tracer=tr, rid=req.rid)
                if isinstance(entry, NegativeResult):
                    # known-filtered content: drop at submit time, zero
                    # queue space / host encode / device time
                    negative = True
                    self.n_submitted += 1
                    self.n_negative_hits += 1
                    self.metrics.on_arrival(req.rid, arrival
                                            if arrival is not None else now)
                    self.metrics.on_cache("negative_hits")
                    if tr is not None:
                        tr.mark("submit", arr, rid=req.rid)
                        tr.mark("negative_drop", now, rid=req.rid)
                elif entry is not None:
                    hit = entry.mint(req.rid)
                    self.n_submitted += 1
                    self.n_cache_hits += 1
                    self._extra.append(hit)
                    self.metrics.on_arrival(req.rid, arrival
                                            if arrival is not None else now)
                    self.metrics.on_cache_hit(req.rid, now,
                                              replica=entry.replica)
                    self.metrics.on_complete([req.rid], now)
                    if tr is not None:
                        tr.mark("submit", arr, rid=req.rid)
                        tr.mark("complete", now, rid=req.rid,
                                source="cache")
                else:
                    leader = self._coalescer.attach(key, req)
                    if leader is not None:
                        self.n_submitted += 1
                        self.n_coalesced += 1
                        self.metrics.on_arrival(
                            req.rid, arrival if arrival is not None else now)
                        self.metrics.on_coalesce(req.rid, leader, now)
                        if tr is not None:
                            tr.mark("submit", arr, rid=req.rid)
                            tr.mark("coalesce", now, rid=req.rid,
                                    leader=leader)
                        return True
            if hit is None and not negative:
                if self.cfg.policy == BackpressurePolicy.BLOCK:
                    while self._depth_locked() >= self._max_queue \
                            and not self._closed \
                            and not self._pipeline_dead():
                        self._space.wait(timeout=0.1)
                    if self._closed:
                        # close() raced our wait; the batcher may already
                        # have flushed and exited — appending now would
                        # lose the request silently
                        raise RuntimeError("scheduler is closed")
                    if self._pipeline_dead():
                        # the batcher/device thread died, so queue space
                        # will never free up — fail fast instead of
                        # wedging the submitter (result() carries the
                        # root cause)
                        raise RuntimeError("scheduler pipeline failed; "
                                           "call result() for the cause")
                elif self._depth_locked() >= self._max_queue:
                    if self.cfg.policy == BackpressurePolicy.REJECT:
                        self.n_rejected += 1
                        self.metrics.on_reject(req.rid, now)
                        if tr is not None:
                            tr.mark("submit", arr, rid=req.rid)
                            tr.mark("reject", now, rid=req.rid)
                        return False
                    # shed_oldest: evict from the aggregator buffer first
                    # (the overall oldest), then from the pending deque.
                    # A shed coalescing leader with followers promotes its
                    # first follower instead of killing the whole flight
                    # (promote_on_shed): the promoted follower takes a
                    # queue slot as the new leader, so eviction continues
                    # until a slot genuinely frees up — each promotion
                    # consumes one follower, so this terminates
                    while self._depth_locked() >= self._max_queue:
                        victim = self._agg.evict_oldest(now)
                        if victim is None and self._pending:
                            victim = self._pending.popleft()
                        if victim is None:
                            break
                        vrid = victim[1].rid
                        self.n_shed += 1
                        self.metrics.on_shed(vrid, now)
                        if tr is not None:
                            tr.mark("shed", now, rid=vrid)
                            self._admit_t.pop(vrid, None)
                        promoted = None
                        if self._coalescer is not None \
                                and self.cache.cfg.promote_on_shed:
                            promoted = self._coalescer.promote(vrid)
                        if promoted is None:
                            shed_rid = vrid
                            break
                        self.metrics.on_cache("leader_promotions")
                        self.metrics.on_admit(promoted.rid, now)
                        if tr is not None:
                            tr.mark("admit", now, rid=promoted.rid,
                                    promoted_from=vrid)
                            # queue wait starts where the breakdown's
                            # does: the follower's recorded arrival
                            pa = self.metrics.arrival_of(promoted.rid)
                            self._admit_t[promoted.rid] = \
                                pa if pa is not None else now
                        # re-admit at the tail of pending (not the
                        # aggregator): evict_oldest drains the aggregator
                        # first, so the promoted leader must not land
                        # there or this same pass would evict it next and
                        # kill the flight it just saved
                        self._pending.append((promoted.rid, promoted))
                        promoted_drops.append(vrid)
                self._pending.append((req.rid, req))
                self.n_submitted += 1
                # arrival/admit recorded only once the request's fate is
                # decided — a submit that raised on a close() race must
                # not leave a phantom trace inflating the report
                self.metrics.on_arrival(req.rid, arrival
                                        if arrival is not None else now)
                self.metrics.on_admit(req.rid, now)
                if tr is not None:
                    tr.mark("submit", arr, rid=req.rid)
                    tr.mark("admit", now, rid=req.rid)
                    self._admit_t[req.rid] = arr
                self.metrics.note_queue_depth(self._depth_locked())
                if key is not None:
                    # admitted leader: claim the key so identical requests
                    # coalesce onto it until it completes or is shed
                    self._coalescer.claim(key, req.rid)
                    self.metrics.on_cache_miss(req.rid)
                self._have_work.notify()
        # user callbacks outside the non-reentrant lock: an on_complete/
        # on_drop that reads queue_depth or re-submits must not deadlock
        # (the device thread already calls them unlocked — same contract)
        if negative:
            cb = self._user_on_drop
            if cb is not None:
                cb(req.rid)
            return True
        if hit is not None:
            cb = self._user_on_complete
            if cb is not None:
                cb(hit)
            return True
        for vrid in promoted_drops:
            # promoted-away leaders: the flight survives under the new
            # leader, so only the user drop callback fires — no coalescer
            # fail, no follower drops, no negative store
            cb = self._user_on_drop
            if cb is not None:
                cb(vrid)
        if shed_rid is not None:
            self._drop_hook(shed_rid, filtered=False)
        return True

    def close(self):
        """Stop accepting requests and flush everything still queued."""
        # stop the control loop before taking the lock (its tick reads
        # capacity_state under the same lock); knobs freeze at their
        # final values for the drain
        if self._controller is not None:
            self._controller.stop()
        with self._lock:
            self._closed = True
            self._have_work.notify_all()
            self._space.notify_all()

    def result(self) -> List[Completion]:
        """close() if needed, wait for the pipeline to drain, and return
        all completions (matched by rid; cross-replica order is not
        meaningful)."""
        if self._results is not None:
            return self._results
        if not self._started:
            self.start()       # zero submissions: drain cleanly to []
        self.close()
        self._batcher.join()
        completions = self._run.finish()        # raises on replica error
        if self._batcher_error is not None:
            raise RuntimeError("batcher thread failed") \
                from self._batcher_error
        with self._lock:
            # cache hits + resolved followers never ran on a replica;
            # merge them in (callers match by rid)
            completions = completions + self._extra
        self._results = completions
        return self._results

    def shutdown(self) -> None:
        """close() + reap the batcher and every replica worker thread,
        swallowing pipeline errors — the exception-path cleanup used by
        the context manager, so a failed run never leaks the pipeline
        threads. Use :meth:`result` when you want errors raised."""
        try:
            self.result()
        except Exception:
            pass

    def __enter__(self) -> "AsyncScheduler":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.result()
        else:
            # body raised: reap threads without masking the user's error
            self.shutdown()
        return False

    def report(self, *, offered_qps: Optional[float] = None):
        if self.cache is not None:
            self.metrics.note_cache_bytes(self.cache.bytes_resident,
                                          len(self.cache))
        rep = self.metrics.report(offered_qps=offered_qps)
        rep.n_rejected = max(rep.n_rejected, self.n_rejected)
        rep.n_shed = max(rep.n_shed, self.n_shed)
        if self._controller is not None:
            rep.capacity = {**rep.capacity, **self._controller.summary()}
        return rep

    def trace_report(self) -> Optional[TraceReport]:
        """Per-stage percentiles + straggler attribution derived from this
        session's spans (None when tracing is off)."""
        return self.tracer.report() if self.tracer is not None else None

    # -- batcher thread --------------------------------------------------------
    def _take_batch(self) -> Optional[List[Request]]:
        """Block until one batch is ready (target size or deadline) or the
        scheduler is closed and drained. Returns None to stop."""
        with self._lock:
            while True:
                # move newly-submitted requests into the aggregator, then
                # drain at most ONE batch — overload stays in the bounded
                # admission state where backpressure can see it
                now = self._now()
                while self._pending:
                    rid, req = self._pending.popleft()
                    self._agg.add(rid, [req], now=now)
                batches = self._agg.poll(now, limit=1)
                if batches:
                    self._space.notify_all()
                    return [q for q in batches[0].queries]
                if self._closed:
                    batches = self._agg.flush()
                    if batches:
                        self._space.notify_all()
                        return [q for q in batches[0].queries]
                    return None
                # idle: sleep until a submit/close notification; partial
                # batch buffered: sleep just long enough to fire its
                # deadline flush (no busy-ticking in either case)
                nd = self._agg.next_deadline()
                timeout = None if nd is None \
                    else max(nd - self._now(), 1e-4)
                self._have_work.wait(timeout=timeout)

    def _batch_loop(self):
        try:
            while True:
                rs = self._take_batch()
                if rs is None:
                    return
                t0 = self._now()
                pb = self.group.prepare_batch(rs)
                t1 = self._now()
                self.metrics.on_encode([r.rid for r in rs], t0, t1)
                if self.tracer is not None:
                    rids = [r.rid for r in rs]
                    # queue wait ends where encode begins — the same t0
                    # the breakdown uses as encode_start
                    for rid in rids:
                        a = self._admit_t.pop(rid, None)
                        if a is not None:
                            self.tracer.span("queue_wait", a, t0, rid=rid)
                    self.tracer.span("encode", t0, t1, rids=rids)
                # blocks while the routed replica already has
                # `pipeline_depth` batches in flight — that stall is what
                # pushes overload back onto the bounded admission queue
                self._run.dispatch(pb)
        except BaseException as e:          # surfaced by result()
            self._batcher_error = e
            with self._lock:
                # blocked submitters must not wait for space that will
                # never free up
                self._space.notify_all()
                self._have_work.notify_all()
