"""Sharded multi-replica serving: one engine replica per device, a single
admission path, replica-aware batch routing.

Port of ``repro.serve.group``. A replica's devices are ``torch.device``s
(or their spellings); ``None`` means the engine's own device, which is the
card unless the engine was built with ``device="cpu"``. Replicas that share
one card run their batches from their own worker threads on its default
stream, so one replica's device-busy interval may include another's queued
work (as several replicas on one jax device share its one stream).

The paper's imbalance finding (§5–6) — a powerful accelerator starved by a
host that cannot generate enough load — only becomes visible at scale when
several accelerators share one admission path. ``EngineGroup`` is that
integration layer: it owns one ``LMServer`` replica per device, and a
``GroupRun`` gives every replica its own depth-``pipeline_depth``
host-encode/device-execute pipeline, so host work for replica A overlaps
device work on replica B. The single dispatcher thread is the deliberately
serial host path whose saturation produces the CPU-bound plateau the fig13
replica sweep measures.

Routing (:class:`RoutingPolicy`):

- ``least_loaded`` — route to the replica with the minimum outstanding work
  (prefill + decode tokens of every batch in its pipeline), round-robin
  among ties. A slow or stalled replica accumulates outstanding work and
  stops attracting traffic, so it cannot wedge the shared admission queue.
- ``sticky``       — batch goes to replica ``min(rid) % n_replicas``:
  replica assignment depends only on batch content, never on timing, which
  makes multi-replica runs deterministically replayable (and, since every
  replica computes the same function, bit-identical to the single-replica
  synchronous baseline).
- ``hit_aware``    — cache-ownership affinity with a straggler guard: when
  the shared :class:`~repro_torch.serve.cache.ResultCache` knows which replica
  produced a batch's content (live entry or the tombstone a TTL expiry
  leaves behind), prefer that replica — its device-side state for the
  content is still warm, so the recompute is cheaper there. The preference
  is *guarded*: if the owner's batch-latency EWMA marks it a straggler
  (``straggler_factor``× the other active replicas' mean) or its
  outstanding-work gap over the least-loaded candidate exceeds
  ``spill_threshold``, the batch spills to the least-loaded healthy
  replica and the content is re-homed there. Without a cache (or with no
  hints for the batch), decisions are identical to ``least_loaded``.
"""
from __future__ import annotations

import enum
import queue
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from repro_torch.serve.config import coerce_enum
from repro_torch.serve.engine import Completion


class RoutingPolicy(str, enum.Enum):
    """How the dispatcher picks a replica for the next prepared batch."""
    LEAST_LOADED = "least_loaded"
    STICKY = "sticky"
    HIT_AWARE = "hit_aware"

    def __str__(self) -> str:            # StrEnum parity on py3.10
        return self.value


ROUTING_POLICIES = tuple(p.value for p in RoutingPolicy)


def batch_work(requests) -> int:
    """Outstanding-work estimate of a batch: prefill tokens plus decode
    steps. The decode loop runs to the batch max for every row, so decode
    cost is ``B * max_new``, which is what makes skewed per-request decode
    lengths matter for routing."""
    rs = list(requests)
    if not rs:
        return 0
    max_new = max(r.max_new_tokens for r in rs)
    return sum(len(r.tokens) + max_new for r in rs)


@dataclass
class Replica:
    """One serving replica: an engine plus the devices it executes on
    (``None`` = the engine's own device; several ``torch.device``s or
    their spellings = round-robin within the replica)."""
    idx: int
    server: object
    devices: Optional[Sequence] = None


class _ReplicaWorker:
    """Device half of one replica's pipeline: consumes prepared batches
    from the replica's own bounded handoff queue, executes them on the
    replica's device(s), records per-replica busy intervals."""

    def __init__(self, replica: Replica, depth: int, metrics,
                 on_complete: Optional[Callable[[Completion], None]] = None,
                 on_drop: Optional[Callable[[int], None]] = None,
                 clock=time.perf_counter, delay=None,
                 on_batch_done: Optional[
                     Callable[[int, int, float], None]] = None,
                 tracer=None):
        self.replica = replica
        self.handoff: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self.metrics = metrics
        self.tracer = tracer
        self.on_complete = on_complete
        self.on_drop = on_drop          # rid sinks without a Completion
        self.clock = clock
        self.delay = delay              # repro_torch.ft.failures.DelayInjector
        self.on_batch_done = on_batch_done
        self.devices = list(replica.devices) if replica.devices else [None]
        self.completions: List[Completion] = []
        self.error: Optional[BaseException] = None
        self._n = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()

    def put(self, pb):
        # bounded put that stays responsive to worker death: if this
        # replica's thread died with the queue full, a plain put() would
        # block the dispatcher forever and bury the error
        while True:
            if self.error is not None:
                raise RuntimeError(
                    f"replica {self.replica.idx} worker failed") \
                    from self.error
            try:
                self.handoff.put(pb, timeout=0.05)
                return
            except queue.Full:
                continue

    def finish(self) -> List[Completion]:
        try:
            self.put(None)
        except RuntimeError:
            pass                        # worker already dead; join + raise
        self._thread.join()
        if self.error is not None:
            raise RuntimeError(
                f"replica {self.replica.idx} worker failed") from self.error
        return self.completions

    def _loop(self):
        try:
            while True:
                pb = self.handoff.get()
                if pb is None:
                    return
                dev = self.devices[self._n % len(self.devices)]
                self._n += 1
                rids = [r.rid for r in pb.requests]
                t0 = self.clock()
                if self.delay is not None:
                    # injected straggler latency counts as device-busy time:
                    # a slow replica, not a gap in the trace
                    self.delay.apply(self.replica.idx)
                comps = self.replica.server.execute_prepared(pb, device=dev)
                t1 = self.clock()
                if self.metrics is not None:
                    self.metrics.on_device(rids, t0, t1,
                                           replica=self.replica.idx)
                    self.metrics.on_complete([c.rid for c in comps], t1)
                if self.tracer is not None:
                    # the exact t0/t1 handed to metrics, so TraceReport
                    # device percentiles reconcile with RunReport's
                    self.tracer.span("device_execute", t0, t1,
                                     replica=self.replica.idx, rids=rids)
                    done_rids = {c.rid for c in comps}
                    for c in comps:
                        self.tracer.mark("complete", t1, rid=c.rid,
                                         replica=self.replica.idx)
                    for rid in rids:
                        if rid not in done_rids:    # MCT filter drop
                            self.tracer.mark("drop", t1, rid=rid,
                                             replica=self.replica.idx,
                                             reason="filtered")
                self.completions.extend(comps)
                if self.on_batch_done is not None:
                    self.on_batch_done(self.replica.idx,
                                       batch_work(pb.requests), t1 - t0)
                if self.on_complete is not None:
                    for c in comps:
                        self.on_complete(c)
                if self.on_drop is not None:
                    done = {c.rid for c in comps}
                    for rid in rids:
                        if rid not in done:    # MCT filter drop
                            self.on_drop(rid)
        except BaseException as e:          # surfaced by put()/finish()
            self.error = e


class GroupRun:
    """One serving run over an :class:`EngineGroup`: per-replica pipelines
    plus the routing state. Create via :meth:`EngineGroup.open`; one-shot
    (dispatch until done, then :meth:`finish`)."""

    def __init__(self, group: "EngineGroup", *, pipeline_depth: int = 2,
                 metrics=None, clock=time.perf_counter,
                 on_complete=None, on_drop=None, tracer=None, cache=None):
        self.group = group
        self.metrics = metrics
        self.tracer = tracer
        self.cache = cache              # ResultCache: hit_aware affinity
                                        # hints (None = fall back to
                                        # least_loaded decisions)
        self._clock = clock
        self._workers = [
            _ReplicaWorker(rep, pipeline_depth, metrics,
                           on_complete=on_complete, on_drop=on_drop,
                           clock=clock, delay=group.delay,
                           on_batch_done=self._on_batch_done,
                           tracer=tracer)
            for rep in group.replicas]
        self._lock = threading.Lock()
        self._outstanding = [0] * len(self._workers)
        # per-replica EWMA of device seconds per work unit, fed by the
        # same t0/t1 the worker hands to metrics/trace — the straggler
        # signal hit_aware's affinity preference is guarded by. Shared
        # with (and persisted on) the group, so back-to-back runs keep
        # what they learned about slow replicas
        self._ewma: List[Optional[float]] = group._ewma
        self._rr = 0
        self._started = False
        # capacity control: replicas [0, _active) receive new dispatches;
        # parked replicas keep draining what they already hold
        self._active = len(self._workers)

    # -- hooks (closed-loop generators chain onto these) ---------------------
    @property
    def on_complete(self):
        return self._workers[0].on_complete

    @on_complete.setter
    def on_complete(self, cb):
        for w in self._workers:
            w.on_complete = cb

    @property
    def on_drop(self):
        return self._workers[0].on_drop

    @on_drop.setter
    def on_drop(self, cb):
        for w in self._workers:
            w.on_drop = cb

    @property
    def error(self) -> Optional[BaseException]:
        for w in self._workers:
            if w.error is not None:
                return w.error
        return None

    def outstanding(self) -> List[int]:
        """Per-replica outstanding work units (routing's view)."""
        with self._lock:
            return list(self._outstanding)

    @property
    def n_active(self) -> int:
        """Replicas currently receiving new dispatches."""
        with self._lock:
            return self._active

    def set_active(self, n: int) -> int:
        """Activate/park replicas: new batches route only to replicas
        ``[0, n)``. Parked replicas drain their pipelines but attract no
        new traffic (so they can be powered down / reassigned — the cost
        report charges only for active ones). Clamped to [1, n_replicas];
        returns the applied value."""
        with self._lock:
            self._active = max(1, min(len(self._workers), int(n)))
            return self._active

    def start(self) -> "GroupRun":
        if not self._started:
            self._started = True
            for w in self._workers:
                w.start()
        return self

    # -- routing -------------------------------------------------------------
    def replica_ewma(self) -> List[Optional[float]]:
        """Per-replica EWMA of device seconds per work unit (None until a
        replica has executed a batch) — the straggler signal."""
        with self._lock:
            return list(self._ewma)

    def _is_straggler_locked(self, idx: int, n: int) -> bool:
        """Replica ``idx`` is a straggler when its per-work-unit latency
        EWMA exceeds ``straggler_factor`` times the mean of the *other*
        active replicas (excluding itself, so one slow replica cannot drag
        the fleet mean up to its own level and hide)."""
        mine = self._ewma[idx]
        if mine is None:
            return False
        others = [e for j, e in enumerate(self._ewma[:n])
                  if j != idx and e is not None]
        if not others:
            return False
        return mine > self.group.straggler_factor * (sum(others)
                                                     / len(others))

    def _least_loaded_locked(self, loads: List[int],
                             exclude: Optional[int] = None) -> tuple:
        """(idx, reason) of the least-loaded candidate, round-robin among
        ties; ``exclude`` removes one replica from candidacy (the owner a
        spill is escaping from)."""
        cands_all = [i for i in range(len(loads)) if i != exclude]
        lo = min(loads[i] for i in cands_all)
        cands = [i for i in cands_all if loads[i] == lo]
        if len(cands) == 1:
            return cands[0], "least_loaded"
        i = cands[self._rr % len(cands)]
        self._rr += 1
        return i, "tie_break"

    def _route(self, pb) -> tuple:
        """Pick (replica_idx, reason, affinity_owner) for a prepared batch
        (active replicas only). ``affinity_owner`` is the cache-derived
        owner the decision was judged against (None when no hint applied:
        non-hit_aware policies, cache off, or no owned content)."""
        with self._lock:
            n = self._active
        if n == 1:
            return 0, "single", None
        if self.group.routing == RoutingPolicy.STICKY:
            return min(r.rid for r in pb.requests) % n, "sticky", None
        if self.group.routing == RoutingPolicy.HIT_AWARE \
                and self.cache is not None:
            from repro_torch.serve.cache import request_key
            keys = [request_key(r) for r in pb.requests]
            votes = Counter(o for o in (self.cache.owner_hint(k)
                                        for k in keys)
                            if o is not None and 0 <= o < n)
            if votes:
                # majority owner of the batch's content, lowest index on
                # ties (deterministic)
                pref = max(sorted(votes), key=lambda i: votes[i])
                with self._lock:
                    loads = self._outstanding[:n]
                    lo = min(loads)
                    straggler = self._is_straggler_locked(pref, n)
                    spill = straggler or (loads[pref] - lo
                                          > self.group.spill_threshold)
                    if spill:
                        idx, _ = self._least_loaded_locked(loads,
                                                           exclude=pref)
                    else:
                        idx = pref
                if spill:
                    # re-home the content: follow-up recomputes of these
                    # keys chase the work to its new replica instead of
                    # re-testing (and re-failing) the old owner each time
                    for k in keys:
                        self.cache.rehome(k, idx)
                    return idx, "affinity_spill", pref
                return pref, "affinity_hit", pref
        with self._lock:
            loads = self._outstanding[:n]
            idx, reason = self._least_loaded_locked(loads)
        return idx, reason, None

    def _on_batch_done(self, idx: int, work: int, elapsed: float):
        with self._lock:
            self._outstanding[idx] -= work
            if work > 0 and elapsed >= 0:
                per_unit = elapsed / work
                prev = self._ewma[idx]
                a = self.group.ewma_alpha
                self._ewma[idx] = per_unit if prev is None \
                    else a * per_unit + (1 - a) * prev

    def dispatch(self, pb) -> int:
        """Route one prepared batch to a replica pipeline; blocks when that
        replica's handoff is full (that stall is the backpressure signal
        the admission queue sees). Returns the chosen replica index."""
        self.start()
        idx, reason, owner = self._route(pb)
        work = batch_work(pb.requests)
        with self._lock:
            self._outstanding[idx] += work
            depth_work = self._outstanding[idx]
        if self.metrics is not None:
            self.metrics.on_route(idx, reason)
        if self.tracer is not None:
            tags = {"reason": reason,
                    "rids": [r.rid for r in pb.requests]}
            if owner is not None:
                tags["owner"] = owner
            self.tracer.mark("dispatch", self._clock(), replica=idx,
                             **tags)
        self._workers[idx].put(pb)
        if self.metrics is not None:
            self.metrics.note_replica_depth(
                idx, self._workers[idx].handoff.qsize(), depth_work)
        return idx

    def finish(self) -> List[Completion]:
        """Drain every replica pipeline; raises if any replica worker
        failed. Completions are concatenated in replica order (callers
        match by rid — cross-replica completion order is not meaningful)."""
        self.start()
        out: List[Completion] = []
        first_err: Optional[BaseException] = None
        for w in self._workers:
            try:
                out.extend(w.finish())
            except RuntimeError as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return out


class EngineGroup:
    """A replica set plus its routing policy — the sharded-serving
    counterpart of a single ``LMServer``. Reusable: each :meth:`open` (or
    :meth:`run_groups`) creates a fresh :class:`GroupRun` with its own
    per-replica pipelines."""

    def __init__(self, replicas: Sequence[Replica], *,
                 routing=RoutingPolicy.LEAST_LOADED, delay=None,
                 spill_threshold: int = 96, straggler_factor: float = 2.0,
                 ewma_alpha: float = 0.25):
        if not replicas:
            raise ValueError("EngineGroup needs at least one replica")
        self.routing = coerce_enum(RoutingPolicy, routing, field="routing")
        if spill_threshold < 0:
            raise ValueError(
                f"spill_threshold must be >= 0, got {spill_threshold}")
        if straggler_factor < 1.0:
            raise ValueError(
                f"straggler_factor must be >= 1.0, got {straggler_factor}")
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.replicas = list(replicas)
        self.delay = delay              # optional DelayInjector (tests/sims)
        # hit_aware guard knobs (inert under other policies)
        self.spill_threshold = int(spill_threshold)
        self.straggler_factor = float(straggler_factor)
        self.ewma_alpha = float(ewma_alpha)
        # per-replica EWMA of device seconds per work unit — the straggler
        # signal. Lives on the *group* (like the cache's affinity map), so
        # a straggler identified in one run still repels traffic in the
        # next: runs are often shorter than the time a slow replica needs
        # to finish its first batch
        self._ewma: List[Optional[float]] = [None] * len(self.replicas)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_server(cls, server, *, devices=None, replicas=None,
                    routing=RoutingPolicy.LEAST_LOADED, delay=None,
                    **knobs) -> "EngineGroup":
        """Replicas sharing one engine: one per device when ``devices`` is
        given (each pinned), else ``replicas`` colocated copies (host-device
        simulation / single-accelerator default)."""
        if devices:
            reps = [Replica(i, server, devices=[d])
                    for i, d in enumerate(devices)]
        else:
            reps = [Replica(i, server) for i in range(max(1, replicas or 1))]
        return cls(reps, routing=routing, delay=delay, **knobs)

    @classmethod
    def from_servers(cls, servers: Sequence, *,
                     routing=RoutingPolicy.LEAST_LOADED, delay=None,
                     **knobs) -> "EngineGroup":
        """One replica per (distinct) engine — used with simulated engines
        and with independently-built per-device servers."""
        return cls([Replica(i, s) for i, s in enumerate(servers)],
                   routing=routing, delay=delay, **knobs)

    @classmethod
    def from_mesh(cls, server, mesh, *, axis: str = "data",
                  routing=RoutingPolicy.LEAST_LOADED, delay=None,
                  **knobs) -> "EngineGroup":
        """One replica per slice of ``mesh`` along ``axis``. Needs the
        port of ``sharding/specs.py`` (ROADMAP queue 1, item 11), which
        maps a mesh to torch device groups; until then it raises."""
        raise NotImplementedError(
            "EngineGroup.from_mesh needs the port of sharding/specs.py "
            "(ROADMAP queue 1, item 11); pass devices=[...] or replicas=N")

    # -- host-side prepare (replica-agnostic) --------------------------------
    def prepare_batch(self, requests):
        """Host-encode a batch. Prepare is replica-independent (all
        replicas serve the same model), so replica 0's engine does it."""
        return self.replicas[0].server.prepare_batch(requests)

    def open(self, *, pipeline_depth: int = 2, metrics=None,
             clock=time.perf_counter, on_complete=None,
             on_drop=None, tracer=None, cache=None) -> GroupRun:
        return GroupRun(self, pipeline_depth=pipeline_depth, metrics=metrics,
                        clock=clock, on_complete=on_complete,
                        on_drop=on_drop, tracer=tracer, cache=cache)

    def run_groups(self, groups, *, pipeline_depth: int = 2,
                   metrics=None, tracer=None, cache=None) -> List[Completion]:
        """Execute pre-formed batch groups through per-replica pipelines.

        Batch composition is fixed by the caller and every replica computes
        the same function, so completions are bit-identical to running the
        groups synchronously on one replica — only the placement and the
        host/device overlap differ. This is the single implementation
        behind ``Server.serve(mode="pipelined")``.
        """
        run = self.open(pipeline_depth=pipeline_depth, metrics=metrics,
                        tracer=tracer, cache=cache).start()
        try:
            for rs in groups:
                rs = list(rs)
                if not rs:
                    continue
                t0 = time.perf_counter()
                pb = self.prepare_batch(rs)     # overlaps device execution
                t1 = time.perf_counter()
                if metrics is not None:
                    metrics.on_encode([r.rid for r in rs], t0, t1)
                if tracer is not None:
                    tracer.span("encode", t0, t1,
                                rids=[r.rid for r in rs])
                run.dispatch(pb)
        except BaseException:
            # prepare/dispatch failed mid-run: reap every replica worker
            # thread before propagating, so a failed serve() never leaks
            # the pipeline (finish() errors must not mask the original)
            try:
                run.finish()
            except Exception:
                pass
            raise
        return run.finish()
