"""Unified serving front end: ``ServeConfig`` + ``build()`` -> ``Server``.

Port of ``repro.serve.server``. ``ServeConfig.device`` (default
``"cuda"``) is the device ``build()`` places the ``LMServer`` on when no
``devices`` are listed; pass ``device="cpu"`` to serve on the CPU with the
kernels' plain versions.

One dataclass describes the whole serving stack — model, replica topology,
batching, admission control — and one call wires it:

    from repro_torch.serve import ServeConfig, build

    srv = build(ServeConfig(model="llama3.2-3b", max_seq=48,
                            replicas=2, target_batch=8, deadline=0.01))
    outs = srv.serve(requests, mode="pipelined")     # deterministic replay
    sched = srv.session()                            # live async serving
    sched.submit(req); ...; sched.result()

Or, for the whole build/run/teardown cycle in one call::

    outs, report = serve(requests, replicas=2, cache=True)

``ServeConfig`` + ``build()`` + ``Server.serve()``/``session()`` (and the
:func:`serve` convenience over them) are the *only* serving entry points —
the PR-1/PR-2 era ``run_pipelined``/``LMServer.serve_stream`` shims have
been removed. Optional subsystems all switch on the same way
(``cache=``/``capacity=``/``trace=`` accept None/bool/dict/config — see
:mod:`repro_torch.serve.config`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.serve.cache import (CacheConfig, CachedResult, NegativeResult,
                               ResultCache, request_key)
from repro_torch.serve.capacity import CapacityConfig
from repro_torch.serve.engine import (Completion, LMServer, Request,
                                form_batch_groups)
from repro_torch.serve.group import EngineGroup, RoutingPolicy
from repro_torch.serve.metrics import MetricsCollector, RunReport
from repro_torch.serve.scheduler import (AsyncScheduler, BackpressurePolicy,
                                   SchedulerConfig)
from repro_torch.serve.trace import TraceConfig, Tracer, TraceReport


@dataclass
class ServeConfig:
    """Everything needed to stand up a (possibly sharded) serving stack.

    Model / engine:
      ``model``       — architecture id (``repro_torch.configs``) or a
                        ``ModelConfig`` instance.
      ``reduced``     — apply ``ModelConfig.reduced()`` (CPU-sized) first.
      ``device``      — where ``build()`` places the ``LMServer`` (and
                        draws its parameters) when ``devices`` is not
                        given; ``"cuda"`` unless the caller asks for
                        ``"cpu"``.
      ``server_factory`` — optional ``idx -> engine`` override; when set,
                        ``model``/``max_seq``/... are ignored and one
                        engine is built per replica (simulation, tests).
      ``warmup``      — batch-size buckets to pre-compile at build time
                        (``True`` = engine default; ``False`` = skip).

    Replica topology (first non-default wins: mesh > devices > replicas):
      ``mesh``/``mesh_axis`` — one replica per mesh slice along the axis;
                        raises until ``sharding/specs.py`` is ported
                        (ROADMAP queue 1, item 11).
      ``devices``     — one replica pinned per listed device
                        (``torch.device`` or its spelling); the
                        ``LMServer`` is built on the first.
      ``replicas``    — N colocated replicas sharing the default device.
      ``routing``     — ``least_loaded`` (default), ``sticky``, or
                        ``hit_aware`` (cache-ownership affinity guarded by
                        ``spill_threshold``/``straggler_factor``/
                        ``ewma_alpha`` — see
                        :class:`~repro_torch.serve.group.RoutingPolicy`).
      ``delay``       — optional ``repro_torch.ft.failures.DelayInjector`` applied
                        per replica (straggler studies).

    Batching / admission (the AsyncScheduler knobs):
      ``target_batch``, ``deadline``, ``max_queue``, ``policy``
      (:class:`BackpressurePolicy` or its string value), ``pipeline_depth``.

    Result caching (off by default — the stack is bit-identical to its
    uncached behavior when ``cache`` is None):
      ``cache``       — ``CacheConfig`` (or ``True`` for defaults / a
                        kwargs dict) enabling the content-addressed
                        result cache + in-flight coalescing; one
                        :class:`~repro_torch.serve.cache.ResultCache` instance
                        is shared by every replica, ``serve()`` call, and
                        live session of the built ``Server``.

    Capacity control (off by default — same bit-identity guarantee):
      ``capacity``    — ``CapacityConfig`` (or ``True`` for defaults / a
                        kwargs dict) attaching a
                        :class:`~repro_torch.serve.capacity.CapacityController`
                        to every live session: online bottleneck
                        diagnosis + adaptive batch-target / replica-set /
                        admission-limit control.

    Tracing (off by default — same bit-identity guarantee):
      ``trace``       — ``TraceConfig`` (or ``True`` for defaults / a
                        kwargs dict) recording per-request lifecycle
                        spans into one shared
                        :class:`~repro_torch.serve.trace.Tracer` (bounded ring
                        buffer); read back via :meth:`Server.trace_report`
                        / :meth:`Server.export_trace`.
    """
    model: Union[str, object] = "llama3.2-3b"
    reduced: bool = True
    device: object = "cuda"
    max_seq: int = 64
    seed: int = 0
    rule_filter: object = None
    pad_batches: bool = True
    server_factory: Optional[Callable[[int], object]] = None
    # warm these batch-size buckets at build time (True = engine default;
    # engines without a warmup method, e.g. SimServer, ignore it)
    warmup: Union[bool, Sequence[int]] = False
    # replica topology
    replicas: int = 1
    devices: Optional[Sequence] = None
    mesh: object = None
    mesh_axis: str = "data"
    routing: Union[str, RoutingPolicy] = RoutingPolicy.LEAST_LOADED
    delay: object = None
    # hit_aware guard knobs (inert under other routing policies)
    spill_threshold: int = 96
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.25
    # batching / admission
    target_batch: int = 8
    deadline: float = 0.05
    max_queue: int = 64
    policy: Union[str, BackpressurePolicy] = BackpressurePolicy.REJECT
    pipeline_depth: int = 2
    # result cache + coalescing (None/False = off, True = defaults,
    # dict/CacheConfig = explicit knobs)
    cache: Union[None, bool, dict, CacheConfig] = None
    # capacity control loop (None/False = off, True = defaults,
    # dict/CapacityConfig = explicit knobs)
    capacity: Union[None, bool, dict, CapacityConfig] = None
    # per-request tracing (None/False = off, True = defaults,
    # dict/TraceConfig = explicit knobs)
    trace: Union[None, bool, dict, TraceConfig] = None

    def __post_init__(self):
        # one shared coercion rule for every optional subsystem
        # (repro_torch.serve.config.coerce)
        self.cache = CacheConfig.coerce(self.cache)
        self.capacity = CapacityConfig.coerce(self.capacity)
        self.trace = TraceConfig.coerce(self.trace)

    def scheduler_config(self, **overrides) -> SchedulerConfig:
        base = dict(target_batch=self.target_batch, deadline=self.deadline,
                    max_queue=self.max_queue, policy=self.policy,
                    pipeline_depth=self.pipeline_depth,
                    routing=self.routing,
                    spill_threshold=self.spill_threshold,
                    straggler_factor=self.straggler_factor,
                    ewma_alpha=self.ewma_alpha, cache=self.cache,
                    capacity=self.capacity, trace=self.trace)
        base.update(overrides)
        return SchedulerConfig(**base)


class Server:
    """Facade over an :class:`EngineGroup`: deterministic stream serving
    (:meth:`serve`) and live async sessions (:meth:`session`/:meth:`submit`)
    share the replicas, the routing policy, and one ``MetricsCollector``."""

    def __init__(self, group: EngineGroup, cfg: ServeConfig,
                 metrics: Optional[MetricsCollector] = None):
        self.group = group
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else MetricsCollector()
        self._session: Optional[AsyncScheduler] = None
        # one ResultCache for the whole server: every serve() call, live
        # session, and replica shares it, so a result computed anywhere
        # serves hits everywhere
        self.cache: Optional[ResultCache] = \
            ResultCache(cfg.cache) if cfg.cache is not None else None
        # likewise one Tracer: serve() replays, live sessions, replica
        # workers, the cache, and the capacity controller all emit onto
        # the same timeline
        self.tracer: Optional[Tracer] = \
            Tracer(cfg.trace) if cfg.trace is not None else None

    # -- engine access --------------------------------------------------------
    @property
    def engine(self):
        """Replica 0's engine (capacity probes, direct generate_batch)."""
        return self.group.replicas[0].server

    @property
    def engines(self) -> List[object]:
        """Distinct engines across replicas (shared engines deduplicated)."""
        seen, out = set(), []
        for rep in self.group.replicas:
            if id(rep.server) not in seen:
                seen.add(id(rep.server))
                out.append(rep.server)
        return out

    def warmup(self, batch_sizes: Sequence[int] = (1, 8), **kw) -> None:
        """Pre-compile decode buckets on every distinct engine (no-op for
        engines without a ``warmup``, e.g. ``SimServer``)."""
        for eng in self.engines:
            fn = getattr(eng, "warmup", None)
            if fn is not None:
                fn(batch_sizes, **kw)

    # -- deterministic stream serving -----------------------------------------
    def serve(self, requests: Sequence[Request], *,
              mode: str = "pipelined") -> List[Completion]:
        """Serve an arrival-ordered request stream, deterministically.

        Batch composition is fixed by logical-time replay of the paper's
        deadline policy (``form_batch_groups``), so both modes run the
        exact same batch sequence:

        - ``mode="sync"``      — the baseline: prepare and execute strictly
          alternate on replica 0; the device idles during every host
          encode.
        - ``mode="pipelined"`` — batches are routed across all replicas,
          each with its own depth-``pipeline_depth`` host/device pipeline.

        **Bit-identity guarantee:** every replica serves the same model
        (same params), rows of a batch are independent (masked attention,
        power-of-two padding), and batch composition does not depend on
        wall-clock timing — so for any replica count and either routing
        policy (use ``sticky`` when the *placement* must also replay
        deterministically), ``mode="pipelined"`` returns completions
        bit-identical to ``mode="sync"``. Only throughput differs.

        With tracing configured (``ServeConfig.trace``), encode /
        dispatch / device-execute spans and completion/drop marks land in
        the server's shared :class:`~repro_torch.serve.trace.Tracer` (submit-
        side stages only exist in live sessions, so a replayed stream has
        no queue-wait spans).

        With a result cache configured (``ServeConfig.cache``), a
        content-addressed pre-pass runs over the stream first: requests
        whose key is already cached are served without executing
        (``cache_hit``), later duplicates of an uncached key ride on the
        first occurrence (``coalesced``), and only the remaining unique
        leaders flow through the batch pipeline. TTL is judged against
        each request's *logical* arrival time, so a seeded stream always
        replays the same hit/miss/eviction sequence — and because minted
        completions carry the leader's exact tokens, the cached run stays
        bit-identical per rid to the uncached one.
        """
        if mode not in ("pipelined", "sync"):
            raise ValueError(
                f"mode must be 'pipelined' or 'sync', got {mode!r}")
        if self.cache is None:
            return self._execute_stream(requests, mode)
        return self._serve_cached(requests, mode)

    def _execute_stream(self, requests: Sequence[Request],
                        mode: str) -> List[Completion]:
        """The uncached replay path (exactly PR 2's ``serve`` body)."""
        groups = form_batch_groups(requests,
                                   target_batch=self.cfg.target_batch,
                                   deadline=self.cfg.deadline)
        if mode == "pipelined":
            return self.group.run_groups(
                groups, pipeline_depth=self.cfg.pipeline_depth,
                metrics=self.metrics, tracer=self.tracer,
                cache=self.cache)
        eng = self.engine
        out: List[Completion] = []
        for rs in groups:
            te0 = time.perf_counter()
            pb = eng.prepare_batch(rs)
            te1 = time.perf_counter()
            comps = eng.execute_prepared(pb)
            td1 = time.perf_counter()
            rids = [r.rid for r in rs]
            self.metrics.on_encode(rids, te0, te1)
            self.metrics.on_device(rids, te1, td1, replica=0)
            self.metrics.on_complete([c.rid for c in comps], td1)
            if self.tracer is not None:
                self.tracer.span("encode", te0, te1, rids=rids)
                self.tracer.span("device_execute", te1, td1, replica=0,
                                 rids=rids)
                done = {c.rid for c in comps}
                for c in comps:
                    self.tracer.mark("complete", td1, rid=c.rid, replica=0)
                for rid in rids:
                    if rid not in done:            # MCT filter drop
                        self.tracer.mark("drop", td1, rid=rid, replica=0,
                                         reason="filtered")
            out.extend(comps)
        return out

    def _serve_cached(self, requests: Sequence[Request],
                      mode: str) -> List[Completion]:
        """Content-addressed pre-pass + leader execution + cache fill.

        The cache clock is the stream's logical arrival time (TTL replays
        deterministically); metrics timestamps stay on the wall clock the
        rest of the replay path uses.
        """
        coalesce = self.cache.cfg.coalesce
        ttl = self.cache.cfg.ttl
        hits: List = []                       # (req, entry) pairs
        leaders: List[Request] = []
        key_of: Dict[int, str] = {}           # leader rid -> content key
        # key -> (leader rid, leader arrival) for this stream; a later
        # duplicate only coalesces if its logical gap to the leader is
        # within TTL — past that, the leader's result would already be
        # stale, so the duplicate becomes a fresh leader
        stream_leader: Dict[str, tuple] = {}
        followers: Dict[int, List[Request]] = {}
        for r in sorted(requests, key=lambda q: q.arrival):
            key = request_key(r)
            entry = self.cache.get(key, r.arrival, metrics=self.metrics)
            if isinstance(entry, NegativeResult):
                # content is known-filtered (negative cache): drop it
                # without encoding or executing, like the engine would
                self.metrics.on_cache("negative_hits")
                if self.tracer is not None:
                    t = time.perf_counter()
                    self.tracer.mark("cache_lookup", t, rid=r.rid,
                                     outcome="negative_hit")
                    self.tracer.mark("negative_drop", t, rid=r.rid)
                continue
            if entry is not None:
                hits.append((r, entry))
                t = time.perf_counter()
                self.metrics.on_cache_hit(r.rid, t, replica=entry.replica)
                self.metrics.on_complete([r.rid], t)
                if self.tracer is not None:
                    self.tracer.mark("cache_lookup", t, rid=r.rid,
                                     outcome="hit")
                    self.tracer.mark("complete", t, rid=r.rid,
                                     source="cache")
                continue
            lead = stream_leader.get(key) if coalesce else None
            if lead is not None and (ttl is None
                                     or r.arrival - lead[1] <= ttl):
                followers.setdefault(lead[0], []).append(r)
                t = time.perf_counter()
                self.metrics.on_coalesce(r.rid, lead[0], t)
                if self.tracer is not None:
                    self.tracer.mark("coalesce", t, rid=r.rid,
                                     leader=lead[0])
                continue
            stream_leader[key] = (r.rid, r.arrival)
            key_of[r.rid] = key
            leaders.append(r)
            self.metrics.on_cache_miss(r.rid)
            if self.tracer is not None:
                self.tracer.mark("cache_lookup", time.perf_counter(),
                                 rid=r.rid, outcome="miss")
        comps = self._execute_stream(leaders, mode) if leaders else []
        done = {c.rid: c for c in comps}
        out: List[Completion] = list(comps)
        for r in leaders:
            c = done.get(r.rid)
            foll = followers.get(r.rid, [])
            if c is None:
                # leader was filtered out (MCT): its followers drop with
                # it, and the verdict is remembered (negative_ttl) so the
                # same doomed content skips execution on its next arrival
                if foll:
                    self.metrics.on_cache("follower_drops", len(foll))
                    if self.tracer is not None:
                        t = time.perf_counter()
                        for f in foll:
                            self.tracer.mark("follower_drop", t,
                                             rid=f.rid, leader=r.rid)
                self.cache.put_negative(key_of[r.rid], r.arrival,
                                        metrics=self.metrics)
                continue
            entry = CachedResult.of(
                c, replica=self.metrics.replica_of(c.rid), now=r.arrival)
            self.cache.put(key_of[r.rid], entry, metrics=self.metrics)
            t = time.perf_counter()
            for f in foll:
                out.append(entry.mint(f.rid))
                self.metrics.on_complete([f.rid], t)
                if self.tracer is not None:
                    self.tracer.mark("complete", t, rid=f.rid,
                                     source="coalesce")
        out.extend(entry.mint(r.rid) for r, entry in hits)
        self.metrics.note_cache_bytes(self.cache.bytes_resident,
                                      len(self.cache))
        return out

    # -- live async serving ----------------------------------------------------
    def session(self, *, metrics: Optional[MetricsCollector] = None,
                **overrides) -> AsyncScheduler:
        """A fresh live serving session (bounded admission + backpressure)
        over the shared replicas. ``overrides`` patch the scheduler knobs
        for this session only (e.g. ``policy="block"``)."""
        return AsyncScheduler(
            self.group, self.cfg.scheduler_config(**overrides),
            metrics=metrics if metrics is not None else MetricsCollector(),
            cache=self.cache, tracer=self.tracer)

    def submit(self, req: Request, **kw) -> bool:
        """Submit to the server's default live session (created lazily,
        sharing ``self.metrics``); drain with :meth:`result`."""
        if self._session is None:
            self._session = AsyncScheduler(
                self.group, self.cfg.scheduler_config(),
                metrics=self.metrics, cache=self.cache,
                tracer=self.tracer)
        return self._session.submit(req, **kw)

    def result(self) -> List[Completion]:
        if self._session is None:
            return []
        out = self._session.result()
        self._session = None        # sessions are one-shot; allow another
        return out

    def close(self) -> None:
        """Reap the default session's pipeline threads (idempotent,
        swallows pipeline errors — use :meth:`result` to surface them).
        Safe to call with no session open."""
        s, self._session = self._session, None
        if s is not None:
            s.shutdown()

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # whether the body raised or not, never leak the pipeline thread
        self.close()
        return False

    def report(self, *, offered_qps: Optional[float] = None) -> RunReport:
        if self.cache is not None:
            self.metrics.note_cache_bytes(self.cache.bytes_resident,
                                          len(self.cache))
        return self.metrics.report(offered_qps=offered_qps)

    # -- tracing ---------------------------------------------------------------
    def trace_report(self) -> Optional[TraceReport]:
        """Per-stage latency percentiles + per-replica straggler
        attribution derived from the shared tracer's spans; None when
        ``ServeConfig.trace`` is off."""
        return self.tracer.report() if self.tracer is not None else None

    def export_trace(self, path: str, *, fmt: str = "chrome") -> str:
        """Write the recorded spans: ``fmt="chrome"`` (load the file in
        ``chrome://tracing`` / Perfetto) or ``fmt="jsonl"`` (one span per
        line). Returns ``path``."""
        if self.tracer is None:
            raise RuntimeError(
                "tracing is off; enable with ServeConfig(trace=True)")
        if fmt == "chrome":
            return self.tracer.export_chrome(path)
        if fmt == "jsonl":
            return self.tracer.export_jsonl(path)
        raise ValueError(f"fmt must be 'chrome' or 'jsonl', got {fmt!r}")


def build(cfg: ServeConfig) -> Server:
    """Construct the full serving stack from one config: engines (or take
    them from ``cfg.server_factory``), the replica :class:`EngineGroup`,
    and the shared :class:`MetricsCollector`."""
    knobs = dict(spill_threshold=cfg.spill_threshold,
                 straggler_factor=cfg.straggler_factor,
                 ewma_alpha=cfg.ewma_alpha)
    if cfg.server_factory is not None:
        servers = [cfg.server_factory(i) for i in range(max(1, cfg.replicas))]
        group = EngineGroup.from_servers(servers, routing=cfg.routing,
                                         delay=cfg.delay, **knobs)
        srv = Server(group, cfg)
    else:
        model = cfg.model
        if isinstance(model, str):
            from repro_torch.configs.base import get_config
            model = get_config(model)
        if cfg.reduced:
            model = model.reduced()
        device = cfg.devices[0] if cfg.devices else cfg.device
        server = LMServer(model, device=device, max_seq=cfg.max_seq,
                          seed=cfg.seed, rule_filter=cfg.rule_filter,
                          pad_batches=cfg.pad_batches)
        if cfg.mesh is not None:
            group = EngineGroup.from_mesh(server, cfg.mesh,
                                          axis=cfg.mesh_axis,
                                          routing=cfg.routing,
                                          delay=cfg.delay, **knobs)
        else:
            group = EngineGroup.from_server(server, devices=cfg.devices,
                                            replicas=cfg.replicas,
                                            routing=cfg.routing,
                                            delay=cfg.delay, **knobs)
        srv = Server(group, cfg)
    if cfg.warmup:
        srv.warmup() if cfg.warmup is True else srv.warmup(tuple(cfg.warmup))
    return srv


def serve(requests: Sequence[Request], *, mode: str = "pipelined",
          offered_qps: Optional[float] = None,
          config: Optional[ServeConfig] = None,
          **config_kwargs) -> Tuple[List[Completion], RunReport]:
    """One-call serving: build the stack, serve the stream, tear it down.

    Keyword arguments are :class:`ServeConfig` fields (or pass a prebuilt
    ``config``); the server is built, the requests are served in ``mode``
    (``"pipelined"``/``"sync"``), the pipeline threads are reaped via the
    context manager, and ``(completions, RunReport)`` is returned::

        outs, report = serve(reqs, model="llama3.2-3b", replicas=2,
                             cache=True, trace=True)

    This is the convenience layer over ``build(cfg)`` + ``Server.serve``;
    use those directly when you need live sessions, a shared server
    across calls, or trace exports (the built ``Server`` owns the
    tracer).
    """
    if config is None:
        config = ServeConfig(**config_kwargs)
    elif config_kwargs:
        raise ValueError("pass either config or keyword overrides")
    with build(config) as srv:
        outs = srv.serve(requests, mode=mode)
        report = srv.report(offered_qps=offered_qps)
    return outs, report
