"""Serving subsystem: multi-replica serving behind one front end.

Port of ``repro.serve``, with the same exports. One config, one call:

    from repro_torch.serve import ServeConfig, build, serve
    srv = build(ServeConfig(model="llama3.2-3b", replicas=2))
    srv.serve(requests, mode="pipelined")     # deterministic replay
    sched = srv.session()                     # live bounded-admission serving
    outs, report = serve(requests, replicas=2)  # one-call convenience

Built servers run on the card (``device="cuda"``) unless the config asks
for ``device="cpu"``. Modules: ``server`` (ServeConfig, build, serve),
``engine`` (LMServer and its prepare/execute split), ``group``
(EngineGroup, replica routing), ``scheduler`` (AsyncScheduler, bounded
admission), ``trace``, ``config``, ``cache``, ``capacity``, ``sim``
(SimServer), ``loadgen`` and ``metrics``; see each module's docstring.
"""
from repro_torch.serve.cache import (CacheConfig, CachedResult, Coalescer,
                                     NegativeResult, ResultCache,
                                     request_key)
from repro_torch.serve.capacity import (Bottleneck, BottleneckMonitor,
                                        CapacityConfig, CapacityController,
                                        CapacitySignals, ControllerAction,
                                        CostReport)
from repro_torch.serve.engine import (Completion, LMServer, PreparedBatch,
                                      Request, form_batch_groups)
from repro_torch.serve.group import (EngineGroup, GroupRun, Replica,
                                     RoutingPolicy, batch_work)
from repro_torch.serve.loadgen import (ClosedLoopGen, OpenLoopGen,
                                       PhasedOpenLoopGen, SyntheticWorkload,
                                       poisson_arrivals, uniform_arrivals,
                                       zipf_probs)
from repro_torch.serve.metrics import (LatencyStats, MetricsCollector,
                                       ReplicaStats, RequestTrace, RunReport,
                                       SignalSnapshot)
from repro_torch.serve.config import Coercible, coerce
from repro_torch.serve.scheduler import (AsyncScheduler, BackpressurePolicy,
                                         SchedulerConfig)
from repro_torch.serve.server import ServeConfig, Server, build, serve
from repro_torch.serve.sim import (SIM_PROFILES, SimProfile, SimServer,
                                   sim_requests)
from repro_torch.serve.trace import (ReplicaTraceStats, Span, TraceConfig,
                                     TraceReport, Tracer, render_timeline)

__all__ = [
    "CacheConfig", "CachedResult", "Coalescer", "NegativeResult",
    "ResultCache", "request_key",
    "Bottleneck", "BottleneckMonitor", "CapacityConfig",
    "CapacityController", "CapacitySignals", "ControllerAction",
    "CostReport",
    "Completion", "LMServer", "PreparedBatch", "Request",
    "form_batch_groups",
    "EngineGroup", "GroupRun", "Replica", "RoutingPolicy", "batch_work",
    "ClosedLoopGen", "OpenLoopGen", "PhasedOpenLoopGen",
    "SyntheticWorkload",
    "poisson_arrivals", "uniform_arrivals", "zipf_probs",
    "LatencyStats", "MetricsCollector", "ReplicaStats", "RequestTrace",
    "RunReport", "SignalSnapshot",
    "AsyncScheduler", "BackpressurePolicy", "SchedulerConfig",
    "ServeConfig", "Server", "build", "serve",
    "SIM_PROFILES", "SimProfile", "SimServer", "sim_requests",
    "Coercible", "coerce",
    "ReplicaTraceStats", "Span", "TraceConfig", "TraceReport", "Tracer",
    "render_timeline",
]
