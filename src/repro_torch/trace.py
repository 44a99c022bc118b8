"""Top-level re-exports of the request-tracing subsystem.

``repro_torch.trace`` is the public face of :mod:`repro_torch.serve.trace` —
per-request lifecycle tracing for the serving stack: bounded
:class:`Tracer` ring of :class:`Span` records (submit → cache_lookup /
coalesce → admit → queue_wait → encode → dispatch → device_execute →
complete | shed | drop | negative_drop, plus capacity-controller
actions), :class:`TraceReport` per-stage latency percentiles with
per-replica straggler attribution, an ASCII per-request timeline
(:func:`render_timeline`), and Chrome ``trace_event`` / JSONL
exporters. See that module's docstring for the full story; enable in a
serving stack with ``ServeConfig(trace=True)`` (default off — the
disabled stack is bit-identical to the untraced one).

Port of ``repro.trace``.
"""
from repro_torch.serve.trace import (LIFECYCLE_STAGES, ReplicaTraceStats, Span,
                               TraceConfig, TraceReport, Tracer,
                               chrome_events, render_timeline)

__all__ = [
    "LIFECYCLE_STAGES", "ReplicaTraceStats", "Span", "TraceConfig",
    "TraceReport", "Tracer", "chrome_events", "render_timeline",
]
