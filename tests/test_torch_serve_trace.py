"""Port of the serving stack, tracing and metrics: the cases of
``tests/test_trace.py`` run against ``repro_torch.serve`` and
``repro_torch.trace``, plus parity with the JAX package on the same
streams: sync-mode span sequences (stage, request, replica and tags, with
the cache on and off and with filtered drops), the lifecycle stage list,
and the ``RunReport``/``TraceReport`` counts equal the reference's.
"""
import json

import numpy as np
import pytest

import repro.serve as J
import repro.trace as JT
import repro_torch.trace as PT
from repro_torch.serve import (CacheConfig, CapacityConfig, MetricsCollector,
                               ReplicaTraceStats, ServeConfig, SimServer,
                               Span, TraceConfig, TraceReport, Tracer, build,
                               coerce, render_timeline, serve, sim_requests)
from repro_torch.serve.capacity import CapacityController
from repro_torch.serve.trace import LIFECYCLE_STAGES, chrome_events

assert ReplicaTraceStats is not None      # part of the public surface


def fast_sim(i=0, **kw):
    """Millisecond-scale sim engine so traced runs stay fast."""
    kw.setdefault("host_ms_per_batch", 0.5)
    kw.setdefault("device_ms_per_batch", 1.0)
    return SimServer(**kw)


class FilteringSim(SimServer):
    """SimServer that drops every request whose first token is 7 —
    exercises the engine-drop path (drop marks, negative caching)."""

    def execute_prepared(self, pb, *, device=None):
        comps = super().execute_prepared(pb, device=device)
        doomed = {r.rid for r in pb.requests if int(r.tokens[0]) == 7}
        return [c for c in comps if c.rid not in doomed]


# ---------------------------------------------------------------------------
# shared config coercion (satellite: one rule for cache/capacity/trace)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [CacheConfig, CapacityConfig, TraceConfig])
def test_coerce_rule_uniform_across_subsystems(cls):
    assert cls.coerce(None) is None
    assert cls.coerce(False) is None
    assert isinstance(cls.coerce(True), cls)
    inst = cls()
    assert cls.coerce(inst) is inst
    assert isinstance(cls.coerce({}), cls)
    with pytest.raises(ValueError, match=cls.__name__):
        cls.coerce(42)


def test_coerce_dict_sets_knobs_and_names_field_in_error():
    assert coerce(TraceConfig, {"capacity": 16}).capacity == 16
    with pytest.raises(ValueError, match="trace"):
        coerce(TraceConfig, "yes")
    with pytest.raises(ValueError, match="snapshots"):
        coerce(TraceConfig, "yes", field="snapshots")


def test_configs_coerce_on_construction():
    cfg = ServeConfig(server_factory=fast_sim, trace=True,
                      cache={"coalesce": False})
    assert isinstance(cfg.trace, TraceConfig)
    assert isinstance(cfg.cache, CacheConfig) and not cfg.cache.coalesce
    sch = cfg.scheduler_config(trace={"capacity": 32})
    assert sch.trace.capacity == 32


# ---------------------------------------------------------------------------
# Tracer mechanics
# ---------------------------------------------------------------------------

def test_ring_buffer_bound_and_drop_accounting():
    tr = Tracer({"capacity": 4})
    for i in range(10):
        tr.mark("submit", float(i), rid=i)
    assert len(tr) == 4
    assert tr.n_emitted == 10
    assert tr.n_dropped == 6
    assert [s.rid for s in tr.spans()] == [6, 7, 8, 9]   # oldest evicted
    rep = tr.report()
    assert rep.n_dropped == 6 and rep.n_spans == 4
    tr.clear()
    assert len(tr) == 0 and tr.n_dropped == 0


def test_span_properties_and_json_safety():
    s = Span("device_execute", 1.0, 1.002, replica=np.int64(1),
             meta={"rids": [np.int64(3)], "cost": np.float64(0.5)})
    assert s.duration_ms == pytest.approx(2.0)
    assert not s.is_mark
    d = s.as_dict()
    assert type(d["replica"]) is int
    assert type(d["meta"]["rids"][0]) is int
    assert type(d["meta"]["cost"]) is float
    json.dumps(d)                               # nothing numpy leaks out
    m = Span("submit", 1.0, 1.0, rid=4)
    assert m.is_mark and m.as_dict() == {"stage": "submit", "t0": 1.0,
                                         "t1": 1.0, "rid": 4}


def test_tracer_off_by_default_everywhere():
    srv = build(ServeConfig(server_factory=fast_sim, target_batch=4,
                            deadline=0.01))
    assert srv.tracer is None
    assert srv.trace_report() is None
    with pytest.raises(RuntimeError, match="trace"):
        srv.export_trace("/tmp/never.json")
    sched = srv.session()
    assert sched.tracer is None
    assert sched.trace_report() is None
    sched.result()


# ---------------------------------------------------------------------------
# bit-identity: trace=None and trace=True produce identical completions
# ---------------------------------------------------------------------------

def test_trace_on_is_bit_identical_to_off():
    reqs = sim_requests(24, max_new_tokens=4)
    base_kw = dict(server_factory=fast_sim, replicas=2, routing="sticky",
                   target_batch=4, deadline=0.01)
    with build(ServeConfig(**base_kw)) as plain:
        ref = {c.rid: c for c in plain.serve(reqs, mode="pipelined")}
    with build(ServeConfig(trace=True, **base_kw)) as traced:
        outs = traced.serve(reqs, mode="pipelined")
        assert traced.tracer is not None and len(traced.tracer) > 0
    assert sorted(c.rid for c in outs) == sorted(ref)
    for c in outs:
        np.testing.assert_array_equal(ref[c.rid].tokens, c.tokens)
        assert ref[c.rid].batch_size == c.batch_size


# ---------------------------------------------------------------------------
# reconciliation: TraceReport vs RunReport on the same run
# ---------------------------------------------------------------------------

def assert_stats_match(trace_stats, run_stats):
    assert trace_stats.n == run_stats.n
    for f in ("mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"):
        assert getattr(trace_stats, f) == \
            pytest.approx(getattr(run_stats, f), rel=1e-9, abs=1e-12)


def reconcile(sched_report, trace_report):
    """The cross-check the module docstring promises: spans reuse the
    exact timestamps handed to MetricsCollector, so the two reports'
    per-stage stats agree to float roundoff."""
    assert trace_report.counts.get("complete", 0) == \
        sched_report.n_completed
    assert trace_report.counts.get("shed", 0) == sched_report.n_shed
    assert trace_report.counts.get("reject", 0) == sched_report.n_rejected
    assert_stats_match(trace_report.stages["queue_wait"],
                       sched_report.breakdown["queue_wait"])
    assert_stats_match(trace_report.stages["encode"],
                       sched_report.breakdown["encode"])
    assert_stats_match(trace_report.stages["device_execute"],
                       sched_report.breakdown["device"])
    assert_stats_match(trace_report.stages["total"],
                       sched_report.breakdown["total"])
    for r, rs in sched_report.per_replica.items():
        ts = trace_report.per_replica.get(r)
        if rs.n_batches:
            assert ts is not None
            assert ts.n_batches == rs.n_batches
            assert ts.n_dispatches == rs.n_batches
            assert ts.n_requests == rs.n_requests
            assert ts.busy_s == pytest.approx(rs.busy_s, rel=1e-9)


def test_live_session_trace_reconciles_with_run_report():
    srv = build(ServeConfig(server_factory=fast_sim, replicas=2,
                            target_batch=4, deadline=0.005,
                            policy="block", max_queue=32, trace=True))
    sched = srv.session()
    for r in sim_requests(20, max_new_tokens=4):
        assert sched.submit(r)
    outs = sched.result()
    assert len(outs) == 20
    rep = sched.report()
    trep = sched.trace_report()
    assert trep is trep                       # same shared tracer object
    assert srv.tracer is sched.tracer
    reconcile(rep, trep)
    assert trep.counts["submit"] == 20
    assert trep.counts["admit"] == 20
    assert trep.dominant_stage() in ("queue_wait", "encode",
                                     "device_execute")
    assert "spans" in trep.summary() or trep.summary()


def test_shed_and_reject_counts_reconcile():
    srv = build(ServeConfig(server_factory=fast_sim, target_batch=4,
                            deadline=0.002, policy="reject", max_queue=4,
                            trace=True))
    sched = srv.session()
    for r in sim_requests(32, max_new_tokens=4):
        sched.submit(r)
    sched.result()
    rep, trep = sched.report(), sched.trace_report()
    reconcile(rep, trep)
    assert rep.n_rejected > 0                  # overload actually happened


def test_replay_trace_reconciles_and_covers_stages():
    reqs = sim_requests(16, max_new_tokens=4)
    srv = build(ServeConfig(server_factory=fast_sim, replicas=2,
                            routing="sticky", target_batch=4,
                            deadline=0.01, trace=True))
    with srv:
        outs = srv.serve(reqs, mode="pipelined")
    assert len(outs) == 16
    rep, trep = srv.report(), srv.trace_report()
    # replayed streams have no submit-side stages, but encode/device/
    # dispatch/complete must reconcile
    assert trep.counts["complete"] == rep.n_completed
    assert_stats_match(trep.stages["encode"], rep.breakdown["encode"])
    assert_stats_match(trep.stages["device_execute"],
                       rep.breakdown["device"])
    for r, rs in rep.per_replica.items():
        if rs.n_batches:
            assert trep.per_replica[r].n_batches == rs.n_batches
    stages = {s.stage for s in srv.tracer.spans()}
    assert {"encode", "dispatch", "device_execute", "complete"} <= stages
    assert all(s in LIFECYCLE_STAGES for s in stages)


def test_sync_mode_traces_on_replica_zero():
    srv = build(ServeConfig(server_factory=fast_sim, target_batch=4,
                            deadline=0.01, trace=True))
    srv.serve(sim_requests(8, max_new_tokens=4), mode="sync")
    devs = [s for s in srv.tracer.spans() if s.stage == "device_execute"]
    assert devs and all(s.replica == 0 for s in devs)
    trep = srv.trace_report()
    assert trep.counts["complete"] == 8
    assert_stats_match(trep.stages["device_execute"],
                       srv.report().breakdown["device"])


# ---------------------------------------------------------------------------
# cache + engine-drop events on the timeline
# ---------------------------------------------------------------------------

def test_cache_hit_and_coalesce_traced_live():
    srv = build(ServeConfig(server_factory=fast_sim, target_batch=4,
                            deadline=0.005, policy="block", max_queue=32,
                            cache=True, trace=True))
    reqs = sim_requests(24, max_new_tokens=4, unique_keys=4,
                        repeat_alpha=1.1)
    sched = srv.session()
    for r in reqs:
        sched.submit(r)
    outs = sched.result()
    assert len(outs) == 24
    rep, trep = sched.report(), sched.trace_report()
    assert trep.counts.get("cache_hit", 0) == rep.cache["hits"]
    # the lookup sees a raw miss for leaders AND for requests that then
    # coalesce onto one; RunReport splits those two
    assert trep.counts.get("cache_miss", 0) \
        == rep.cache["misses"] + rep.cache["coalesced"]
    assert trep.counts.get("coalesce", 0) == rep.cache["coalesced"]
    assert trep.counts.get("cache_store", 0) > 0
    # every request still completes exactly once on the trace timeline
    assert trep.counts["complete"] == rep.n_completed == 24
    reconcile(rep, trep)


def test_filtered_drop_and_negative_cache_traced():
    srv = build(ServeConfig(
        server_factory=lambda i: FilteringSim(host_ms_per_batch=0.5,
                                              device_ms_per_batch=1.0),
        target_batch=2, deadline=0.005, policy="block", max_queue=16,
        cache={"negative_ttl": 60.0}, trace=True))
    doomed = np.asarray([7, 1, 2, 3], np.int32)
    good = sim_requests(1, max_new_tokens=2)[0]
    from repro_torch.serve import Request
    srv.submit(Request(rid=100, tokens=doomed.copy(), max_new_tokens=2))
    srv.submit(good)
    srv.result()
    stages = {s.stage for s in srv.tracer.spans()}
    assert "drop" in stages                        # engine filtered rid 100
    drop = [s for s in srv.tracer.spans() if s.stage == "drop"][0]
    assert drop.rid == 100 and drop.meta["reason"] == "filtered"
    # second arrival of the same doomed content: negative hit at submit
    srv.submit(Request(rid=101, tokens=doomed.copy(), max_new_tokens=2))
    srv.result()
    spans = srv.tracer.spans()
    neg = [s for s in spans if s.stage == "negative_drop"]
    assert [s.rid for s in neg] == [101]
    assert any(s.stage == "cache_store" and (s.meta or {}).get("negative")
               for s in spans)
    trep = srv.trace_report()
    assert trep.counts.get("cache_negative_hit", 0) == 1


# ---------------------------------------------------------------------------
# capacity-controller actions land on the same timeline
# ---------------------------------------------------------------------------

class ScriptedActuator:
    """Minimal capacity-protocol actuator for driving ticks by hand."""

    def __init__(self):
        self.state = {"queue_depth": 10, "target_batch": 8,
                      "admission_limit": 16, "n_active": 2,
                      "n_replicas": 2, "replica_depths": (1, 1)}

    def capacity_state(self):
        return dict(self.state)

    def set_target_batch(self, n):
        self.state["target_batch"] = n

    def set_admission_limit(self, n):
        self.state["admission_limit"] = n

    def set_active_replicas(self, n):
        self.state["n_active"] = n
        return n


def test_controller_actions_become_trace_events():
    metrics = MetricsCollector()
    tracer = Tracer()
    ctl = CapacityController(ScriptedActuator(),
                             CapacityConfig(confirm=1, window_s=10.0),
                             metrics=metrics, tracer=tracer,
                             clock=lambda: 0.0)
    ctl.tick(now=0.0)                       # priming snapshot
    # host-saturated window: 9s encode busy, 1s device busy over 10s
    for i in range(20):
        metrics.on_arrival(i, 0.0)
    metrics.on_encode(list(range(20)), 0.0, 9.0)
    metrics.on_device(list(range(20)), 9.0, 10.0, replica=0)
    diag = ctl.tick(now=10.0)
    assert str(diag) == "host_bound"
    assert ctl.actions, "host-bound diagnosis must act"
    marks = [s for s in tracer.spans() if s.stage == "controller"]
    assert len(marks) == len(ctl.actions)
    for mark, act in zip(marks, ctl.actions):
        assert mark.meta["action"] == act.action
        assert mark.meta["diagnosis"] == act.diagnosis
        assert mark.meta["before"] == act.before
        assert mark.meta["after"] == act.after


# ---------------------------------------------------------------------------
# rendering + exporters
# ---------------------------------------------------------------------------

def test_render_timeline_shows_lifecycle():
    srv = build(ServeConfig(server_factory=fast_sim, target_batch=4,
                            deadline=0.005, policy="block", max_queue=32,
                            trace=True))
    sched = srv.session()
    reqs = sim_requests(6, max_new_tokens=2)
    for r in reqs:
        sched.submit(r)
    sched.result()
    line = sched.tracer.timeline(reqs[0].rid)
    assert line.startswith(f"rid {reqs[0].rid}:")
    for stage in ("submit@", "admit@", "queue_wait[", "encode[",
                  "device_execute", "complete"):
        assert stage in line
    assert render_timeline([], 999) == "rid 999: (no spans)"


def test_chrome_export_structure(tmp_path):
    srv = build(ServeConfig(server_factory=fast_sim, replicas=2,
                            target_batch=4, deadline=0.005,
                            policy="block", max_queue=32, trace=True))
    sched = srv.session()
    for r in sim_requests(12, max_new_tokens=2):
        sched.submit(r)
    sched.result()
    path = srv.export_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        payload = json.load(f)
    evs = payload["traceEvents"]
    assert payload["displayTimeUnit"] == "ms"
    phases = {e["ph"] for e in evs}
    assert {"M", "X", "i", "b", "e"} <= phases
    # process + lane naming metadata
    procs = [e for e in evs if e["ph"] == "M"
             and e["name"] == "process_name"]
    assert procs and procs[0]["args"]["name"] == "repro_torch.serve"
    lanes = {e["args"]["name"] for e in evs if e["ph"] == "M"
             and e["name"] == "thread_name"}
    assert "host-encode" in lanes and any(lane.startswith("replica-")
                                          for lane in lanes)
    # device spans live on per-replica lanes (tid 10+replica)
    dev = [e for e in evs if e.get("name") == "device_execute"]
    assert dev and all(e["tid"] >= 10 and e["ph"] == "X" for e in dev)
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in dev)
    # queue waits are async begin/end pairs keyed by rid
    b = [e for e in evs if e["ph"] == "b"]
    e_ = [e for e in evs if e["ph"] == "e"]
    assert len(b) == len(e_) > 0
    assert {x["id"] for x in b} == {x["id"] for x in e_}
    assert chrome_events([]) == []


def test_jsonl_export_roundtrips(tmp_path):
    srv = build(ServeConfig(server_factory=fast_sim, target_batch=4,
                            deadline=0.01, trace=True))
    srv.serve(sim_requests(8, max_new_tokens=2), mode="pipelined")
    path = srv.export_trace(str(tmp_path / "trace.jsonl"), fmt="jsonl")
    rows = [json.loads(line) for line in open(path)]
    assert len(rows) == len(srv.tracer)
    assert all(r["stage"] in LIFECYCLE_STAGES for r in rows)
    assert all(r["t1"] >= r["t0"] for r in rows)
    with pytest.raises(ValueError, match="fmt"):
        srv.export_trace(str(tmp_path / "x"), fmt="yaml")


# ---------------------------------------------------------------------------
# serve() convenience carries trace/cache configs like any other knob
# ---------------------------------------------------------------------------

def test_serve_convenience_with_trace_and_cache():
    outs, rep = serve(sim_requests(12, max_new_tokens=2, unique_keys=3,
                                   repeat_alpha=1.0),
                      server_factory=fast_sim, target_batch=4,
                      deadline=0.01, cache=True, trace=True)
    assert len(outs) == 12
    assert rep.n_completed == 12
    assert rep.cache["hits"] + rep.cache["misses"] \
        + rep.cache["coalesced"] == 12


# ---------------------------------------------------------------------------
# property test: reconciliation holds across seeded workload shapes
# (hypothesis when available, a deterministic grid otherwise)
# ---------------------------------------------------------------------------

def check_seeded_run_reconciles(n, target_batch, replicas, seed):
    srv = build(ServeConfig(
        server_factory=lambda i: SimServer(host_ms_per_batch=0.2,
                                           device_ms_per_batch=0.4),
        replicas=replicas, target_batch=target_batch, deadline=0.003,
        policy="block", max_queue=64, trace=True))
    sched = srv.session()
    for r in sim_requests(n, max_new_tokens=2, rid_base=seed):
        sched.submit(r)
    outs = sched.result()
    assert len(outs) == n
    rep, trep = sched.report(), sched.trace_report()
    reconcile(rep, trep)
    assert trep.counts["submit"] == n
    assert TraceReport.from_spans(sched.tracer.spans()).counts \
        == trep.counts


@pytest.mark.parametrize("n,target_batch,replicas,seed", [
    (1, 1, 1, 0), (5, 3, 2, 11), (16, 6, 3, 42), (9, 2, 2, 1000),
    (12, 4, 1, 7),
])
def test_trace_reconciles_seeded_grid(n, target_batch, replicas, seed):
    check_seeded_run_reconciles(n, target_batch, replicas, seed)


try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    pass
else:
    @settings(max_examples=8, deadline=None)
    @given(n=st.integers(min_value=1, max_value=16),
           target_batch=st.integers(min_value=1, max_value=6),
           replicas=st.integers(min_value=1, max_value=3),
           seed=st.integers(min_value=0, max_value=2 ** 16))
    def test_trace_reconciles_for_any_seeded_run(n, target_batch,
                                                 replicas, seed):
        check_seeded_run_reconciles(n, target_batch, replicas, seed)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _filtering(pkg):
    class _F(pkg.SimServer):
        def __init__(self):
            super().__init__(host_ms_per_batch=0.0, device_ms_per_batch=0.0)

        def execute_prepared(self, pb, *, device=None):
            comps = super().execute_prepared(pb, device=device)
            doomed = {r.rid for r in pb.requests if int(r.tokens[0]) == 7}
            return [c for c in comps if c.rid not in doomed]
    return _F


def _span_key(s):
    """A span without its clock readings."""
    meta = {k: v for k, v in (s.meta or {}).items()}
    return (s.stage, s.rid, s.replica, json.dumps(meta, sort_keys=True,
                                                  default=str))


TRACE_CASES = [dict(), dict(cache=True),
               dict(cache={"negative_ttl": 60.0, "ttl": 0.5})]


@pytest.mark.parametrize("case", range(len(TRACE_CASES)))
def test_sync_span_sequence_equals_reference(case):
    import repro_torch.serve as P

    def run(pkg):
        srv = pkg.build(pkg.ServeConfig(
            server_factory=lambda i: _filtering(pkg)(), target_batch=4,
            deadline=0.01, trace=True, **TRACE_CASES[case]))
        for w, t0 in enumerate((0.0, 0.2, 2.0)):
            reqs = pkg.sim_requests(10, max_new_tokens=3, unique_keys=4,
                                    content_seed=5, rid_base=100 * w,
                                    arrivals=t0 + np.arange(10) * 2e-3)
            reqs[3].tokens = np.asarray([7, 1, 2], np.int32)   # filtered
            srv.serve(reqs, mode="sync")
        rep, trep = srv.report(), srv.trace_report()
        return ([_span_key(s) for s in srv.tracer.spans()],
                dict(trep.counts), rep.cache, rep.n_completed,
                sorted(trep.stages))
    got, want = run(P), run(J)
    assert got == want
    assert "device_execute" in got[1] and "drop" in got[1]


def test_trace_reexports_equal_reference():
    assert PT.LIFECYCLE_STAGES == JT.LIFECYCLE_STAGES
    assert set(PT.__all__) == set(JT.__all__)
    import repro.capacity as JC
    import repro_torch.capacity as PC
    assert set(PC.__all__) == set(JC.__all__)


def test_latency_stats_equal_reference():
    import repro_torch.serve as P
    v = list(np.random.default_rng(3).exponential(5.0, 101))
    assert P.LatencyStats.of(v).as_dict() == J.LatencyStats.of(v).as_dict()
    assert P.LatencyStats.of([]).as_dict() == J.LatencyStats.of([]).as_dict()
