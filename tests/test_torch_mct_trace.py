"""Spans of the MCT path in the port's Tracer, on the CPU: the wrapper's
stages on the same clock readings as StageTimes, with the worker thread's
CPU time, the hand-off back to the caller, and the host side of
ErbiumEngine.match tiled by its lane spans. With no tracer the path reads no
CPU clock, makes no span and answers bit for bit as the traced run does."""
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core.aggregator import Batch
from repro_torch.core.compiler import compile_rules
from repro_torch.core.engine import ErbiumEngine
from repro_torch.core.rules import generate_queries, generate_rules
from repro_torch.core.wrapper import MCTWrapper
from repro_torch.kernels.rule_match import SORT_MAX
from repro_torch.serve import trace as trace_mod
from repro_torch.serve.trace import (LIFECYCLE_STAGES, TraceConfig,
                                     TraceReport, Tracer, chrome_events)

WRAPPER_STAGES = ("queue_wait", "encode", "dispatch", "device_execute",
                  "collect")
LANE_STAGES = ("lane.upload", "lane.sort", "lane.launch", "lane.lookup")
CPU_SLACK_US = 50.0


@pytest.fixture(scope="module")
def system():
    rules = generate_rules(200, version=2, seed=11)
    table = compile_rules(rules)
    queries = generate_queries(rules, 2 * SORT_MAX + 104, seed=12)
    return table, queries


def _engine(table, tracer=None, **kw):
    return ErbiumEngine(table, device="cpu", tile_r=128, tracer=tracer, **kw)


def _batches(queries, sizes):
    out, off = [], 0
    for uid, n in enumerate(sizes):
        out.append(Batch(uid, queries[off:off + n], [0] * n))
        off += n
    return out


def _run_wrapper(table, queries, n_workers, tracer, sizes=(64, 17, 128, 5)):
    eng = _engine(table, tracer)
    wrap = MCTWrapper([eng], n_workers=n_workers, tracer=tracer)
    wrap.start()
    try:
        for b in _batches(queries, sizes):
            wrap.submit(b)
        results = wrap.drain(len(sizes), timeout=60)
    finally:
        wrap.stop()
    return sorted(results, key=lambda r: r.uid)


@pytest.mark.parametrize("n_workers", [1, 2])
def test_wrapper_spans_are_the_stage_times(system, n_workers):
    table, queries = system
    tr = Tracer(TraceConfig(capacity=1 << 16))
    results = _run_wrapper(table, queries, n_workers, tr)
    spans = tr.spans()
    assert tr.n_dropped == 0
    for res in results:
        mine = [s for s in spans if s.stage in WRAPPER_STAGES
                and s.meta["uid"] == res.uid]
        assert [s.stage for s in mine] == list(WRAPPER_STAGES)
        for a, b in zip(mine, mine[1:]):
            assert b.t0 == a.t1
        st = res.times
        for s, us in zip(mine, (st.queue_us, st.encode_us, st.dispatch_us,
                                st.kernel_us, st.collect_us)):
            assert abs((s.t1 - s.t0) * 1e6 - us) < 1e-3
            assert s.replica == 0
            assert s.meta["n"] == st.batch == len(res.decisions)
            assert s.meta["worker"] in range(n_workers)
            if s.stage == "queue_wait":
                assert "cpu_us" not in s.meta
            else:
                wall = (s.t1 - s.t0) * 1e6
                assert 0.0 <= s.meta["cpu_us"] <= wall + CPU_SLACK_US
        assert mine[-1].t1 == res.t_done
        hand = [s for s in spans if s.stage == "handoff"
                and s.meta["uid"] == res.uid]
        assert len(hand) == 1 and hand[0].t0 == res.t_done
        assert hand[0].t1 >= hand[0].t0 and hand[0].meta["n"] == st.batch
        assert len({s.meta["worker"] for s in mine}) == 1


def test_synchronous_process_has_no_worker(system):
    table, queries = system
    tr = Tracer()
    eng = _engine(table, tr)
    res = MCTWrapper([eng], tracer=tr).process(_batches(queries, [32])[0])
    stages = [s for s in tr.spans() if s.stage in WRAPPER_STAGES]
    assert [s.stage for s in stages] == list(WRAPPER_STAGES)
    assert all(s.meta["worker"] is None for s in stages)
    assert stages[-1].t1 == res.t_done
    assert not [s for s in tr.spans() if s.stage == "handoff"]


# (engine options, batch size, lane.sort spans expected)
LANE_CASES = [
    (dict(), 256, 0),
    (dict(), SORT_MAX, 0),
    (dict(), SORT_MAX + 1, 1),
    (dict(n_engines=2), SORT_MAX + 2, 0),
    (dict(n_engines=2), 2 * SORT_MAX + 104, 2),
    (dict(backend="ref"), SORT_MAX + 1, 0),
]


@pytest.mark.parametrize("opts,B,n_sorts", LANE_CASES)
def test_lane_spans_tile_match(system, opts, B, n_sorts):
    table, queries = system
    tr = Tracer()
    eng = _engine(table, tr, **opts)
    enc = eng.encode_queries_host(queries[:B])
    for _ in range(2):
        eng.match(enc)
    spans = tr.spans()
    matches = [s for s in spans if s.stage == "match"]
    assert len(matches) == 2
    lanes = [s for s in spans if s.stage in LANE_STAGES]
    per_call = len(lanes) // 2
    for k, m in enumerate(matches):
        mine = lanes[k * per_call:(k + 1) * per_call]
        assert mine[0].stage == "lane.upload" and mine[0].t0 == m.t0
        assert mine[-1].stage == "lane.lookup" and mine[-1].t1 == m.t1
        for a, b in zip(mine, mine[1:]):
            assert b.t0 == a.t1
        names = [s.stage for s in mine]
        assert names.count("lane.sort") == n_sorts
        assert names.count("lane.launch") == opts.get("n_engines", 1)
        assert m.meta == {"n": B}


def test_partitioned_match_is_one_launch(system):
    table, queries = system
    tr = Tracer()
    eng = _engine(table, tr, partitioned=True)
    eng.match(eng.encode_queries_host(queries[:64]))
    spans = tr.spans()
    assert [s.stage for s in spans] == ["lane.upload", "lane.launch",
                                        "match"]
    assert spans[0].t0 == spans[2].t0 and spans[1].t1 == spans[2].t1


def test_tracing_off_reads_no_cpu_clock_and_answers_the_same(system,
                                                             monkeypatch):
    table, queries = system
    traced = _run_wrapper(table, queries, 2, Tracer())
    eng_tr = _engine(table, Tracer())
    enc = eng_tr.encode_queries_host(queries[:SORT_MAX + 1])
    want = [x.numpy() for x in eng_tr.match(enc)]

    def refuse(*a, **k):
        raise AssertionError("read with tracing off")
    monkeypatch.setattr(time, "thread_time", refuse)
    monkeypatch.setattr(trace_mod.Span, "__init__", refuse)
    plain = _run_wrapper(table, queries, 2, None)
    for a, b in zip(traced, plain):
        assert a.uid == b.uid
        for x, y in ((a.decisions, b.decisions), (a.weights, b.weights),
                     (a.rule_ids, b.rule_ids)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    got = [x.numpy() for x in _engine(table).match(enc)]
    for x, y in zip(got, want):
        assert x.tobytes() == y.tobytes()


def test_laps_tile_per_thread():
    tr = Tracer()
    errors = []
    interval = sys.getswitchinterval()

    def work(k):
        try:
            t = tr.lap_start()
            for i in range(200):
                t1 = tr.lap("lane.launch", thread=k, i=i)
                assert t1 >= t
                t = t1
        except AssertionError as e:     # pragma: no cover
            errors.append(e)
    threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    for k in range(16):
        mine = [s for s in tr.spans() if s.meta["thread"] == k]
        assert [s.meta["i"] for s in mine] == list(range(200))
        for a, b in zip(mine, mine[1:]):
            assert b.t0 == a.t1


def test_report_and_chrome_take_the_mct_stages(system):
    table, queries = system
    tr = Tracer()
    _run_wrapper(table, queries, 2, tr)
    spans = tr.spans()
    stages = {s.stage for s in spans}
    assert set(WRAPPER_STAGES) | {"handoff", "match", "lane.upload",
                                  "lane.launch", "lane.lookup"} <= stages
    assert stages <= set(LIFECYCLE_STAGES)
    rep = TraceReport.from_spans(spans, n_dropped=tr.n_dropped)
    for stage in stages:
        assert rep.counts[stage] == sum(1 for s in spans if s.stage == stage)
    assert rep.counts["encode"] == rep.counts["handoff"] == 4
    evs = chrome_events(spans)
    lanes = {e["tid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    workers = {s.meta["worker"] for s in spans if s.stage == "encode"}
    assert {lanes[100 + w] for w in workers} == \
        {f"wrapper-worker-{w}" for w in workers}
    assert "engine-match" in lanes.values()
    for name in ("queue_wait", "handoff"):
        b = [e for e in evs if e["ph"] == "b" and e["name"] == name]
        e_ = [e for e in evs if e["ph"] == "e" and e["name"] == name]
        assert len(b) == len(e_) == 4
        assert sorted(x["id"] for x in b) == [0, 1, 2, 3]
    on_worker = [e for e in evs if e["ph"] == "X" and e["name"] in
                 ("encode", "dispatch", "device_execute", "collect")]
    assert len(on_worker) == 16 and all(e["tid"] >= 100 for e in on_worker)


def test_thread_time_counts_cpu_not_sleep():
    """The clock behind cpu_us: a sleeping thread's CPU time hardly moves,
    a busy one's does."""
    c0, t0 = time.thread_time(), time.perf_counter()
    time.sleep(0.05)
    assert (time.thread_time() - c0) < 0.5 * (time.perf_counter() - t0)
    c1, deadline = time.thread_time(), time.perf_counter() + 10.0
    while time.thread_time() - c1 < 0.005 and time.perf_counter() < deadline:
        np.sum(np.arange(1000))
    assert time.thread_time() - c1 >= 0.005


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1024, SORT_MAX + 1, 4096])
def test_lane_spans_on_card(system, B):
    """On the card the launch sorts up to SORT_MAX queries itself and
    argsorts above: lane.sort appears above it only, the lanes tile match,
    and the traced answers are the untraced ones."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel's launch is the card's")
    table, queries = system
    tr = Tracer()
    traced = ErbiumEngine(table, device="cuda", tile_r=128, tracer=tr)
    plain = ErbiumEngine(table, device="cuda", tile_r=128)
    enc = traced.encode_queries_host(queries[:B])
    got = [x.cpu().numpy() for x in traced.match(enc)]
    want = [x.cpu().numpy() for x in plain.match(enc)]
    for x, y in zip(got, want):
        assert x.tobytes() == y.tobytes()
    spans = tr.spans()
    assert [s.stage for s in spans] == (
        ["lane.upload"] + ["lane.sort"] * (B > SORT_MAX)
        + ["lane.launch", "lane.lookup", "match"])
    for a, b in zip(spans[:-2], spans[1:-1]):
        assert b.t0 == a.t1
    assert spans[0].t0 == spans[-1].t0 and spans[-2].t1 == spans[-1].t1
