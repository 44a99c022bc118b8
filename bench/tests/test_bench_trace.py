"""The readers of the program's own spans (``bench/harness/spans.py`` and
``wrapper_offcpu_pct``, ``wrapper_handoff_ms_p95``,
``lane_host_us_per_call``), on hand-made spans with known values and on the
spans of a small CPU run of the MCT path; ``PauseAtSpans``, which holds the
thread that launches the work while the profiler stops; and, on the card,
the clock check of the device trace against the lane's launch spans:

    python -m pytest -m gpu bench/tests/test_bench_trace.py -s
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from bench.harness import core
from bench.harness.profile import DeviceTrace, PauseAtSpans, Recorder
from bench.harness.spans import clock_leads
from repro_torch.kernels.rule_match import SORT_MAX
from repro_torch.serve.trace import Span, Tracer

READERS = ("wrapper_offcpu_pct", "wrapper_handoff_ms_p95",
           "lane_host_us_per_call")


def _span(stage, t0, t1, **meta):
    return Span(stage, t0, t1, meta=meta or None)


def _batch(uid, t, stages_us, handoff_ms):
    """One batch's wrapper spans from ``t``: (wall, cpu) a stage, then the
    hand-off."""
    out = [_span("queue_wait", t - 1e-3, t, uid=uid, n=8, worker=0)]
    for stage, (wall, cpu) in zip(("encode", "dispatch", "device_execute",
                                   "collect"), stages_us):
        out.append(_span(stage, t, t + wall * 1e-6, uid=uid, n=8, worker=0,
                         cpu_us=cpu))
        t += wall * 1e-6
    out.append(_span("handoff", t, t + handoff_ms * 1e-3, uid=uid, n=8))
    return out


def _hand_made():
    spans = (_batch(0, 11.0, [(100, 60), (50, 50), (200, 100), (50, 40)], 1.0)
             + _batch(1, 19.9999, [(100, 0)] * 4, 5.0)      # handed back late
             + _batch(2, 14.0, [(25, 25)] * 4, 3.0)
             + [_span("match", 12.0, 12.0002, n=4096),
                _span("match", 13.0, 13.0004, n=4096),
                _span("match", 19.9999, 20.0001, n=4096)])
    return core.TracedRun(10.0, 20.0, data={"spans": spans,
                                            "spans_dropped": 0})


WANT = {"wrapper_offcpu_pct": 100.0 * (500 - 350) / 500,
        "wrapper_handoff_ms_p95": float(np.percentile([1.0, 3.0], 95)),
        "lane_host_us_per_call": 300.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_known_value(name):
    assert core.load_reader(name).read(_hand_made()) == \
        pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("data", [{}, {"spans": [], "spans_dropped": 0},
                                  "dropped"])
def test_reader_reads_nothing_without_a_whole_record(name, data):
    run = _hand_made()
    if data == "dropped":
        run.data["spans_dropped"] = 1
    else:
        run.data = dict(data)
    assert core.load_reader(name).read(run) is None


def test_readers_on_a_cpu_run_of_the_mct_path():
    from repro_torch.core.aggregator import Batch
    from repro_torch.core.compiler import compile_rules
    from repro_torch.core.engine import ErbiumEngine
    from repro_torch.core.rules import generate_queries, generate_rules
    from repro_torch.core.wrapper import MCTWrapper
    rules = generate_rules(300, version=2, seed=5)
    tr = Tracer()
    eng = ErbiumEngine(compile_rules(rules), device="cpu", tile_r=128,
                       tracer=tr)
    wrap = MCTWrapper([eng], n_workers=2, tracer=tr)
    queries = generate_queries(rules, 600, seed=6)
    t0 = time.perf_counter()
    wrap.start()
    try:
        for uid in range(6):
            wrap.submit(Batch(uid, queries[uid * 100:(uid + 1) * 100],
                              [0] * 100))
        results = wrap.drain(6)
    finally:
        wrap.stop()
    run = core.TracedRun(t0, time.perf_counter() + 1e-3, data={
        "spans": tr.spans(), "spans_dropped": tr.n_dropped})
    got = {n: core.load_reader(n).read(run) for n in READERS}
    spans = run.data["spans"]
    hand = [(s.t1 - s.t0) * 1e3 for s in spans if s.stage == "handoff"]
    match = [(s.t1 - s.t0) * 1e6 for s in spans if s.stage == "match"]
    assert len(hand) == len(match) == 6
    assert got["wrapper_handoff_ms_p95"] == pytest.approx(
        float(np.percentile(hand, 95)))
    assert got["lane_host_us_per_call"] == pytest.approx(np.mean(match))
    wall = sum(r.times.encode_us + r.times.dispatch_us + r.times.kernel_us
               + r.times.collect_us for r in results)
    cpu = sum(s.meta["cpu_us"] for s in spans if s.stage in
              ("encode", "dispatch", "device_execute", "collect"))
    assert got["wrapper_offcpu_pct"] == pytest.approx(
        100.0 * (wall - cpu) / wall, rel=1e-6)
    assert 0.0 <= got["wrapper_offcpu_pct"] <= 100.0


def _device(ops, t0=0.0, t1=1.0):
    return DeviceTrace(t0=t0, t1=t1, ops=ops, aligned=True)


def _calls(shift=0.0, sort=True):
    """Ten calls 1 ms apart: lane.sort at +0.1 ms, lane.launch at +0.2 ms,
    the radix sort on the card at +0.15 ms and the launch's kernels from
    +0.25 ms, the card's trace moved by ``shift`` seconds."""
    spans, ops = [], []
    for k in range(10):
        t = 0.1 + k * 1e-3
        if sort:
            spans.append(_span("lane.sort", t + 1e-4, t + 2e-4))
            ops.append(("void at::native::radixSortKVInPlace<>",
                        t + 1.5e-4 + shift, t + 1.8e-4 + shift))
        spans.append(_span("lane.launch", t + 2e-4, t + 2.2e-4))
        for j, name in enumerate(("rule_match_runs<256>",
                                  "rule_match_reduce<>")):
            s = t + 2.5e-4 + j * 2e-4 + shift
            ops.append((name, s, s + 1.5e-4))
    return spans, _device(ops)


@pytest.mark.parametrize("shift,sign", [(0.0, 1), (-1e-4, -1)])
def test_clock_leads(shift, sign):
    spans, dev = _calls(shift)
    leads = clock_leads(spans, dev)
    assert len(leads["launch"]) == len(leads["sort"]) == 9
    assert leads["launch"] == pytest.approx([5e-5 + shift] * 9)
    assert leads["sort"] == pytest.approx([5e-5 + shift] * 9)
    assert all(np.sign(x) == sign for x in leads["launch"])
    spans, dev = _calls(sort=False)
    assert clock_leads(spans, dev)["sort"] == []


def _emitter(tracer, stage, stop, log):
    def loop():
        while not stop.is_set():
            log.append((stage, time.perf_counter()))
            tracer.span(stage, 0.0, 1.0)
            time.sleep(0.002)
    th = threading.Thread(target=loop, daemon=True)
    th.start()
    return th


def test_pause_holds_the_thread_of_its_stages_only():
    """While the call runs, the thread closing spans of the given stages
    emits nothing, and one closing other stages goes on."""
    tr = Tracer()
    pause = PauseAtSpans(tr, ("lm.decode",))
    stop = threading.Event()
    log = []
    threads = [_emitter(tr, "lm.decode", stop, log),
               _emitter(tr, "queue_wait", stop, log)]
    held = []

    def fn():
        t0 = time.perf_counter()
        time.sleep(0.1)
        held.append((t0, time.perf_counter()))
        return 7
    try:
        for _ in range(3):
            assert pause(fn) == 7
            time.sleep(0.02)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    for t0, t1 in held:
        inside = [st for st, t in log if t0 < t < t1]
        assert "lm.decode" not in inside and "queue_wait" in inside
    assert [st for st, _ in log].count("lm.decode") > 3


def test_pause_runs_at_once_without_spans_and_hands_back_errors():
    tr = Tracer()
    pause = PauseAtSpans(tr, ("lm.decode",), wait_s=0.05)
    assert pause(lambda: 5) == 5

    def bad():
        raise RuntimeError("profiler")
    with pytest.raises(RuntimeError, match="profiler"):
        pause(bad)
    tr.span("lm.decode", 0.0, 1.0)        # nothing left asked: not held


@pytest.mark.gpu
def test_device_trace_follows_the_lane_spans():
    """One caller's calls of ErbiumEngine.match at B = 1,024 and 4,096 (the
    sort in the launch and as an argsort) under the Recorder: every lane
    kernel starts after the host span that issued it opened."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device trace is the card's")
    from repro_torch.core.compiler import compile_rules
    from repro_torch.core.engine import ErbiumEngine
    from repro_torch.core.rules import generate_queries, generate_rules
    rules = generate_rules(20_000, version=2, seed=42)
    tr = Tracer()
    eng = ErbiumEngine(compile_rules(rules), tracer=tr)
    queries = generate_queries(rules, 4096, seed=7)
    encs = [eng.encode_queries_host(queries[:n]) for n in (1024, 4096)]
    for enc in encs:
        [x.cpu() for x in eng.match(enc)]
    stop = threading.Event()

    def caller(enc):
        while not stop.is_set():
            [x.cpu() for x in eng.match(enc)]
    found = []
    for enc in encs:
        th = threading.Thread(target=caller, args=(enc,), daemon=True)
        th.start()
        time.sleep(0.2)
        with Recorder() as rec:
            time.sleep(0.5)
        stop.set()
        th.join(timeout=30)
        assert not th.is_alive()
        stop.clear()
        found.append((len(enc), clock_leads(tr.spans(), rec.trace)))
        tr.clear()
    for B, leads in found:
        for key, xs in leads.items():
            us = np.array(xs) * 1e6
            print(json.dumps({"B": B, "lead": key, "n": len(xs)} | ({
                "median_us": float(np.median(us)),
                "p1_us": float(np.percentile(us, 1)),
                "min_us": float(us.min()), "first_us": float(us[0]),
                "last_us": float(us[-1])} if len(xs) else {})))
    for B, leads in found:
        assert len(leads["launch"]) > 50
        assert bool(leads["sort"]) == (B > SORT_MAX)
        for key, xs in leads.items():
            assert min(xs, default=0.0) >= 0.0, (B, key, min(xs))
