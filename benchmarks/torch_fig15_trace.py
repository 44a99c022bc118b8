"""Where requests spend their time, from the port: per-stage trace
attribution across the paper's box shapes, and the tracing overhead
budget; the counterpart of ``benchmarks/fig15_trace.py``, on
``repro_torch.serve`` and ``repro_torch.trace``.

- **weak_host, overdriven**: offered load ~2x the serial-host capacity of
  the f1.2xlarge-style box; the trace's dominant stage must be
  ``queue_wait``.
- **balanced, comfortable**: the c5.12xlarge-style box under moderate
  load; ``device_execute`` dominates.

Each point cross-checks the TraceReport against the RunReport of the same
run. The overhead measurement replays one stream with ``trace=None`` in two
interleaved arms and with tracing on: the disabled arms must agree within
1% and the traced outputs must equal the untraced ones bit for bit. A
4-replica run with the capacity controller exports a Chrome
``trace_event`` file (default ``build/torch_fig15_chrome_trace.json``).
The engines are simulated on the host's clock: this measures the host.

    PYTHONPATH=src python3 benchmarks/torch_fig15_trace.py [--smoke]
"""
from __future__ import annotations

import json
import os
import statistics
import time

import numpy as np

from repro_torch.serve import (OpenLoopGen, PhasedOpenLoopGen, ServeConfig,
                               SimServer, SyntheticWorkload, build,
                               sim_requests)
from torch_common import BUILD, Bench, cli

# (profile, expected dominant stage, offered qps, serving knobs): the two
# regimes of the paper's diagnosis
SCENARIOS = (
    dict(profile="weak_host", expect="queue_wait", qps=3000.0, n=400,
         replicas=2, target_batch=8, deadline=0.005, max_queue=128),
    dict(profile="balanced", expect="device_execute", qps=400.0, n=160,
         replicas=4, target_batch=8, deadline=0.002, max_queue=64),
)

OVERHEAD_N = 512            # replayed requests per overhead measurement
OVERHEAD_REPEATS = 7
CHROME_EXPORT = BUILD / "torch_fig15_chrome_trace.json"


def _stage_ms(trep, stage):
    st = trep.stages.get(stage)
    return st.mean_ms if st is not None and st.n else 0.0


def dominance_sweep(bench: Bench, points: list, *, smoke=False):
    """Live overdriven/comfortable runs: the trace names the bottleneck."""
    scale = 0.25 if smoke else 1.0
    for sc in SCENARIOS:
        n = max(32, int(sc["n"] * scale))
        workload = SyntheticWorkload(prompt_len=8, max_new_tokens=4, seed=3)
        with build(ServeConfig(
                replicas=sc["replicas"], routing="least_loaded",
                target_batch=sc["target_batch"], deadline=sc["deadline"],
                max_queue=sc["max_queue"], policy="reject", trace=True,
                server_factory=lambda i, p=sc["profile"]:
                    SimServer.from_profile(p))) as srv:
            sched = srv.session()
            OpenLoopGen(workload, qps=sc["qps"], n=n, seed=15).drive(sched)
            sched.result()
            rep = sched.report(offered_qps=sc["qps"])
            trep = sched.trace_report()
        dom = trep.dominant_stage()
        # the reconciliation the trace module promises: same timestamps,
        # same percentiles as the metrics layer
        recon_ok = (
            trep.counts.get("complete", 0) == rep.n_completed
            and trep.stages["queue_wait"].n == rep.breakdown["queue_wait"].n
            and abs(trep.stages["queue_wait"].p50_ms
                    - rep.breakdown["queue_wait"].p50_ms) < 1e-6
            and abs(_stage_ms(trep, "device_execute")
                    - rep.breakdown["device"].mean_ms) < 1e-6)
        point = dict(
            profile=sc["profile"], offered_qps=sc["qps"], n=n,
            expect_dominant=sc["expect"], dominant_stage=dom,
            dominance_ok=dom == sc["expect"],
            reconciles_with_run_report=recon_ok,
            queue_wait_ms=_stage_ms(trep, "queue_wait"),
            encode_ms=_stage_ms(trep, "encode"),
            device_execute_ms=_stage_ms(trep, "device_execute"),
            total_ms=_stage_ms(trep, "total"),
            n_completed=rep.n_completed, n_rejected=rep.n_rejected,
            n_spans=trep.n_spans, n_dropped=trep.n_dropped,
            per_replica={str(k): v.as_dict()
                         for k, v in trep.per_replica.items()},
        )
        points.append(point)
        bench.emit(f"fig15_{sc['profile']}",
                   _stage_ms(trep, "total") * 1e3,
                   f"dominant={dom} (expect {sc['expect']}) "
                   f"queue={point['queue_wait_ms']:.1f}ms "
                   f"encode={point['encode_ms']:.1f}ms "
                   f"device={point['device_execute_ms']:.1f}ms "
                   f"reconciled={recon_ok}", **point)


def overhead_measurement(bench: Bench, points: list, *, smoke=False):
    """The acceptance claim is about the *disabled* path: ``trace=None``
    (the default) must be bit-identical to the pre-trace stack with <1%
    throughput overhead — every emission site is an ``if tracer is not
    None`` guard around otherwise-unchanged code. With no pre-trace
    binary to race, the measurable statement is that two interleaved arms
    of identical ``trace=None`` runs are statistically identical (their
    delta is the noise floor the guards hide under), and that outputs
    with tracing on are bit-identical to off. The tracing-*on* wall-clock
    delta is reported informationally (it is genuinely nonzero: ~350
    span emissions against a sleep-calibrated simulator)."""
    n = 256 if smoke else OVERHEAD_N
    reqs = sim_requests(n, max_new_tokens=4)

    def run_once(trace):
        # big batches -> few long sleeps: the simulator's wall time is
        # sleep-dominated, and OS sleep quantisation is the noise floor
        # this comparison sits on, so fewer sleeps = a quieter floor
        srv = build(ServeConfig(
            replicas=2, routing="sticky", target_batch=16, deadline=0.01,
            trace=trace,
            server_factory=lambda i: SimServer(host_ms_per_batch=2.0,
                                               device_ms_per_batch=4.0)))
        with srv:
            t0 = time.perf_counter()
            outs = srv.serve(reqs, mode="pipelined")
            dt = time.perf_counter() - t0
        if len(outs) != n:
            raise RuntimeError(f"fig15: {len(outs)} of {n} requests served")
        return dt, outs

    arm_a, arm_b, arm_on = [], [], []
    outs_off = outs_on = None
    for _ in range(OVERHEAD_REPEATS):
        dt, outs_off = run_once(None)
        arm_a.append(dt)
        dt, outs_on = run_once(True)
        arm_on.append(dt)
        dt, _ = run_once(None)
        arm_b.append(dt)
    # identical code in both arms: compare noise *floors* (min), which
    # converge much faster than medians under shared-machine jitter
    a = min(arm_a)
    b = min(arm_b)
    on = statistics.median(arm_on)
    off = statistics.median(arm_a + arm_b)
    disabled_overhead = abs(a / b - 1.0)
    traced_delta = on / off - 1.0

    by_rid = {c.rid: c for c in outs_off}
    bit_identical = len(outs_on) == len(outs_off) and all(
        np.array_equal(by_rid[c.rid].tokens, c.tokens) for c in outs_on)

    point = dict(n=n, off_s=off, on_s=on,
                 disabled_overhead_fraction=disabled_overhead,
                 traced_delta_fraction=traced_delta,
                 bit_identical=bit_identical,
                 overhead_ok=disabled_overhead < 0.01 and bit_identical)
    points.append({"overhead": point})
    bench.emit("fig15_trace_overhead", off / n * 1e6,
               f"trace=None arms delta={disabled_overhead * 100:.2f}% "
               f"(budget <1%) bit_identical={bit_identical} "
               f"[tracing on: {on * 1e3:.1f}ms vs {off * 1e3:.1f}ms, "
               f"{traced_delta * 100:+.2f}%]", **point)


def chrome_export(bench: Bench, points: list, path=CHROME_EXPORT, *,
                  smoke=False):
    """4-replica controlled run -> Chrome trace_event artifact."""
    scale = 0.25 if smoke else 1.0
    phases = [(0.6 * scale, 800.0), (1.2 * scale, 2400.0),
              (0.6 * scale, 1600.0)]
    workload = SyntheticWorkload(prompt_len=8, max_new_tokens=4, seed=3)
    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with build(ServeConfig(
            replicas=4, routing="least_loaded", target_batch=4,
            deadline=0.01, max_queue=64, policy="shed_oldest", trace=True,
            capacity={"window_s": 0.05 if smoke else 0.1, "confirm": 2,
                      "min_batch": 4, "max_batch": 32},
            server_factory=lambda i: SimServer.from_profile("weak_host"))
            ) as srv:
        sched = srv.session()
        PhasedOpenLoopGen(workload, phases, seed=14).drive(sched)
        sched.result()
        srv.export_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    stages = {e["name"] for e in events if e.get("ph") in ("X", "i", "b")}
    n_controller = sum(e.get("name") == "controller" for e in events)
    replica_lanes = sorted({e["args"]["name"] for e in events
                            if e.get("ph") == "M"
                            and e.get("name") == "thread_name"
                            and e["args"]["name"].startswith("replica-")})
    point = dict(path=path, n_events=len(events),
                 stages=sorted(stages), n_controller_events=n_controller,
                 replica_lanes=replica_lanes,
                 lifecycle_complete=bool(
                     {"submit", "queue_wait", "encode", "dispatch",
                      "device_execute", "complete"} <= stages))
    points.append({"chrome_export": point})
    bench.emit("fig15_chrome_export", float(len(events)),
               f"{len(events)} events -> {path} "
               f"stages={len(stages)} controller={n_controller} "
               f"replicas={len(replica_lanes)}", **point)


def run(bench: Bench = None, *, smoke: bool = False,
        chrome_path=CHROME_EXPORT):
    """Returns the trace points."""
    bench = bench or Bench.on()
    points = bench.sections.setdefault("trace", [])
    dominance_sweep(bench, points, smoke=smoke)
    overhead_measurement(bench, points, smoke=smoke)
    chrome_export(bench, points, chrome_path, smoke=smoke)
    return points


if __name__ == "__main__":
    bench, args = cli(__doc__, smoke="fewer requests, short phases")
    run(bench, smoke=args.smoke)
