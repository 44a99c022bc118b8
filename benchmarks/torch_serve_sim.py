#!/usr/bin/env python3
"""The sim-clock serving sections of BENCH_endtoend.json, from the PyTorch
port: fig 13's replica, cache and routing sweeps and fig 14's capacity
sweep, run with ``repro_torch.serve``'s ``SimServer``, ``EngineGroup`` and
``CapacityController``, then gated against the committed
``BENCH_endtoend.json`` by ``benchmarks/check_regression.py``'s
``compare`` at its 15% tolerance.

The sweeps' parameters are those of ``benchmarks/fig13_endtoend.py`` and
``benchmarks/fig14_capacity.py``, written out here (those harnesses import
the JAX package). The capacity sweep runs at fig 14's ``--smoke`` size, the
size of the committed baseline's capacity section; the cache sweep runs
the one Zipf skew the baseline holds (1.1).

    PYTHONPATH=src python3 benchmarks/torch_serve_sim.py [--out PATH]

Writes the fresh sections in BENCH_endtoend.json's schema to
``build/torch_serve_sim.json`` (or ``--out``), prints each gated number
beside its baseline, and exits 1 when one falls below its floor. The
numbers are wall-clock throughput of simulated engines: they measure the
host that runs the script, not an accelerator.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

import numpy as np  # noqa: E402

from check_regression import collect_metrics, compare  # noqa: E402

# fig13_endtoend.py: replica and cache sweeps
TARGET_BATCH = 8
REPLICA_COUNTS = (1, 2, 4)
SIM_HOST_MS = 3.0
SIM_DEVICE_MS = 8.0
SIM_N_BATCHES = 48
CACHE_ALPHAS = (1.1,)
CACHE_REPLICAS = 4
# fig13_endtoend.py: routing sweep
ROUTING_POLICIES = ("least_loaded", "sticky", "hit_aware")
ROUTING_ALPHA = 1.1
ROUTING_REPLICAS = 4
ROUTING_WAVES = 3
ROUTING_N = 256
ROUTING_UNIQUE = 96
ROUTING_TTL = 5.0
ROUTING_STRAGGLER_S = 0.05
ROUTING_WARM_FACTOR = 0.25
# fig14_capacity.py at --smoke: phases a quarter as long, two batch targets
CAPACITY_BATCH_GRID = (4, 32)
CAPACITY_REPLICAS = 4
CAPACITY_MAX_QUEUE = 64
CAPACITY_SCALE = 0.25
CAPACITY_PHASES = {
    "weak_host": [(0.6, 800.0), (1.2, 2400.0), (0.6, 1600.0)],
    "balanced": [(0.6, 1000.0), (1.2, 3000.0), (0.6, 2000.0)],
}
TOLERANCE = 0.15                  # check_regression.py's default

RESULTS: list = []


def emit(name: str, us_per_call: float, derived: str, **extra) -> None:
    print(f"{name},{us_per_call:.1f},{derived}")
    RESULTS.append({"name": name, "us_per_call": float(us_per_call),
                    "derived": derived, **extra})


def replica_sweep() -> None:
    """Aggregate throughput against replica count behind one dispatcher."""
    from repro_torch.serve import ServeConfig, SimServer, build, sim_requests
    base_qps = None
    host_cap_qps = 1e3 / SIM_HOST_MS * TARGET_BATCH
    for r in REPLICA_COUNTS:
        srv = build(ServeConfig(
            replicas=r, routing="least_loaded", target_batch=TARGET_BATCH,
            deadline=1.0, server_factory=lambda i: SimServer(
                host_ms_per_batch=SIM_HOST_MS,
                device_ms_per_batch=SIM_DEVICE_MS)))
        reqs = sim_requests(SIM_N_BATCHES * TARGET_BATCH, max_new_tokens=4)
        t0 = time.perf_counter()
        outs = srv.serve(reqs, mode="pipelined")
        dt = time.perf_counter() - t0
        qps = len(outs) / dt
        base_qps = base_qps or qps
        rep = srv.report()
        emit(f"fig13_replicas_{r}", dt / len(outs) * 1e6,
             f"replicas={r} achieved={qps:.0f}qps scale={qps / base_qps:.2f}x"
             f" host_cap={host_cap_qps:.0f}qps "
             f"idle={rep.device_idle_fraction:.2f}",
             replicas=r, achieved_qps=qps, scale=qps / base_qps,
             host_cap_qps=host_cap_qps)


def cache_sweep() -> list:
    """Two waves of one Zipf key population, cache off and on."""
    from repro_torch.serve import (CacheConfig, ServeConfig, SimServer,
                                   build, sim_requests)
    n = SIM_N_BATCHES * TARGET_BATCH
    host_cap_qps = 1e3 / SIM_HOST_MS * TARGET_BATCH
    points = []
    for alpha in CACHE_ALPHAS:
        for cached in (False, True):
            srv = build(ServeConfig(
                replicas=CACHE_REPLICAS, routing="least_loaded",
                target_batch=TARGET_BATCH, deadline=1.0,
                cache=CacheConfig() if cached else None,
                server_factory=lambda i: SimServer(
                    host_ms_per_batch=SIM_HOST_MS,
                    device_ms_per_batch=SIM_DEVICE_MS)))
            waves = [sim_requests(n, max_new_tokens=4, rid_base=w * n,
                                  unique_keys=max(1, n // 4),
                                  repeat_alpha=alpha, content_seed=101)
                     for w in range(2)]
            t0 = time.perf_counter()
            outs = [c for wave in waves
                    for c in srv.serve(wave, mode="pipelined")]
            dt = time.perf_counter() - t0
            rep = srv.report()
            hit_rate = rep.cache.get("hit_rate", 0.0) if rep.cache else 0.0
            point = dict(repeat_alpha=alpha, cached=cached,
                         n_requests=len(outs), effective_qps=len(outs) / dt,
                         host_cap_qps=host_cap_qps, hit_rate=hit_rate,
                         device_idle_fraction=rep.device_idle_fraction,
                         n_batches_executed=len(rep.batch_sizes),
                         cache=dict(rep.cache))
            points.append(point)
            emit(f"fig13_cache_a{alpha:g}_{'on' if cached else 'off'}",
                 dt / len(outs) * 1e6,
                 f"alpha={alpha:g} qps={point['effective_qps']:.0f} "
                 f"hit={hit_rate:.2f}", **point)
    return points


def routing_sweep() -> list:
    """Repeat-heavy recompute traffic under each routing policy, healthy
    and with replica 0 straggling."""
    from repro_torch.ft.failures import DelayInjector
    from repro_torch.serve import (CacheConfig, ServeConfig, SimServer,
                                   build, sim_requests)
    points = []
    for scenario, delay in (("repeat", None), ("straggler", DelayInjector(
            {0: ROUTING_STRAGGLER_S}))):
        for policy in ROUTING_POLICIES:
            srv = build(ServeConfig(
                replicas=ROUTING_REPLICAS, routing=policy,
                target_batch=TARGET_BATCH, deadline=1.0,
                cache=CacheConfig(ttl=ROUTING_TTL), spill_threshold=128,
                delay=delay, server_factory=lambda i: SimServer(
                    host_ms_per_batch=1.0, device_ms_per_batch=0.5,
                    device_ms_per_token=1.0,
                    warm_factor=ROUTING_WARM_FACTOR)))
            t0 = time.perf_counter()
            outs = []
            for w in range(ROUTING_WAVES):
                base = w * 20.0
                fill = sim_requests(
                    w * TARGET_BATCH, max_new_tokens=4,
                    rid_base=(10 + w) * 100_000, content_seed=5000 + 17 * w,
                    arrivals=base + np.arange(w * TARGET_BATCH) * 1e-3)
                wave = sim_requests(
                    ROUTING_N, max_new_tokens=4,
                    rid_base=w * ROUTING_N + w + 1,
                    unique_keys=ROUTING_UNIQUE, repeat_alpha=ROUTING_ALPHA,
                    content_seed=211,
                    arrivals=base + (w * TARGET_BATCH
                                     + np.arange(ROUTING_N)) * 1e-3)
                outs.extend(srv.serve(fill + wave, mode="pipelined"))
            dt = time.perf_counter() - t0
            rep = srv.report()
            point = dict(scenario=scenario, policy=policy,
                         repeat_alpha=ROUTING_ALPHA, n_requests=len(outs),
                         effective_qps=len(outs) / dt,
                         affinity_hits=rep.affinity_hits,
                         affinity_spills=rep.affinity_spills,
                         n_batches_executed=len(rep.batch_sizes))
            points.append(point)
            emit(f"fig13_routing_{scenario}_{policy}", dt / len(outs) * 1e6,
                 f"qps={point['effective_qps']:.0f} affinity="
                 f"{rep.affinity_hits}hit/{rep.affinity_spills}spill",
                 **point)
    return points


def capacity_sweep() -> list:
    """Static batch targets against the controller under phased load."""
    from repro_torch.capacity import CapacityConfig, CostReport
    from repro_torch.serve import (PhasedOpenLoopGen, ServeConfig, SimServer,
                                   SyntheticWorkload, build)

    def drive(profile, target_batch, capacity=None):
        sched = build(ServeConfig(
            replicas=CAPACITY_REPLICAS, routing="least_loaded",
            target_batch=target_batch, deadline=0.01,
            max_queue=CAPACITY_MAX_QUEUE, policy="shed_oldest",
            capacity=capacity,
            server_factory=lambda i: SimServer.from_profile(profile)
        )).session()
        gen = PhasedOpenLoopGen(workload, phases, seed=14)
        t0 = time.perf_counter()
        gen.drive(sched)
        outs = sched.result()
        dt = time.perf_counter() - t0
        return len(outs) / dt, sched.report(offered_qps=gen.mean_qps)

    report, points = CostReport(), []
    grid = CAPACITY_BATCH_GRID
    for profile in ("weak_host", "balanced"):
        phases = [(d * CAPACITY_SCALE, q) for d, q in CAPACITY_PHASES[profile]]
        workload = SyntheticWorkload(prompt_len=8, max_new_tokens=4, seed=3)
        static = {tb: drive(profile, tb)[0] for tb in grid}
        best_tb = max(static, key=static.get)
        cap = CapacityConfig(window_s=0.05, confirm=2, min_batch=grid[0],
                             max_batch=grid[-1], min_queue=16, max_queue=256)
        ctl_qps, rep = drive(profile, grid[0], cap)
        mean_active = float(rep.capacity.get("mean_active_replicas",
                                             CAPACITY_REPLICAS))
        srow = report.add(f"{profile}/static_tb{best_tb}", host=profile,
                          replicas=CAPACITY_REPLICAS,
                          achieved_qps=static[best_tb])
        crow = report.add(f"{profile}/controlled", host=profile,
                          replicas=mean_active, achieved_qps=ctl_qps)
        point = dict(profile=profile, phases=phases,
                     static_qps_by_batch={str(k): v
                                          for k, v in static.items()},
                     best_static_batch=best_tb,
                     best_static_qps=static[best_tb], controlled_qps=ctl_qps,
                     recovered_fraction=ctl_qps / static[best_tb],
                     diagnosis=rep.capacity.get("diagnosis"),
                     diagnosis_history=rep.capacity.get("history", []),
                     mean_active_replicas=mean_active,
                     static_usd_per_1k=srow.usd_per_1k,
                     controlled_usd_per_1k=crow.usd_per_1k)
        points.append(point)
        emit(f"fig14_{profile}_controlled", 1e6 / max(ctl_qps, 1e-9),
             f"qps={ctl_qps:.0f} best_static={static[best_tb]:.0f} "
             f"recovered={point['recovered_fraction']:.2f} "
             f"diag={point['diagnosis']}", **point)
    points.append({"cost_report": report.as_dict()})
    return points


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "torch_serve_sim.json"))
    ap.add_argument("--baseline", default=str(ROOT / "BENCH_endtoend.json"))
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    t0 = time.perf_counter()
    replica_sweep()
    payload = {"suites": ["fig13", "fig14"], "failed": [],
               "results": RESULTS, "cache": cache_sweep(),
               "routing": routing_sweep(), "capacity": capacity_sweep()}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=2))
    baseline = json.loads(Path(args.baseline).read_text())
    base_m, fresh_m = collect_metrics(baseline), collect_metrics(payload)
    for key in sorted(base_m):
        got = fresh_m.get(key)
        print(f"gated {key}: port {got!r} baseline {base_m[key]!r} ratio "
              + (f"{got / base_m[key]!r}" if got is not None else "missing"))
    failures = compare(baseline, payload, TOLERANCE)
    print(f"{len(base_m)} gated metrics, {len(failures)} below the floor "
          f"at {TOLERANCE:.0%}; wrote {out} in "
          f"{time.perf_counter() - t0:.1f} s")
    for msg in failures:
        print(f"  {msg}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
