"""End-to-end saturation and imbalance sweep from the port (the paper's
§5-6 phenomenon as one harness); the counterpart of
``benchmarks/fig13_endtoend.py``.

Protocol: measure the server's full-batch service rate once, then sweep
open-loop offered load at fractions of it through a live session of the
port's ``AsyncScheduler``. At low offered load the deadline flushes small
batches, so a request's device cost is high: the paper's "the host cannot
generate enough load to realise the accelerator's throughput" regime. Each
point records the replica's execute-stage idle share (``execute_idle``,
``RunReport.device_idle_fraction``: the share of the window in which no
batch was executing; on the card a batch's execution includes the host's
launches, so it is not the card's idle share), the batch sizes and the
mean execute time a batch. As offered load rises, batches fill
and achieved throughput climbs toward capacity until queueing dominates
latency and backpressure rejects. The inset serves one stream in sync and
pipelined mode; the tokens must be equal.

The route scorer is ``build(ServeConfig(model="llama3.2-3b", max_seq=48,
...))``: at full width in bf16 on the card (``reduced=False``), reduced on
the CPU, as the reference. The replica and cache sweeps run simulated
engines on the host's clock through ``torch_serve_sim.py``'s sweeps, at the
reference's grids. ``card_sections`` runs the route scorer's parts,
``sim_sections`` the simulated ones.

    PYTHONPATH=src python3 benchmarks/torch_fig13_endtoend.py [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

import torch_serve_sim as serve_sim
from repro_torch.serve import (OpenLoopGen, ServeConfig, SyntheticWorkload,
                               build)
from torch_common import Bench, cli

ARCH = "llama3.2-3b"
MAX_SEQ = 48
# offered load as a multiple of the measured capacity
LOAD_FRACTIONS = (0.25, 0.5, 1.0, 2.0, 4.0)
TARGET_BATCH = 8
MAX_QUEUE = 16
DEADLINE_S = 0.01
# must exceed the queue depth plus the pipeline's batches in flight, or the
# overload points can never fill the admission queue and reject
N_PER_POINT = 64
INSET_N = 24
CACHE_ALPHAS = (0.0, 0.6, 1.1)


def server(bench: Bench):
    """The route scorer behind a scheduler: full width on the card,
    reduced on the CPU."""
    return build(ServeConfig(model=ARCH, max_seq=MAX_SEQ,
                             reduced=bench.device.type == "cpu",
                             device=bench.device, target_batch=TARGET_BATCH,
                             deadline=DEADLINE_S, max_queue=MAX_QUEUE,
                             policy="reject"))


def workload(srv) -> SyntheticWorkload:
    return SyntheticWorkload(vocab=srv.engine.cfg.vocab, prompt_len=6,
                             max_new_tokens=3, seed=1)


def capacity_qps(srv, wl) -> float:
    """Service rate with full target-sized batches (requests/s)."""
    srv.warmup((1, 2, 4, TARGET_BATCH))
    reqs = wl.build(TARGET_BATCH, rid_base=10_000)
    t0 = time.perf_counter()
    srv.engine.generate_batch(reqs)
    return TARGET_BATCH / (time.perf_counter() - t0)


def load_sweep(bench: Bench, srv, wl, cap: float, *,
               fractions=LOAD_FRACTIONS, n: int = N_PER_POINT) -> list:
    """One live session a load fraction, ``n`` requests each; returns each
    point's offered and achieved load, execute-stage idle share, batch
    sizes, mean execute time a batch, rejects and latency percentiles."""
    points = []
    for frac in fractions:
        qps = cap * frac
        sched = srv.session()
        OpenLoopGen(wl, qps=qps, n=n, seed=int(frac * 100)).drive(sched)
        sched.result()
        rep = sched.report(offered_qps=qps)
        t = rep.breakdown["total"]
        sizes = rep.batch_sizes
        point = dict(fraction=frac, n_offered=n, offered_qps=qps,
                     achieved_qps=rep.achieved_qps, span_s=rep.span_s,
                     execute_idle=rep.device_idle_fraction,
                     n_batches=len(sizes),
                     mean_batch=float(np.mean(sizes)) if sizes else 0.0,
                     batch_hist={str(b): sizes.count(b)
                                 for b in sorted(set(sizes))},
                     batch_ms=rep.device_busy_s / max(len(sizes), 1) * 1e3,
                     n_completed=rep.n_completed, n_rejected=rep.n_rejected,
                     p50_ms=t.p50_ms, p99_ms=t.p99_ms)
        points.append(point)
        name = f"fig13_load_{frac:g}x" + ("" if n == N_PER_POINT
                                          else f"_n{n}")
        bench.emit(name, t.p50_ms * 1e3,
                   f"offered={qps:.0f}qps achieved={rep.achieved_qps:.0f}qps "
                   f"execute_idle={rep.device_idle_fraction:.2f} "
                   f"mean_batch={point['mean_batch']:.2f} "
                   f"rej={rep.n_rejected} p99={t.p99_ms:.0f}ms",
                   report=rep.as_dict(), **point)
    return points


def pipeline_inset(bench: Bench, srv, wl, qps: float) -> dict:
    """The same stream served sync, then pipelined; returns the times,
    both completions and whether their tokens are equal."""
    reqs = OpenLoopGen(wl, qps=qps, n=INSET_N, seed=5).requests()
    t0 = time.perf_counter()
    sync = srv.serve(reqs, mode="sync")
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = srv.serve(reqs, mode="pipelined")
    pipe_s = time.perf_counter() - t0
    by_rid = {c.rid: c for c in sync}
    equal = len(sync) == len(pipe) and all(
        c.rid in by_rid and np.array_equal(by_rid[c.rid].tokens, c.tokens)
        for c in pipe)
    bench.emit("fig13_pipeline_overlap", pipe_s * 1e6,
               f"sync={sync_s * 1e3:.0f}ms pipelined={pipe_s * 1e3:.0f}ms "
               f"speedup={sync_s / pipe_s:.2f}x tokens_equal={equal}",
               sync_s=sync_s, pipelined_s=pipe_s, tokens_equal=equal)
    return dict(sync_s=sync_s, pipelined_s=pipe_s, tokens_equal=equal,
                sync=sync, pipelined=pipe)


def card_sections(bench: Bench, *, long_n: int = 0) -> dict:
    """The route scorer's sections: capacity, the load sweep and the
    inset; raises if the inset's tokens differ. With ``long_n``, one more
    point at the top load fraction with ``long_n`` requests, a window in
    which the first and last batches weigh little. Returns the capacity,
    the load points, the inset and the scorer's parameter dtype."""
    with server(bench) as srv:
        wl = workload(srv)
        cap = capacity_qps(srv, wl)
        load = load_sweep(bench, srv, wl, cap)
        if long_n:
            load += load_sweep(bench, srv, wl, cap,
                               fractions=LOAD_FRACTIONS[-1:], n=long_n)
        inset = pipeline_inset(bench, srv, wl, cap)
        dtype = str(srv.engine.cfg.param_dtype)
    if not inset["tokens_equal"]:
        raise RuntimeError("fig13 inset: pipelined tokens differ from sync")
    return dict(capacity_qps=cap, load=load, inset=inset, dtype=dtype)


def sim_sections(bench: Bench) -> None:
    """The replica and cache sweeps on simulated engines."""
    serve_sim.replica_sweep(serve_sim.PORT, bench.results)
    bench.sections["cache"] = serve_sim.cache_sweep(
        serve_sim.PORT, bench.results, alphas=CACHE_ALPHAS)


def run(bench: Bench = None):
    bench = bench or Bench.on()
    card_sections(bench)
    sim_sections(bench)


if __name__ == "__main__":
    run(cli(__doc__)[0])
