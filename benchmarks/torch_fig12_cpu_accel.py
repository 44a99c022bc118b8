"""Paper Fig. 12 from the port: the time a user query takes on the
optimised CPU baseline against the device's engine, as a function of the MCT
queries it checks, and the engine calls ``paper_policy`` makes for it; the
counterpart of ``benchmarks/fig12_cpu_accel.py``.

Two device paths are timed against ``cpu_match_numpy`` on the same batches:
``ErbiumEngine(partitioned=True)`` (the reference's "accelerated path", the
NFA-fanout pruning as a chunked PyTorch op) and the dense engine on the
CUDA rule-match kernel. Host encoding stays outside the timed regions; each
engine call ends in the card's synchronisation. The paper puts the
crossover, above which the accelerator wins, near 400 queries. The three
paths must agree on every user query, and the kernel path must launch once
a ``paper_policy`` batch.

    PYTHONPATH=src python3 benchmarks/torch_fig12_cpu_accel.py [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.aggregator import paper_policy
from repro_torch.core.encoder import encode_queries
from repro_torch.core.engine import ErbiumEngine, cpu_match_numpy
from repro_torch.core.workload import generate_workload
from repro_torch.device import synchronize
from repro_torch.kernels.rule_match import rule_match
from torch_common import Bench, cli

N_USERS = 10
PATHS = ("partitioned", "kernel")
# the CPU baseline's boolean temporaries stay under this many bytes a block
# (its default block of 4,096 queries at 160k rules would take 20 GB each)
CPU_BLOCK_BYTES = 1 << 30


def cpu_block(table) -> int:
    return int(max(1, min(4096, CPU_BLOCK_BYTES
                          // (table.n_rules * table.n_cols))))


def _timed_calls(fn, encs, device):
    """Per-call synchronised calls; returns (µs in all, numpy results)."""
    outs = []
    t0 = time.perf_counter()
    for e in encs:
        outs.append(fn(e))
        synchronize(device)
    us = (time.perf_counter() - t0) * 1e6
    return us, [tuple(np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                 else x) for x in o) for o in outs]


def crossover(rows, path: str):
    """The smallest MCT-query count from which ``path`` beats the CPU on
    every larger user query; None when it loses on the largest."""
    best = None
    for r in sorted(rows, key=lambda r: -r["n_mct"]):
        if r[f"{path}_us"] >= r["cpu_us"]:
            break
        best = r["n_mct"]
    return best


def run(bench: Bench = None, *, n_users: int = N_USERS):
    """Returns ``dict(rows, crossover)``; one row per user query."""
    bench = bench or Bench.on()
    rs, table, _, _ = bench.system(2)
    dev = bench.device
    engines = {"partitioned": ErbiumEngine(table, device=dev,
                                           partitioned=True),
               "kernel": bench.engine(2)}
    block = cpu_block(table)
    wl = generate_workload(rs, n_users, seed=7, mean_ts=400.0)
    rows = []
    for uq in sorted(wl, key=lambda u: u.n_mct):
        batches = paper_policy(uq)
        if not batches:
            continue
        encs = [encode_queries(table, b.queries) for b in batches]
        for eng in engines.values():        # first launch, allocator
            for e in encs:
                eng.match(e)
        synchronize(dev)
        cpu_us, want = _timed_calls(
            lambda e: cpu_match_numpy(table, e, block=block), encs, dev)
        row = dict(n_mct=uq.n_mct, calls=len(batches), cpu_us=cpu_us)
        for path, eng in engines.items():
            before = rule_match.launches
            row[f"{path}_us"], got = _timed_calls(eng.match, encs, dev)
            row[f"{path}_launches"] = rule_match.launches - before
            for g, w in zip(got, want):
                if not all(np.array_equal(x, y) for x, y in zip(g, w)):
                    raise RuntimeError(
                        f"fig12: the {path} path disagrees with "
                        f"cpu_match_numpy on the user query of {uq.n_mct} "
                        "MCT queries")
        if dev.type == "cuda" and row["kernel_launches"] != len(batches):
            raise RuntimeError(
                f"fig12: {row['kernel_launches']} kernel launches for "
                f"{len(batches)} paper_policy batches")
        rows.append(row)
        bench.emit(f"fig12/uq_mct{uq.n_mct}", row["partitioned_us"],
                   f"cpu_us={cpu_us:.0f};accel_calls={len(batches)};"
                   f"speedup={cpu_us / max(row['partitioned_us'], 1):.2f};"
                   f"kernel_us={row['kernel_us']:.0f};kernel_speedup="
                   f"{cpu_us / max(row['kernel_us'], 1):.2f}", **row)
    cross = {p: crossover(rows, p) for p in PATHS}
    big = [r for r in rows if r["n_mct"] >= 400]
    if big:
        sp = {p: float(np.mean([r["cpu_us"] / r[f"{p}_us"] for r in big]))
              for p in PATHS}
        bench.emit("fig12/speedup_above_400q", 0.0,
                   f"mean={sp['partitioned']:.2f};kernel_mean="
                   f"{sp['kernel']:.2f};crossover={cross['partitioned']};"
                   f"kernel_crossover={cross['kernel']} (paper: accel wins "
                   "above ~400 queries)", mean_speedup=sp, crossover=cross)
    return dict(rows=rows, crossover=cross)


if __name__ == "__main__":
    run(cli(__doc__)[0])
