#!/usr/bin/env python3
"""Time the CUDA rule-match kernel of the PyTorch port under other grids.

Run from the root of a checkout, on a machine with one NVIDIA card:
    python3 benchmarks/torch_rule_match_grid.py

The kernel picks its grid itself (``repro_torch.kernels.rule_match.plan``):
blocks of 128 threads, 256 once the batch fills two of their tiles, and runs
of at most 1024 rules a block, so a large batch spreads over several waves.
This script times that choice against the same launch with 128 or 256
threads and runs capped at 256 to 2048 rules, or cut to fill exactly
one wave of resident blocks (the fewest partial results a query), on the
main path's inputs: 160k v2 rules and the encoded queries of 16 user
queries batched by ``paper_policy``, resized to B = 256, 1024 and 4096 as
``chip_smoke.py`` does. Every grid's output must equal the chosen grid's.
CUDA events over 20 calls, two turns of every grid.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCHES = (256, 1024, 4096)
CAPS = (256, 512, 1024, 2048, None)   # rules a run at most; None: one wave
STAGE = 64                       # rules a stage of the kernel
RUN_ALIGN = 4


def cuda_ms(fn, reps=20):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def grid(chosen, B, R, threads, cap):
    """The launch's grid at ``threads`` a block with runs of at most ``cap``
    rules, or one wave when cap is None, by the kernel's own rule. Resident
    threads a SM stay those of the chosen grid (``__launch_bounds__`` keeps
    512 at either size)."""
    per_sm = chosen["blocks_per_sm"] * chosen["threads"] // threads
    n_btiles = -(-B // (threads * chosen["qpt"]))
    n_runs = chosen["sms"] * per_sm // n_btiles
    if cap is not None:
        n_runs = max(n_runs, -(-R // cap))
    n_runs = max(1, min(n_runs, -(-R // STAGE)))
    run = -(-R // n_runs)
    run = -(-run // RUN_ALIGN) * RUN_ALIGN
    return dict(chosen, threads=threads, n_btiles=n_btiles,
                n_runs=-(-R // run), run=run)


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    from repro_torch.core.aggregator import paper_policy
    from repro_torch.core.compiler import compile_rules
    from repro_torch.core.encoder import queries_to_arrays
    from repro_torch.core.engine import ErbiumEngine
    from repro_torch.core.rules import generate_rules
    from repro_torch.core.workload import generate_workload
    from repro_torch.kernels import rule_match as rm

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    ruleset = generate_rules(160_000, version=2, seed=42)
    table = compile_rules(ruleset)
    engine = ErbiumEngine(table, device=dev)
    batches = [b for uq in generate_workload(ruleset, 16, seed=3)
               for b in paper_policy(uq)]
    all_enc = np.concatenate([engine.encode(queries_to_arrays(b.queries))
                              for b in batches])
    dt = engine.dt
    C, R = dt.bounds.shape[:2]
    lead = dt.lead_col
    for B in BATCHES:
        q = torch.as_tensor(np.resize(all_enc, (B, C)), device=dev)
        chosen = rm.plan(dev, C, B, R)
        sort_col = lead if B <= rm.SORT_MAX else None

        def launch(g):
            order = None if sort_col is not None else \
                torch.argsort(q[:, lead])
            return rm._launch(q, dt.bounds, dt.weights_k, dt.crit_order,
                              order, sort_col, g)
        want = launch(chosen)
        grids = {"chosen": chosen}
        for threads in (128, 256):
            for cap in CAPS:
                grids[f"{threads} threads, "
                      + (f"runs <= {cap}" if cap else "one wave")] = \
                    grid(chosen, B, R, threads, cap)
        for name, g in grids.items():
            got = launch(g)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                sys.exit(f"grid {name} at B = {B} changes the result")
            for _ in range(3):
                launch(g)
        torch.cuda.synchronize(dev)
        ms = {name: [] for name in grids}
        for _ in range(2):
            for name, g in grids.items():
                ms[name].append(cuda_ms(lambda: launch(g)))
        print(f"B = {B}, R = {R}, C = {C}: chosen grid {chosen['n_runs']} "
              f"runs of {chosen['run']} rules x {chosen['n_btiles']} batch "
              f"tiles of {chosen['threads']} threads")
        for name, g in grids.items():
            waves = g["n_runs"] * g["n_btiles"] / (
                g["sms"] * g["blocks_per_sm"] * chosen["threads"]
                // g["threads"])
            print(f"  {name:26s} {ms[name][0]:.4f} / {ms[name][1]:.4f} ms; "
                  f"{g['n_runs']} runs of {g['run']} rules (partials a "
                  f"query) x {g['n_btiles']} tiles, {waves:.2f} waves")


if __name__ == "__main__":
    main()
