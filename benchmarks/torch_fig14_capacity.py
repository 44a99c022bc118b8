"""Capacity sweep from the port: static batch targets against the adaptive
controller under phase-shifting load, priced through the paper's
deployment costs; the counterpart of ``benchmarks/fig14_capacity.py``.

For each simulated box shape (``weak_host``, ``balanced``) the same phased
open-loop load runs through a static grid of batch targets at the full
replica count (the hand-tuned optimum is the best of them) and through one
run that starts from the worst target with the ``CapacityController``
attached. The sweep is ``torch_serve_sim.py``'s, at the reference's full
size (``--smoke``: a quarter of the load and two batch targets). The
engines are simulated on the host's clock: this measures the host, not the
card.

    PYTHONPATH=src python3 benchmarks/torch_fig14_capacity.py [--smoke]
"""
from __future__ import annotations

import torch_serve_sim as serve_sim
from torch_common import Bench, cli

BATCH_GRID = (4, 8, 16, 32)


def run(bench: Bench = None, *, smoke: bool = False):
    """Returns the capacity points (the last one the cost report)."""
    bench = bench or Bench.on()
    grid = (BATCH_GRID[0], BATCH_GRID[-1]) if smoke else BATCH_GRID
    points = serve_sim.capacity_sweep(
        serve_sim.PORT, bench.results, grid=grid,
        scale=0.25 if smoke else 1.0, window_s=0.05 if smoke else 0.1)
    for p in points:
        if "profile" not in p:
            continue
        best = p["best_static_qps"]
        bench.emit(f"fig14_{p['profile']}_static", 1e6 / max(best, 1e-9),
                   f"best_tb={p['best_static_batch']} qps={best:.0f} "
                   f"${p['static_usd_per_1k']:.5f}/1k",
                   **{k: p[k] for k in ("profile", "best_static_batch",
                                        "best_static_qps",
                                        "static_qps_by_batch",
                                        "static_usd_per_1k")})
    bench.sections["capacity"] = points
    return points


if __name__ == "__main__":
    bench, args = cli(__doc__, smoke="shorter phases, 2-point grid")
    run(bench, smoke=args.smoke)
