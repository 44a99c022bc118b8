"""Paper Fig. 11 from the port: the latency/throughput Pareto front over
configurations, from the stage times of ``torch_fig7_10_parallel``; the
counterpart of ``benchmarks/fig11_pareto.py``.

    PYTHONPATH=src python3 benchmarks/torch_fig11_pareto.py [--device cpu]
"""
from __future__ import annotations

import torch_fig7_10_parallel as fig7_10
from repro_torch.core.deployment import Config, pareto, sweep
from torch_common import Bench, cli

CONFIGS = [Config(p, w, k, e)
           for p in (1, 2, 4) for w in (1, 2, 4)
           for k in (1, 2, 4) for e in (1, 2, 4)
           if w >= k and p >= w and k * e <= 4]


def run(bench: Bench = None, *, stage_times=None):
    """Returns the front (a list of ``Perf``)."""
    bench = bench or Bench.on()
    st = fig7_10.measure(bench) if stage_times is None else stage_times
    perfs = sweep(CONFIGS, st, [fig7_10.BATCH])
    front = pareto(perfs)
    for p in front:
        bench.emit(f"fig11/front_{p.config.label().replace(' ', '')}",
                   p.latency_us, f"qps={p.throughput_qps:.3e}",
                   qps=p.throughput_qps)
    # the paper's selection: the lowest latency at >= half the top throughput
    top = max(q.throughput_qps for q in perfs)
    floor = sorted((p for p in perfs if p.throughput_qps >= 0.5 * top),
                   key=lambda p: p.latency_us)[0]
    bench.emit("fig11/best_under_throughput_floor", floor.latency_us,
               f"config={floor.config.label()};"
               f"qps={floor.throughput_qps:.3e}")
    return front


if __name__ == "__main__":
    run(cli(__doc__)[0])
