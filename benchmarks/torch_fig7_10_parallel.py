"""Paper Figs. 7-10 from the port: the four parallel-configuration series
over (p processes, w workers, k kernels, e engines a kernel), from measured
stage times and the calibrated deployment model; the counterpart of
``benchmarks/fig7_10_parallel.py``.

Fig 7: engines a kernel (latency down, sub-linear throughput)
Fig 8: uniform scaling (throughput up, latency a request up)
Fig 9: many workers a kernel (the XRT scheduler serialises)
Fig 10: many processes a worker (the worker saturates at ~16 a worker)

The stage times are ``MCTWrapper``'s on the CUDA rule-match kernel (its
plain version on the CPU).

    PYTHONPATH=src python3 benchmarks/torch_fig7_10_parallel.py [--device cpu]
"""
from __future__ import annotations

from repro_torch.core.deployment import Config, evaluate
from repro_torch.core.wrapper import measure_stage_times
from torch_common import Bench, batch_maker, cli

BATCH = 4_096
STAGE_BATCHES = (256, 1024, 4096)
SERIES = {
    "fig7_engines": [Config(1, 1, 1, e) for e in (1, 2, 4)],
    "fig8_uniform": [Config(c, c, c, 1) for c in (1, 2, 4)],
    "fig9_workers_per_kernel": [Config(w, w, 1, 4) for w in (1, 2, 4, 8)],
    "fig10_procs_per_worker": [Config(p, 1, 1, 4) for p in (1, 2, 8, 16, 32)],
}


def measure(bench: Bench, *, repeats: int = 2):
    """Stage times of the v2 engine at ``STAGE_BATCHES`` (median of
    ``repeats``)."""
    return measure_stage_times(bench.engine(2),
                               batch_maker(bench.system(2).queries),
                               STAGE_BATCHES, repeats=repeats)


def run(bench: Bench = None, *, stage_times=None):
    """Returns ``{(series, Config): Perf}``."""
    bench = bench or Bench.on()
    st = measure(bench) if stage_times is None else stage_times
    out = {}
    for name, cfgs in SERIES.items():
        for c in cfgs:
            perf = evaluate(c, st, BATCH)
            bench.emit(f"{name}/{c.label().replace(' ', '')}",
                       perf.latency_us, f"qps={perf.throughput_qps:.3e}",
                       qps=perf.throughput_qps)
            out[(name, c)] = perf
    e1 = out[("fig7_engines", Config(1, 1, 1, 1))]
    e4 = out[("fig7_engines", Config(1, 1, 1, 4))]
    bench.emit("fig7/4engines_speedup", 0.0,
               f"latency_ratio={e1.latency_us / e4.latency_us:.2f} "
               f"(sub-linear: <4 due to 30% clock derate)")
    p16 = out[("fig10_procs_per_worker", Config(16, 1, 1, 4))]
    p32 = out[("fig10_procs_per_worker", Config(32, 1, 1, 4))]
    bench.emit("fig10/worker_saturation", 0.0,
               f"qps_gain_16to32={p32.throughput_qps / p16.throughput_qps:.2f}"
               f" (saturates ~1.0)")
    return out


if __name__ == "__main__":
    run(cli(__doc__)[0])
