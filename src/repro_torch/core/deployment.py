"""Deployment analyzer: the paper's parallel-configuration study (§4.3) and
Pareto analysis (Fig. 11), generalised.

Port of ``repro.core.deployment`` (host arithmetic only). A configuration
is (p processes, w workers, k kernels, e engines/kernel). Stage costs are
CALIBRATED from measurements (wrapper.measure_stage_times, on the card);
the multi-element scaling is then evaluated with a deterministic pipeline
model that reproduces the paper's observed couplings:

- engines/kernel speed up a single request but lower the clock (paper: ~30%
  lower frequency at 4 engines => sub-linear gain)   [Fig 7]
- more kernels raise throughput but slow each request (bigger circuit,
  slower clock)                                       [Fig 8]
- many workers feeding one kernel saturate the XRT-scheduler analog:
  dispatch serialises, latency grows linearly in feeders  [Fig 9]
- several processes per worker saturate the worker at ~16 p/w [Fig 10]

The derating constants below are the paper's figures, not measurements of
any device of this repo.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core.wrapper import StageTimes

# paper-calibrated derating factors
FREQ_DERATE_PER_ENGINE = {1: 1.00, 2: 0.85, 4: 0.70}   # ~30% @ 4 engines
FREQ_DERATE_PER_KERNEL = {1: 1.00, 2: 0.90, 4: 0.80}
WORKER_SATURATION = 16          # processes per worker (Fig 10)
XRT_DISPATCH_US = 35.0          # per-feeder serialisation cost (Fig 9)


@dataclass(frozen=True)
class Config:
    p: int   # producer processes
    w: int   # wrapper workers
    k: int   # kernels
    e: int   # engines per kernel

    def label(self) -> str:
        return f"{self.p}p {self.w}w {self.k}k {self.e}e"


@dataclass
class Perf:
    config: Config
    batch: int
    throughput_qps: float
    latency_us: float           # per-request execution time (90th pct analog)


def _interp_stage(times: Sequence[StageTimes], batch: int):
    """Log-log interpolation of measured stage costs at a batch size."""
    bs = np.array([t.batch for t in times], float)
    out = {}
    for name in ("encode_us", "dispatch_us", "kernel_us", "collect_us"):
        ys = np.array([getattr(t, name) for t in times], float)
        ys = np.maximum(ys, 1e-3)
        out[name] = float(np.exp(np.interp(np.log(batch), np.log(bs),
                                           np.log(ys))))
    return out


def evaluate(cfg: Config, stage_times: Sequence[StageTimes],
             batch: int) -> Perf:
    s = _interp_stage(stage_times, batch)
    e_der = FREQ_DERATE_PER_ENGINE.get(cfg.e, 0.7)
    k_der = FREQ_DERATE_PER_KERNEL.get(cfg.k, 0.8)
    clock = e_der * k_der

    # single-request path: encode on worker, dispatch (serialised per
    # feeding thread at the XRT analog), kernel split over e engines
    feeders = max(cfg.w // cfg.k, 1)
    kernel_us = s["kernel_us"] / (cfg.e * clock)
    dispatch_us = s["dispatch_us"] + XRT_DISPATCH_US * feeders
    # worker saturation: >16 producers per worker stop helping
    eff_p = min(cfg.p, cfg.w * WORKER_SATURATION)
    latency = (s["encode_us"] + dispatch_us + kernel_us + s["collect_us"])

    # pipeline throughput: encode (w workers) overlaps kernel (k kernels)
    enc_stage = s["encode_us"] / cfg.w
    ker_stage = (kernel_us + dispatch_us) / cfg.k
    col_stage = s["collect_us"] / cfg.w
    bottleneck_us = max(enc_stage, ker_stage, col_stage)
    # producers must generate enough load
    prod_rate = eff_p / max(s["encode_us"] * 0.25, 1.0)  # req/us upper bound
    tput = min(batch / bottleneck_us, prod_rate * batch) * 1e6
    return Perf(config=cfg, batch=batch, throughput_qps=tput,
                latency_us=latency)


def sweep(configs: Sequence[Config], stage_times: Sequence[StageTimes],
          batches: Sequence[int]) -> List[Perf]:
    return [evaluate(c, stage_times, b) for c in configs for b in batches]


def pareto(perfs: Sequence[Perf]) -> List[Perf]:
    """Non-dominated (max throughput, min latency) front."""
    pts = sorted(perfs, key=lambda p: (-p.throughput_qps, p.latency_us))
    front, best_lat = [], float("inf")
    for p in pts:
        if p.latency_us < best_lat:
            front.append(p)
            best_lat = p.latency_us
    return front
