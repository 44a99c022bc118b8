"""Fault tolerance: failure detection, elastic remesh, straggler mitigation.

Port of ``repro.ft.failures`` (numpy- and framework-free; the port keeps its
own copy so that it imports nothing of the reference package).

On a real multi-pod deployment the supervisor runs per-host; here the same
logic is executed in-process with simulated node events, and every piece is
unit-tested (tests/test_ft.py):

- `HeartbeatMonitor`: hosts report heartbeats; silence past `timeout` marks
  the host failed (the detection layer under both elastic restart and
  straggler handling).
- `ElasticPlan`: given surviving device count, pick the largest valid
  (data, model) mesh <= survivors (model parallelism is preserved — losing
  data-parallel replicas only shrinks global batch), rebuild shardings, and
  restore optimizer state from the last checkpoint via
  checkpoint.store.restore(..., shardings=new).
- `StragglerPolicy`: per-step deadline derived from a running latency EWMA;
  microbatch grads that miss the deadline are dropped and the gradient is
  rescaled by contributing/total (backup-worker dispatch is the serving-side
  analog, implemented in serve.engine).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class HeartbeatMonitor:
    timeout: float = 10.0
    _last: Dict[str, float] = field(default_factory=dict)

    def beat(self, host: str, now: Optional[float] = None):
        self._last[host] = time.monotonic() if now is None else now

    def failed(self, now: Optional[float] = None) -> List[str]:
        t = time.monotonic() if now is None else now
        return [h for h, ts in self._last.items() if t - ts > self.timeout]

    def alive(self, now: Optional[float] = None) -> List[str]:
        t = time.monotonic() if now is None else now
        return [h for h, ts in self._last.items() if t - ts <= self.timeout]


@dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    global_batch: int
    dropped_devices: int

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def plan_elastic_mesh(n_surviving: int, model_parallel: int,
                      global_batch: int, min_data: int = 1,
                      orig_data: Optional[int] = None) -> ElasticPlan:
    """Largest (data, model) mesh with the SAME model parallelism that fits
    the survivors; global batch shrinks to keep per-replica batch constant.

    Model-parallel groups are atomic: losing one chip kills its whole TP
    group, so survivors round down to a multiple of `model_parallel`.
    """
    if n_surviving < model_parallel * min_data:
        raise ValueError(
            f"not enough devices: {n_surviving} < {model_parallel * min_data}")
    data = n_surviving // model_parallel
    # keep per-replica batch constant; shrink global batch proportionally
    per_replica = max(global_batch // max(orig_data or data, 1), 1)
    gb = per_replica * data
    used = data * model_parallel
    return ElasticPlan(data=data, model=model_parallel, global_batch=gb,
                       dropped_devices=n_surviving - used)


@dataclass
class StragglerPolicy:
    """Deadline = ewma * tolerance. Contributions missing the deadline are
    dropped; the aggregated gradient is rescaled by n_done/n_total."""
    tolerance: float = 3.0
    ewma_alpha: float = 0.2
    _ewma: Optional[float] = None

    def deadline(self) -> Optional[float]:
        return None if self._ewma is None else self._ewma * self.tolerance

    def observe(self, latency: float):
        self._ewma = latency if self._ewma is None else (
            self.ewma_alpha * latency + (1 - self.ewma_alpha) * self._ewma)

    def commit(self, latencies: Sequence[float]
               ) -> Tuple[List[int], float]:
        """Given per-worker step latencies, return (kept worker indices,
        gradient rescale factor)."""
        dl = self.deadline()
        if dl is None:
            kept = list(range(len(latencies)))
        else:
            kept = [i for i, l in enumerate(latencies) if l <= dl]
            if not kept:           # everyone late: keep fastest, reset ewma
                kept = [int(min(range(len(latencies)),
                                key=lambda i: latencies[i]))]
        for i in kept:
            self.observe(latencies[i])
        scale = len(latencies) / max(len(kept), 1)
        return kept, scale


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples: step -> host."""
    schedule: Dict[int, str] = field(default_factory=dict)

    def check(self, step: int) -> Optional[str]:
        return self.schedule.get(step)


@dataclass
class DelayInjector:
    """Deterministic injected execution delays, keyed by target (host id,
    serving-replica index, ...): the straggler-side sibling of
    ``FailureInjector``. ``repro_torch.serve`` replica workers call
    :meth:`apply` before each device execution, so a delayed replica
    behaves exactly like a slow accelerator — routing and admission-queue
    behaviour under stragglers become testable without real slow hardware.
    """
    delays: Dict[object, float] = field(default_factory=dict)

    def delay_for(self, target) -> float:
        return float(self.delays.get(target, 0.0))

    def apply(self, target, sleep=time.sleep) -> float:
        d = self.delay_for(target)
        if d > 0:
            sleep(d)
        return d
