"""Capacity subsystem: online bottleneck detection, adaptive host/device
balance control, and cost-efficiency reporting.

The paper's central deployment finding (§5–6, Tables 2–3) is that the
accelerator's gains evaporate — and the system can get *more expensive*
per query — when the deployment is imbalanced: a weak CPU cannot generate
enough load for a powerful accelerator, so the FPGA idles while the bill
keeps running. PR 2's replica sweep reproduced exactly that plateau
(throughput pinned at the serial-host prepare cap regardless of replica
count), but diagnosing and re-tuning was the operator's job. This module
closes the loop:

- :class:`BottleneckMonitor` — consumes the serving stack's metric
  signals (host-prepare rate, device-idle fraction, queue fill, cache hit
  rate) over sliding windows and classifies the run as **host-bound**,
  **device-bound**, **admission-bound**, or **balanced**. Hysteresis
  (``confirm`` consecutive windows before a switch) keeps the published
  diagnosis from flapping on noisy windows.
- :class:`CapacityController` — a control loop over an actuator (the
  :class:`~repro_torch.serve.scheduler.AsyncScheduler` implements the protocol)
  that acts on the diagnosis: grows/shrinks the batch-bucket target,
  activates or parks replicas within a device budget, and adapts the
  admission limit with AIMD so offered load tracks the true bottleneck
  instead of the static queue bound. ``capacity=None`` (the default
  everywhere) wires nothing and leaves the serving stack bit-identical
  to its uncontrolled behavior.
- :class:`CostReport` — maps measured steady-state throughput through the
  deployment prices of :mod:`repro_torch.core.cost_model` to $/1k-queries per
  (host, accelerator, replica-count) configuration — the paper's
  balanced-vs-imbalanced cost comparison, computed from *our* measured
  numbers rather than the paper's.

Use via config (``ServeConfig(capacity=...)`` / ``SchedulerConfig
(capacity=...)``) or standalone::

    from repro_torch.capacity import BottleneckMonitor, CapacitySignals

    mon = BottleneckMonitor(confirm=2)
    for sig in windows:                    # CapacitySignals stream
        diagnosis = mon.observe(sig)

Port of ``repro.serve.capacity``.
"""
from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import (aws_accel_usd_per_hour,
                                   aws_host_usd_per_hour,
                                   usd_per_1k_queries)
from repro_torch.serve.config import Coercible
from repro_torch.serve.metrics import SignalSnapshot


class Bottleneck(str, enum.Enum):
    """Where the serving stack's throughput is currently capped."""
    HOST_BOUND = "host_bound"            # serial host prepare saturated,
                                         # devices starved
    DEVICE_BOUND = "device_bound"        # accelerators saturated
    ADMISSION_BOUND = "admission_bound"  # queue bound rejects load while
                                         # host AND device have headroom
    BALANCED = "balanced"

    def __str__(self) -> str:            # StrEnum parity on py3.10
        return self.value


@dataclass(frozen=True)
class CapacitySignals:
    """One sliding window of serving signals — what the monitor consumes.

    Built from two cumulative :class:`~repro_torch.serve.metrics.SignalSnapshot`
    totals (:meth:`between`) plus the scheduler's live admission state;
    tests construct instances directly to drive the classifier with
    synthetic streams.
    """
    t: float                      # window end (scheduler clock)
    window_s: float
    arrival_rate: float           # requests/s offered in the window
    completion_rate: float
    reject_rate: float            # rejects + sheds per second
    host_prepare_rate: float      # host-prepared batches per second
    host_busy_fraction: float     # encode time / window (serial host path)
    device_idle_fraction: float   # 1 - busy/(window * active replicas)
    queue_fill: float             # admission depth / admission limit
    cache_hit_rate: float         # (hits+coalesced)/tracked in the window
    n_active_replicas: int = 1
    replica_queue_depths: Tuple[int, ...] = ()

    @classmethod
    def between(cls, prev: SignalSnapshot, cur: SignalSnapshot, *,
                queue_depth: int, admission_limit: int,
                n_active_replicas: int = 1,
                replica_queue_depths: Sequence[int] = ()
                ) -> "CapacitySignals":
        """Window rates from two cumulative snapshots + live queue state."""
        w = max(cur.t - prev.t, 1e-9)
        d_hits = cur.cache_hits - prev.cache_hits
        d_miss = cur.cache_misses - prev.cache_misses
        d_coal = cur.cache_coalesced - prev.cache_coalesced
        tracked = d_hits + d_miss + d_coal
        n_active = max(1, n_active_replicas)
        busy = (cur.device_busy_s - prev.device_busy_s) / (w * n_active)
        return cls(
            t=cur.t, window_s=w,
            arrival_rate=(cur.n_arrivals - prev.n_arrivals) / w,
            completion_rate=(cur.n_completions - prev.n_completions) / w,
            reject_rate=(cur.n_rejected - prev.n_rejected
                         + cur.n_shed - prev.n_shed) / w,
            host_prepare_rate=(cur.n_encoded_batches
                               - prev.n_encoded_batches) / w,
            host_busy_fraction=min(
                1.0, (cur.encode_busy_s - prev.encode_busy_s) / w),
            device_idle_fraction=max(0.0, min(1.0, 1.0 - busy)),
            queue_fill=queue_depth / max(1, admission_limit),
            cache_hit_rate=(d_hits + d_coal) / tracked if tracked else 0.0,
            n_active_replicas=n_active,
            replica_queue_depths=tuple(replica_queue_depths),
        )


class BottleneckMonitor:
    """Sliding-window bottleneck classifier with hysteresis.

    :meth:`classify` is the stateless per-window rule; :meth:`observe`
    applies hysteresis — the published :attr:`diagnosis` only switches
    after ``confirm`` consecutive windows agree on a new label, so one
    noisy window can never flap the controller.
    """

    def __init__(self, *, idle_hi: float = 0.5, idle_lo: float = 0.15,
                 host_busy_hi: float = 0.6, queue_hi: float = 0.85,
                 confirm: int = 2):
        self.idle_hi = idle_hi
        self.idle_lo = idle_lo
        self.host_busy_hi = host_busy_hi
        self.queue_hi = queue_hi
        self.confirm = max(1, confirm)
        self.diagnosis = Bottleneck.BALANCED
        self.history: List[Tuple[float, Bottleneck]] = []   # published flips
        self._candidate: Optional[Bottleneck] = None
        self._streak = 0

    def classify(self, s: CapacitySignals) -> Bottleneck:
        """Raw single-window classification (no hysteresis)."""
        if s.arrival_rate <= 0 and s.queue_fill <= 0:
            return Bottleneck.BALANCED          # idle stack: nothing to fix
        pressured = s.queue_fill >= self.queue_hi or s.reject_rate > 0
        if s.host_busy_fraction >= self.host_busy_hi \
                and s.device_idle_fraction >= self.idle_hi:
            # host saturated while devices starve: the paper's weak-CPU /
            # strong-FPGA imbalance
            return Bottleneck.HOST_BOUND
        if s.device_idle_fraction <= self.idle_lo:
            return Bottleneck.DEVICE_BOUND
        if pressured and s.device_idle_fraction >= self.idle_hi:
            # queue bound binds while both sides have headroom: the static
            # admission limit, not the hardware, is refusing the load
            return Bottleneck.ADMISSION_BOUND
        return Bottleneck.BALANCED

    def observe(self, s: CapacitySignals) -> Bottleneck:
        """Feed one window; returns the (hysteresis-filtered) diagnosis."""
        raw = self.classify(s)
        if raw == self.diagnosis:
            self._candidate, self._streak = None, 0
        elif raw == self._candidate:
            self._streak += 1
            if self._streak >= self.confirm:
                self.diagnosis = raw
                self.history.append((s.t, raw))
                self._candidate, self._streak = None, 0
        else:
            self._candidate, self._streak = raw, 1
            if self.confirm <= 1:
                self.diagnosis = raw
                self.history.append((s.t, raw))
                self._candidate, self._streak = None, 0
        return self.diagnosis


@dataclass
class CapacityConfig(Coercible):
    """Knobs for the capacity control loop (attach to
    ``ServeConfig.capacity`` / ``SchedulerConfig.capacity``; ``None``
    keeps the subsystem fully unwired and the stack bit-identical to its
    uncontrolled behavior).

    Monitor:     ``window_s``, ``confirm``, ``idle_hi``, ``idle_lo``,
                 ``host_busy_hi``, ``queue_hi`` (see
                 :class:`BottleneckMonitor`).
    Batch:       target-batch bounds ``min_batch``/``max_batch`` —
                 host-bound runs grow the bucket target (amortising the
                 per-batch host cost), bounded by the compile buckets.
    Replicas:    ``min_replicas``/``max_replicas`` device budget;
                 ``initial_replicas`` parks down to a starting set so
                 device-bound runs can demonstrate activation.
    Admission:   AIMD on the admission limit — additive ``queue_ai`` per
                 window with headroom, multiplicative ``queue_md`` under
                 congestion, clamped to [``min_queue``, ``max_queue``].
    """
    window_s: float = 0.25
    confirm: int = 2
    idle_hi: float = 0.5
    idle_lo: float = 0.15
    host_busy_hi: float = 0.6
    queue_hi: float = 0.85
    min_batch: int = 2
    max_batch: int = 64
    min_replicas: int = 1
    max_replicas: Optional[int] = None     # None = every built replica
    initial_replicas: Optional[int] = None
    min_queue: int = 8
    max_queue: int = 256
    queue_ai: int = 8
    queue_md: float = 0.5


@dataclass(frozen=True)
class ControllerAction:
    """One control decision: what the controller changed and why."""
    t: float
    diagnosis: str
    action: str          # grow_batch / park_replica / activate_replica /
                         # queue_increase / queue_decrease
    before: float
    after: float

    def as_dict(self) -> Dict[str, object]:
        return {"t": self.t, "diagnosis": self.diagnosis,
                "action": self.action, "before": self.before,
                "after": self.after}


class CapacityController:
    """Adaptive host/device balance control loop.

    ``actuator`` is any object implementing the capacity protocol (the
    :class:`~repro_torch.serve.scheduler.AsyncScheduler` does):

    - ``capacity_state() -> dict`` with ``queue_depth``,
      ``admission_limit``, ``target_batch``, ``n_active``, ``n_replicas``,
      ``replica_depths``
    - ``set_target_batch(n)`` / ``set_admission_limit(n)`` /
      ``set_active_replicas(n)``

    Policy per published diagnosis:

    - **host-bound** — double the batch-bucket target (amortise the
      per-batch host cost over more requests) up to ``max_batch``; once
      maxed, park an idle replica (devices are starving anyway — parked
      replicas stop costing money in the :class:`CostReport`) and, under
      queue congestion, multiplicatively shrink the admission limit so
      queue wait stops masquerading as capacity.
    - **device-bound** — activate a parked replica within the device
      budget; at budget, grow the batch target (amortise per-batch device
      overhead), then AIMD-shrink admission under congestion: the system
      is genuinely full.
    - **admission-bound** — the static queue bound is the limiter while
      both sides have headroom: additively raise the admission limit.
    - **balanced** — gentle additive probe of the admission limit when
      the queue is working (> half full), otherwise no-op.

    :meth:`tick` is one synchronous control step (tests drive it
    directly); :meth:`start` runs ticks on a daemon thread every
    ``window_s``. A controller exception never kills the serving
    pipeline — it is recorded on :attr:`error` and the loop stops.
    """

    def __init__(self, actuator, config=None, *, metrics=None, clock=None,
                 tracer=None):
        self.cfg = CapacityConfig.coerce(config) or CapacityConfig()
        self.actuator = actuator
        self.metrics = metrics
        self.tracer = tracer            # controller actions as trace events
        self.clock = clock if clock is not None else time.perf_counter
        self.monitor = BottleneckMonitor(
            idle_hi=self.cfg.idle_hi, idle_lo=self.cfg.idle_lo,
            host_busy_hi=self.cfg.host_busy_hi, queue_hi=self.cfg.queue_hi,
            confirm=self.cfg.confirm)
        self.actions: List[ControllerAction] = []
        self.error: Optional[BaseException] = None
        self._prev: Optional[SignalSnapshot] = None
        # (t, n_active) timeline for the time-weighted mean the cost
        # report charges for
        self._active_log: List[Tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "CapacityController":
        if self._thread is None:
            if self.cfg.initial_replicas is not None:
                self._set_active(self.cfg.initial_replicas, self.clock(),
                                 "initial", log=False)
            self._active_log.append(
                (self.clock(), self.actuator.capacity_state()["n_active"]))
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def _loop(self):
        while not self._stop.wait(self.cfg.window_s):
            try:
                self.tick()
            except BaseException as e:      # never kill the pipeline
                self.error = e
                return

    # -- one control step ----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[Bottleneck]:
        """Snapshot -> window signals -> diagnosis -> actions. Returns the
        published diagnosis (None on the priming tick)."""
        now = self.clock() if now is None else now
        snap = self.metrics.snapshot(now)
        state = self.actuator.capacity_state()
        prev, self._prev = self._prev, snap
        if prev is None:
            return None                     # priming: need two snapshots
        sig = CapacitySignals.between(
            prev, snap,
            queue_depth=state["queue_depth"],
            admission_limit=state["admission_limit"],
            n_active_replicas=state["n_active"],
            replica_queue_depths=state.get("replica_depths", ()))
        diag = self.monitor.observe(sig)
        self._act(diag, sig, state, now)
        return diag

    def _budget(self, state) -> int:
        n = state["n_replicas"]
        return min(self.cfg.max_replicas or n, n)

    def _act(self, diag: Bottleneck, sig: CapacitySignals, state, now):
        tb = state["target_batch"]
        lim = state["admission_limit"]
        n_active = state["n_active"]
        congested = sig.queue_fill >= 0.9
        if diag == Bottleneck.HOST_BOUND:
            if tb < self.cfg.max_batch:
                self._set_batch(min(self.cfg.max_batch, tb * 2), now, diag)
            else:
                if n_active > self.cfg.min_replicas \
                        and sig.device_idle_fraction >= self.cfg.idle_hi:
                    self._set_active(n_active - 1, now, diag)
                if congested and lim > self.cfg.min_queue:
                    self._set_limit(
                        max(self.cfg.min_queue,
                            int(lim * self.cfg.queue_md)), now, diag)
        elif diag == Bottleneck.DEVICE_BOUND:
            if n_active < self._budget(state):
                self._set_active(n_active + 1, now, diag)
            elif tb < self.cfg.max_batch and congested:
                self._set_batch(min(self.cfg.max_batch, tb * 2), now, diag)
            elif congested and lim > self.cfg.min_queue:
                self._set_limit(
                    max(self.cfg.min_queue,
                        int(lim * self.cfg.queue_md)), now, diag)
        elif diag == Bottleneck.ADMISSION_BOUND:
            if lim < self.cfg.max_queue:
                self._set_limit(min(self.cfg.max_queue,
                                    lim + self.cfg.queue_ai), now, diag)
        else:   # BALANCED: probe the admission limit upward when in use
            if sig.queue_fill >= 0.5 and lim < self.cfg.max_queue:
                self._set_limit(min(self.cfg.max_queue,
                                    lim + self.cfg.queue_ai), now, diag)

    # -- actuation + logging -------------------------------------------------
    def _log(self, t, diag, action, before, after):
        a = ControllerAction(t=t, diagnosis=str(diag), action=action,
                             before=float(before), after=float(after))
        self.actions.append(a)
        if self.metrics is not None:
            self.metrics.on_capacity(a.as_dict())
        if self.tracer is not None:
            # batch-target doubling / replica parking shows up on the
            # same timeline as the requests it affects
            self.tracer.mark("controller", t, action=action,
                             diagnosis=str(diag), before=float(before),
                             after=float(after))

    def _set_batch(self, n, now, diag):
        before = self.actuator.capacity_state()["target_batch"]
        n = max(self.cfg.min_batch, min(self.cfg.max_batch, int(n)))
        if n == before:
            return
        self.actuator.set_target_batch(n)
        self._log(now, diag, "grow_batch" if n > before else "shrink_batch",
                  before, n)

    def _set_limit(self, n, now, diag):
        before = self.actuator.capacity_state()["admission_limit"]
        n = max(self.cfg.min_queue, min(self.cfg.max_queue, int(n)))
        if n == before:
            return
        self.actuator.set_admission_limit(n)
        self._log(now, diag, "queue_increase" if n > before
                  else "queue_decrease", before, n)

    def _set_active(self, n, now, diag, *, log=True):
        state = self.actuator.capacity_state()
        before = state["n_active"]
        n = max(self.cfg.min_replicas, min(self._budget(state), int(n)))
        if n == before:
            return
        self.actuator.set_active_replicas(n)
        self._active_log.append((now, n))
        if log:
            self._log(now, diag, "activate_replica" if n > before
                      else "park_replica", before, n)

    # -- reporting -----------------------------------------------------------
    def mean_active_replicas(self, now: Optional[float] = None) -> float:
        """Time-weighted mean of the active replica count — what the cost
        report charges for (a parked replica could be serving another
        tenant / powered down)."""
        if not self._active_log:
            return float(self.actuator.capacity_state()["n_active"])
        now = self.clock() if now is None else now
        total = weight = 0.0
        for (t0, n), (t1, _) in zip(self._active_log,
                                    self._active_log[1:]
                                    + [(now, self._active_log[-1][1])]):
            dt = max(0.0, t1 - t0)
            total += n * dt
            weight += dt
        return total / weight if weight > 0 else float(
            self._active_log[-1][1])

    def summary(self) -> Dict[str, object]:
        state = self.actuator.capacity_state()
        return {
            "diagnosis": str(self.monitor.diagnosis),
            "history": [(t, str(d)) for t, d in self.monitor.history],
            "n_actions": len(self.actions),
            "final": {"target_batch": state["target_batch"],
                      "admission_limit": state["admission_limit"],
                      "n_active": state["n_active"]},
            "mean_active_replicas": self.mean_active_replicas(),
            "error": repr(self.error) if self.error is not None else None,
        }


# ---------------------------------------------------------------------------
# Cost-efficiency reporting ($/1k-queries through the paper's unit prices)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BoxPrice:
    """$/hour prices for one (host, accelerator) box family."""
    name: str
    host_usd_per_hour: float
    accel_usd_per_hour: float       # per active accelerator replica

    def usd_per_hour(self, replicas: float) -> float:
        return self.host_usd_per_hour + replicas * self.accel_usd_per_hour


# the paper's Table 2 cloud unit prices, pro-rated per box: a weak 8-vCPU
# f1-style host vs a 48-vCPU c5-style host, each feeding N accelerator
# replicas priced at the f1.2xlarge's accelerator share
PAPER_BOXES: Dict[str, BoxPrice] = {
    "weak_host": BoxPrice("8-vCPU host + FPGA replicas",
                          aws_host_usd_per_hour(8), aws_accel_usd_per_hour()),
    "balanced": BoxPrice("48-vCPU host + FPGA replicas",
                         aws_host_usd_per_hour(48), aws_accel_usd_per_hour()),
}


@dataclass(frozen=True)
class CostRow:
    """One measured configuration priced out."""
    config: str
    host: str
    replicas: float               # time-weighted mean active replicas
    achieved_qps: float
    usd_per_hour: float
    usd_per_1k: float

    def as_dict(self) -> Dict[str, object]:
        return {"config": self.config, "host": self.host,
                "replicas": self.replicas,
                "achieved_qps": self.achieved_qps,
                "usd_per_hour": self.usd_per_hour,
                "usd_per_1k_queries": self.usd_per_1k}


@dataclass
class CostReport:
    """Measured throughput -> $/1k-queries per configuration.

    ``add(...)`` one row per (host profile, replica count) measurement;
    prices come from a :class:`BoxPrice` (default: the paper-derived
    :data:`PAPER_BOXES`). The resulting table is the paper's Tables 2–3
    argument — a weak host feeding many accelerators can cost *more* per
    query than a balanced box — computed from our own steady-state
    numbers.
    """
    rows: List[CostRow] = field(default_factory=list)

    def add(self, config: str, *, host: str, replicas: float,
            achieved_qps: float,
            price: Optional[BoxPrice] = None) -> CostRow:
        price = price if price is not None else PAPER_BOXES[host]
        usd_h = price.usd_per_hour(replicas)
        row = CostRow(config=config, host=host, replicas=float(replicas),
                      achieved_qps=float(achieved_qps), usd_per_hour=usd_h,
                      usd_per_1k=usd_per_1k_queries(usd_h, achieved_qps))
        self.rows.append(row)
        return row

    def best(self) -> Optional[CostRow]:
        return min(self.rows, key=lambda r: r.usd_per_1k, default=None)

    def as_dict(self) -> Dict[str, object]:
        best = self.best()
        return {"rows": [r.as_dict() for r in self.rows],
                "best": best.as_dict() if best is not None else None}

    def table(self) -> str:
        """Markdown table (README / benchmark logs)."""
        lines = ["| config | host | replicas | qps | $/h | $/1k queries |",
                 "|---|---|---|---|---|---|"]
        for r in sorted(self.rows, key=lambda r: r.usd_per_1k):
            lines.append(
                f"| {r.config} | {r.host} | {r.replicas:.2f} "
                f"| {r.achieved_qps:.0f} | {r.usd_per_hour:.3f} "
                f"| {r.usd_per_1k:.5f} |")
        return "\n".join(lines)
