"""Port of the serving stack, capacity subsystem: the cases of
``tests/test_capacity.py`` run against ``repro_torch.capacity`` and
``repro_torch.serve``, plus parity with the JAX package on the same seeds:
``BottleneckMonitor`` classifications (and their hysteresis history) on one
``SignalSnapshot`` sequence, the controller's actions against the same
scripted stream, and ``CostReport`` numbers equal the reference's exactly.
"""
import time

import numpy as np
import pytest

import repro.capacity as JC
from repro_torch.capacity import (PAPER_BOXES, Bottleneck, BottleneckMonitor,
                                  CapacityConfig, CapacityController,
                                  CapacitySignals, CostReport, SignalSnapshot)
from repro_torch.core.cost_model import (aws_accel_usd_per_hour,
                                         aws_host_usd_per_hour,
                                         usd_per_1k_queries)
from repro_torch.serve import (AsyncScheduler, Request, SchedulerConfig,
                               ServeConfig, SimServer, build, sim_requests)


def _sig(**kw):
    """CapacitySignals with quiet defaults; override per test."""
    base = dict(t=0.0, window_s=0.25, arrival_rate=100.0,
                completion_rate=100.0, reject_rate=0.0,
                host_prepare_rate=50.0, host_busy_fraction=0.2,
                device_idle_fraction=0.3, queue_fill=0.2,
                cache_hit_rate=0.0)
    base.update(kw)
    return CapacitySignals(**base)


def _snap(t, **kw):
    base = dict(t=t, n_arrivals=0, n_completions=0, n_rejected=0,
                n_shed=0, n_encoded_batches=0, encode_busy_s=0.0,
                device_busy_s=0.0, cache_hits=0, cache_misses=0,
                cache_coalesced=0)
    base.update(kw)
    return SignalSnapshot(**base)


def _req(rid, tokens, *, max_new=4, arrival=0.0):
    return Request(rid=rid, tokens=np.asarray(tokens, np.int32),
                   max_new_tokens=max_new, arrival=arrival)


# -- monitor: stateless classification ----------------------------------------

def test_classify_idle_stack_is_balanced():
    mon = BottleneckMonitor()
    assert mon.classify(_sig(arrival_rate=0.0, queue_fill=0.0,
                             host_busy_fraction=0.0,
                             device_idle_fraction=1.0)) \
        == Bottleneck.BALANCED


def test_classify_host_bound():
    # the paper's imbalance: host saturated, accelerator starving
    mon = BottleneckMonitor()
    assert mon.classify(_sig(host_busy_fraction=0.95,
                             device_idle_fraction=0.8)) \
        == Bottleneck.HOST_BOUND


def test_classify_device_bound():
    mon = BottleneckMonitor()
    assert mon.classify(_sig(host_busy_fraction=0.2,
                             device_idle_fraction=0.05)) \
        == Bottleneck.DEVICE_BOUND


def test_classify_admission_bound_needs_pressure_and_headroom():
    mon = BottleneckMonitor()
    # queue pinned at the bound, both sides idle: the static limit binds
    assert mon.classify(_sig(queue_fill=0.95, host_busy_fraction=0.2,
                             device_idle_fraction=0.7)) \
        == Bottleneck.ADMISSION_BOUND
    # rejects count as pressure even with a short queue
    assert mon.classify(_sig(queue_fill=0.1, reject_rate=50.0,
                             host_busy_fraction=0.2,
                             device_idle_fraction=0.7)) \
        == Bottleneck.ADMISSION_BOUND
    # same pressure but the device is busy: not an admission problem
    assert mon.classify(_sig(queue_fill=0.95, host_busy_fraction=0.2,
                             device_idle_fraction=0.3)) \
        == Bottleneck.BALANCED


# -- monitor: hysteresis / no-flap --------------------------------------------

def test_one_noisy_window_cannot_flip_the_diagnosis():
    mon = BottleneckMonitor(confirm=2)
    quiet = _sig()
    noisy = _sig(host_busy_fraction=0.95, device_idle_fraction=0.8)
    assert mon.observe(quiet) == Bottleneck.BALANCED
    assert mon.observe(noisy) == Bottleneck.BALANCED      # candidate only
    assert mon.observe(quiet) == Bottleneck.BALANCED      # streak broken
    assert mon.observe(noisy) == Bottleneck.BALANCED      # fresh candidate
    assert mon.history == []                              # never flipped


def test_confirm_consecutive_windows_flip_and_record_history():
    mon = BottleneckMonitor(confirm=2)
    hostish = _sig(t=1.0, host_busy_fraction=0.95,
                   device_idle_fraction=0.8)
    assert mon.observe(hostish) == Bottleneck.BALANCED    # 1st: candidate
    assert mon.observe(hostish) == Bottleneck.HOST_BOUND  # 2nd: confirmed
    assert mon.history == [(1.0, Bottleneck.HOST_BOUND)]
    # staying in the same regime adds no history
    mon.observe(hostish)
    assert len(mon.history) == 1


def test_confirm_one_flips_immediately():
    mon = BottleneckMonitor(confirm=1)
    assert mon.observe(_sig(device_idle_fraction=0.05)) \
        == Bottleneck.DEVICE_BOUND
    assert len(mon.history) == 1


def test_candidate_switch_resets_the_streak():
    mon = BottleneckMonitor(confirm=3)
    host = _sig(host_busy_fraction=0.95, device_idle_fraction=0.8)
    dev = _sig(device_idle_fraction=0.05)
    mon.observe(host)
    mon.observe(host)                 # streak 2 of 3 toward HOST_BOUND
    mon.observe(dev)                  # different candidate: streak resets
    assert mon.diagnosis == Bottleneck.BALANCED
    mon.observe(dev)
    assert mon.diagnosis == Bottleneck.BALANCED
    mon.observe(dev)                  # 3 consecutive DEVICE_BOUND windows
    assert mon.diagnosis == Bottleneck.DEVICE_BOUND


# -- CapacitySignals.between --------------------------------------------------

def test_between_turns_cumulative_snapshots_into_window_rates():
    prev = _snap(1.0, n_arrivals=100, n_completions=90, n_shed=2,
                 n_encoded_batches=10, encode_busy_s=0.5,
                 device_busy_s=0.4, cache_hits=10, cache_misses=80,
                 cache_coalesced=10)
    cur = _snap(1.5, n_arrivals=200, n_completions=160, n_rejected=5,
                n_shed=2, n_encoded_batches=25, encode_busy_s=0.9,
                device_busy_s=0.8, cache_hits=30, cache_misses=150,
                cache_coalesced=20)
    s = CapacitySignals.between(prev, cur, queue_depth=32,
                                admission_limit=64, n_active_replicas=2,
                                replica_queue_depths=(1, 2))
    assert s.window_s == pytest.approx(0.5)
    assert s.arrival_rate == pytest.approx(200.0)
    assert s.completion_rate == pytest.approx(140.0)
    assert s.reject_rate == pytest.approx(10.0)       # 5 rejects + 0 sheds
    assert s.host_prepare_rate == pytest.approx(30.0)
    assert s.host_busy_fraction == pytest.approx(0.8)
    # busy 0.4s over a 0.5s window across 2 active replicas = 0.4 busy
    assert s.device_idle_fraction == pytest.approx(0.6)
    assert s.queue_fill == pytest.approx(0.5)
    # (20 hits + 10 coalesced) / 100 tracked in the window
    assert s.cache_hit_rate == pytest.approx(0.3)
    assert s.replica_queue_depths == (1, 2)


def test_between_is_safe_on_degenerate_windows():
    prev = _snap(1.0)
    s = CapacitySignals.between(prev, _snap(1.0), queue_depth=0,
                                admission_limit=0)
    assert s.cache_hit_rate == 0.0 and s.queue_fill == 0.0
    assert 0.0 <= s.device_idle_fraction <= 1.0


# -- config coercion ----------------------------------------------------------

def test_capacity_config_coerce_spellings():
    assert CapacityConfig.coerce(None) is None
    assert CapacityConfig.coerce(False) is None
    assert isinstance(CapacityConfig.coerce(True), CapacityConfig)
    cfg = CapacityConfig.coerce({"max_batch": 16, "confirm": 3})
    assert cfg.max_batch == 16 and cfg.confirm == 3
    explicit = CapacityConfig(window_s=0.1)
    assert CapacityConfig.coerce(explicit) is explicit
    with pytest.raises(ValueError):
        CapacityConfig.coerce("yes please")


# -- controller policy against a fake actuator (threadless ticks) -------------

class FakeActuator:
    def __init__(self, *, target_batch=4, admission_limit=64, n_active=2,
                 n_replicas=4):
        self.target_batch = target_batch
        self.admission_limit = admission_limit
        self.n_active = n_active
        self.n_replicas = n_replicas
        self.queue_depth = 0

    def capacity_state(self):
        return {"queue_depth": self.queue_depth,
                "target_batch": self.target_batch,
                "admission_limit": self.admission_limit,
                "n_active": self.n_active,
                "n_replicas": self.n_replicas,
                "replica_depths": ()}

    def set_target_batch(self, n):
        self.target_batch = n

    def set_admission_limit(self, n):
        self.admission_limit = n

    def set_active_replicas(self, n):
        self.n_active = n
        return n


class ScriptedMetrics:
    """Feeds the controller a pre-scripted SignalSnapshot stream."""

    def __init__(self, snaps):
        self.snaps = list(snaps)
        self.logged = []

    def snapshot(self, now):
        return self.snaps.pop(0)

    def on_capacity(self, entry):
        self.logged.append(entry)


def _hostbound_snaps(n, *, dt=0.1, congested=False):
    """Cumulative stream whose every window diffs to host-saturated /
    device-starved signals (optionally with the queue pinned full)."""
    return [_snap(i * dt, n_arrivals=i * 100, n_completions=i * 50,
                  n_encoded_batches=i * 10, encode_busy_s=i * dt * 0.95,
                  device_busy_s=i * dt * 0.1)
            for i in range(n)]


def test_controller_primes_then_diagnoses_and_grows_batch():
    act = FakeActuator(target_batch=4, n_active=2)
    met = ScriptedMetrics(_hostbound_snaps(6))
    ctl = CapacityController(act, CapacityConfig(confirm=2, min_batch=2,
                                                 max_batch=16),
                             metrics=met, clock=lambda: 0.0)
    assert ctl.tick(0.0) is None                    # priming tick
    assert ctl.tick(0.1) == Bottleneck.BALANCED     # candidate window 1
    assert ctl.tick(0.2) == Bottleneck.HOST_BOUND   # confirmed
    assert act.target_batch == 8                    # doubled once
    ctl.tick(0.3)
    assert act.target_batch == 16                   # doubled to the max
    assert [a["action"] for a in met.logged] \
        == ["grow_batch", "grow_batch"]
    assert ctl.summary()["diagnosis"] == "host_bound"


def test_host_bound_at_max_batch_parks_an_idle_replica():
    act = FakeActuator(target_batch=16, n_active=3)
    met = ScriptedMetrics(_hostbound_snaps(6))
    ctl = CapacityController(
        act, CapacityConfig(confirm=1, max_batch=16, min_replicas=1),
        metrics=met, clock=lambda: 0.0)
    ctl.tick(0.0)
    ctl.tick(0.1)                                   # diagnose + act
    assert act.n_active == 2
    assert met.logged[-1]["action"] == "park_replica"
    ctl.tick(0.2)
    assert act.n_active == 1
    ctl.tick(0.3)                                   # min_replicas floor
    assert act.n_active == 1


def test_device_bound_activates_replicas_within_budget():
    # summed device busy of 0.3s per 0.1s window: saturates up to three
    # active replicas, so the diagnosis holds while the controller ramps
    snaps = [_snap(i * 0.1, n_arrivals=i * 100, n_completions=i * 90,
                   n_encoded_batches=i * 10, encode_busy_s=i * 0.1 * 0.2,
                   device_busy_s=i * 0.1 * 3.0)
             for i in range(8)]
    act = FakeActuator(n_active=1, n_replicas=4)
    met = ScriptedMetrics(snaps)
    ctl = CapacityController(act, CapacityConfig(confirm=1, max_replicas=3),
                             metrics=met, clock=lambda: 0.0)
    # device_busy normalised per active replica: with 1 active the device
    # looks saturated, so each tick activates one more up to the budget
    for i in range(5):
        ctl.tick(i * 0.1)
    assert act.n_active == 3                        # capped by max_replicas
    assert [a["action"] for a in met.logged] \
        == ["activate_replica", "activate_replica"]


def test_admission_bound_aimd_additive_increase():
    snaps = [_snap(i * 0.1, n_arrivals=i * 100, n_completions=i * 100,
                   n_rejected=i * 10, n_encoded_batches=i * 10,
                   encode_busy_s=i * 0.1 * 0.2,
                   device_busy_s=i * 0.1 * 0.2)    # rejecting with headroom
             for i in range(8)]
    act = FakeActuator(admission_limit=64)
    met = ScriptedMetrics(snaps)
    ctl = CapacityController(
        act, CapacityConfig(confirm=1, queue_ai=8, max_queue=96),
        metrics=met, clock=lambda: 0.0)
    for i in range(6):
        ctl.tick(i * 0.1)
    assert act.admission_limit == 96                # 64 +8 +8 +8, clamped
    assert all(a["action"] == "queue_increase" for a in met.logged)


def test_host_bound_congestion_aimd_multiplicative_decrease():
    act = FakeActuator(target_batch=16, n_active=1, admission_limit=128)
    act.queue_depth = 128                           # queue pinned full
    met = ScriptedMetrics(_hostbound_snaps(8))
    ctl = CapacityController(
        act, CapacityConfig(confirm=1, max_batch=16, min_queue=16,
                            queue_md=0.5),
        metrics=met, clock=lambda: 0.0)
    ctl.tick(0.0)
    limits = []
    for i in range(1, 5):
        ctl.tick(i * 0.1)
        limits.append(act.admission_limit)
    assert limits == [64, 32, 16, 16]               # halves, floors at min
    assert met.logged[-1]["action"] == "queue_decrease"


def test_controller_error_is_recorded_not_raised():
    class ExplodingMetrics:
        def snapshot(self, now):
            raise RuntimeError("metrics gone")

        def on_capacity(self, entry):
            pass

    ctl = CapacityController(FakeActuator(), CapacityConfig(window_s=0.01),
                             metrics=ExplodingMetrics(),
                             clock=time.perf_counter)
    ctl.start()
    for _ in range(200):
        if ctl.error is not None:
            break
        time.sleep(0.005)
    ctl.stop()
    assert isinstance(ctl.error, RuntimeError)


def test_mean_active_replicas_is_time_weighted():
    act = FakeActuator(n_active=4)
    ctl = CapacityController(act, CapacityConfig(), clock=lambda: 0.0)
    ctl._active_log = [(0.0, 4), (1.0, 2)]
    # 4 replicas for 1s, then 2 replicas for 3s -> (4 + 6) / 4
    assert ctl.mean_active_replicas(4.0) == pytest.approx(2.5)


# -- disabled by default: bit-identity ----------------------------------------

def test_capacity_none_is_bit_identical_and_unwired():
    reqs = sim_requests(24, max_new_tokens=4, content_seed=7)
    plain = build(ServeConfig(server_factory=lambda i: SimServer()))
    baseline = {c.rid: c for c in plain.serve(reqs, mode="sync")}

    srv = build(ServeConfig(replicas=2, capacity=None,
                            server_factory=lambda i: SimServer()))
    out = {c.rid: c for c in srv.serve(reqs, mode="pipelined")}
    assert set(out) == set(baseline)
    for rid, c in baseline.items():
        np.testing.assert_array_equal(out[rid].tokens, c.tokens)
        assert out[rid].truncated == c.truncated
    rep = srv.report()
    assert rep.capacity == {}                   # nothing wired, nothing logged
    assert rep.as_dict()["capacity"] == {}

    sched = AsyncScheduler(SimServer(), SchedulerConfig())
    assert sched._controller is None            # default config: no thread
    sched.result()


# -- end-to-end: SimServer convergence ----------------------------------------

def _flood(sched, *, seconds, qps):
    """Open-loop unique-content flood; returns the number offered."""
    gap = 1.0 / qps
    t_end = time.monotonic() + seconds
    i = 0
    while time.monotonic() < t_end:
        sched.submit(_req(i, [2 + i % 97, 3 + (i // 97) % 50, 5]))
        i += 1
        time.sleep(gap)
    return i


def test_controller_converges_on_a_host_bound_box():
    # weak_host profile: serial host prepare saturates long before the
    # devices do (the paper's weak-CPU / strong-FPGA box). The controller
    # must diagnose host_bound and grow the batch target to amortise it.
    sched = AsyncScheduler(
        SimServer.from_profile("weak_host"),
        SchedulerConfig(target_batch=4, deadline=0.005, max_queue=32,
                        policy="shed_oldest", replicas=2,
                        capacity=CapacityConfig(window_s=0.05, confirm=2,
                                                min_batch=4, max_batch=32,
                                                min_queue=8)))
    _flood(sched, seconds=0.9, qps=2000)
    sched.result()
    rep = sched.report()
    assert rep.capacity["diagnosis"] == "host_bound" \
        or any(d == "host_bound" for _, d in rep.capacity["history"])
    assert rep.capacity["final"]["target_batch"] > 4
    assert rep.capacity["n_actions"] > 0
    assert rep.capacity["error"] is None


def test_controller_activates_replicas_on_a_device_bound_box():
    # weak_device profile starting from one active replica: the device
    # saturates, the controller must diagnose device_bound and bring the
    # parked replicas back within the budget.
    sched = AsyncScheduler(
        SimServer.from_profile("weak_device"),
        SchedulerConfig(target_batch=8, deadline=0.005, max_queue=64,
                        policy="shed_oldest", replicas=3,
                        capacity=CapacityConfig(window_s=0.05, confirm=2,
                                                initial_replicas=1,
                                                min_batch=4, max_batch=32)))
    sched.start()
    assert sched.capacity_state()["n_active"] == 1      # parked at start
    _flood(sched, seconds=0.9, qps=1500)
    sched.result()
    rep = sched.report()
    assert rep.capacity["diagnosis"] == "device_bound" \
        or any(d == "device_bound" for _, d in rep.capacity["history"])
    assert rep.capacity["final"]["n_active"] > 1        # replicas activated
    assert 1.0 <= rep.capacity["mean_active_replicas"] <= 3.0
    assert rep.capacity["error"] is None


def test_scheduler_actuator_protocol_round_trips():
    sched = AsyncScheduler(SimServer(), SchedulerConfig(
        target_batch=8, max_queue=64, replicas=2))
    st = sched.capacity_state()
    assert st["target_batch"] == 8 and st["admission_limit"] == 64
    assert st["n_active"] == 2 and st["n_replicas"] == 2
    sched.set_target_batch(16)
    sched.set_admission_limit(32)
    sched.set_active_replicas(1)
    st = sched.capacity_state()
    assert st["target_batch"] == 16 and st["admission_limit"] == 32
    assert st["n_active"] == 1
    sched.result()


# -- cost report --------------------------------------------------------------

def test_cost_report_prices_through_the_paper_constants():
    rep = CostReport()
    row = rep.add("weak/static", host="weak_host", replicas=4,
                  achieved_qps=1000.0)
    expect_usd_h = aws_host_usd_per_hour(8) + 4 * aws_accel_usd_per_hour()
    assert row.usd_per_hour == pytest.approx(expect_usd_h)
    assert row.usd_per_1k == pytest.approx(
        usd_per_1k_queries(expect_usd_h, 1000.0))
    # same throughput on fewer active replicas is strictly cheaper
    cheaper = rep.add("weak/controlled", host="weak_host", replicas=1.5,
                      achieved_qps=1000.0)
    assert cheaper.usd_per_1k < row.usd_per_1k
    assert rep.best() is cheaper
    d = rep.as_dict()
    assert d["best"]["config"] == "weak/controlled"
    assert d["rows"][0]["usd_per_1k_queries"] == pytest.approx(
        row.usd_per_1k)
    # markdown table sorts cheapest first
    lines = rep.table().splitlines()
    assert "weak/controlled" in lines[2]


def test_paper_boxes_weak_host_is_cheaper_per_hour():
    weak, bal = PAPER_BOXES["weak_host"], PAPER_BOXES["balanced"]
    assert weak.usd_per_hour(2) < bal.usd_per_hour(2)
    assert weak.usd_per_hour(0) == pytest.approx(aws_host_usd_per_hour(8))


def test_zero_qps_prices_to_infinity():
    assert usd_per_1k_queries(1.0, 0.0) == float("inf")


# -- parity with the JAX package ------------------------------------------------

def _random_snaps(seed, n=40, dt=0.1):
    """A seeded cumulative SignalSnapshot stream that wanders between
    host-bound, device-bound, admission-bound and quiet windows, as plain
    field dicts."""
    rng = np.random.default_rng(seed)
    tot = dict(n_arrivals=0, n_completions=0, n_rejected=0, n_shed=0,
               n_encoded_batches=0, encode_busy_s=0.0, device_busy_s=0.0,
               cache_hits=0, cache_misses=0, cache_coalesced=0)
    out = []
    for i in range(n):
        phase = (i // 6) % 4
        arr = int(rng.integers(20, 200))
        tot["n_arrivals"] += arr
        tot["n_completions"] += int(arr * rng.uniform(0.4, 1.0))
        tot["n_rejected"] += int(rng.integers(0, 20)) if phase == 2 else 0
        tot["n_shed"] += int(rng.integers(0, 3))
        tot["n_encoded_batches"] += int(rng.integers(1, 20))
        tot["encode_busy_s"] += dt * (rng.uniform(0.85, 1.0) if phase == 0
                                      else rng.uniform(0.05, 0.4))
        tot["device_busy_s"] += dt * (rng.uniform(1.6, 2.0) if phase == 1
                                      else rng.uniform(0.0, 0.8))
        tot["cache_hits"] += int(rng.integers(0, 10))
        tot["cache_misses"] += int(rng.integers(1, 10))
        tot["cache_coalesced"] += int(rng.integers(0, 4))
        out.append(dict(t=i * dt, **tot))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("confirm", [1, 2, 3])
def test_monitor_classifications_equal_reference(seed, confirm):
    import repro_torch.capacity as P
    raw = _random_snaps(seed)
    rng = np.random.default_rng(100 + seed)
    live = [dict(queue_depth=int(rng.integers(0, 64)), admission_limit=64,
                 n_active_replicas=2) for _ in raw]

    def run(pkg):
        mon = pkg.BottleneckMonitor(confirm=confirm)
        snaps = [pkg.SignalSnapshot(**r) for r in raw]
        got = []
        for prev, cur, kw in zip(snaps, snaps[1:], live):
            sig = pkg.CapacitySignals.between(prev, cur, **kw)
            got.append((str(mon.classify(sig)), str(mon.observe(sig))))
        return got, [(t, str(d)) for t, d in mon.history]
    got, want = run(P), run(JC)
    assert got == want
    assert len({c for c, _ in got[0]}) >= 3     # the stream visits classes


def test_controller_actions_equal_reference():
    """The same scripted stream through each package's controller against
    its own fake actuator: equal diagnoses, actions and final knobs."""
    import repro_torch.capacity as P
    raw = _random_snaps(7, n=30)

    def run(pkg):
        act = FakeActuator(target_batch=4, n_active=2, n_replicas=4)
        met = ScriptedMetrics([pkg.SignalSnapshot(**r) for r in raw])
        ctl = pkg.CapacityController(
            act, pkg.CapacityConfig(confirm=2, min_batch=2, max_batch=32,
                                    max_replicas=4),
            metrics=met, clock=lambda: 0.0)
        diags = [str(ctl.tick(r["t"])) for r in raw]
        return diags, met.logged, (act.target_batch, act.admission_limit,
                                   act.n_active)
    got, want = run(P), run(JC)
    assert got == want
    assert got[1]                                # the controller acted


def test_cost_report_equals_reference():
    import repro_torch.capacity as P

    def run(pkg):
        rep = pkg.CostReport()
        for host, reps, qps in (("weak_host", 4, 1000.0),
                                ("weak_host", 1.5, 1000.0),
                                ("balanced", 2, 2663.7),
                                ("balanced", 8, 17221.0),
                                ("weak_host", 3, 0.0)):
            rep.add(f"{host}/{reps}", host=host, replicas=reps,
                    achieved_qps=qps)
        return rep.as_dict(), rep.table(), {
            k: (vars(b), b.usd_per_hour(2)) for k, b in
            pkg.PAPER_BOXES.items()}
    assert run(P) == run(JC)
