"""Port of the serving stack, replica routing, the simulated engine and
fault tolerance: the cases of ``tests/test_replica_routing.py`` and the
training-free cases of ``tests/test_ft.py`` run against ``repro_torch``,
plus parity with the JAX package on the same seeds: ``SimServer`` tokens
(crc32 of the content), ``sim_requests`` streams and STICKY placements
equal the reference's exactly.

Left out until the port of ``sharding/specs.py`` (ROADMAP queue 1, item
11): ``test_replica_device_groups_partition_mesh`` and
``test_mesh_replicas_bit_identical_on_two_devices``; the training restart
case of ``test_ft.py`` waits for the port of the training loop (item 10).
"""
import numpy as np
import pytest

import repro.ft.failures as j_ft
import repro.serve as J
from repro_torch.ft.failures import (DelayInjector, FailureInjector,
                                     HeartbeatMonitor, StragglerPolicy,
                                     plan_elastic_mesh)
from repro_torch.serve import (SIM_PROFILES, AsyncScheduler, EngineGroup,
                               MetricsCollector, OpenLoopGen, RoutingPolicy,
                               SchedulerConfig, ServeConfig, SimServer,
                               SyntheticWorkload, batch_work, build,
                               sim_requests)


# ---------------------------------------------------------------------------
# bit-identity: N replicas, sticky routing vs single-replica sync baseline
# ---------------------------------------------------------------------------

def test_sticky_n_replica_bit_identical_to_sync_baseline():
    """3 sticky-routed replicas must produce completions bit-identical to
    the single-replica synchronous baseline for the same stream (the
    Server.serve bit-identity guarantee)."""
    srv = build(ServeConfig(model="llama3.2-3b", device="cpu", max_seq=48, replicas=3,
                            routing="sticky", target_batch=4,
                            deadline=0.01))
    workload = SyntheticWorkload(vocab=srv.engine.cfg.vocab, prompt_len=6,
                                 max_new_tokens=3, seed=1)
    reqs = OpenLoopGen(workload, qps=200.0, n=12, seed=7).requests()
    sync = srv.serve(reqs, mode="sync")
    sharded = srv.serve(reqs, mode="pipelined")
    assert len(sync) == len(sharded) == 12
    by_sync = {c.rid: c for c in sync}
    for c in sharded:
        ref = by_sync[c.rid]
        np.testing.assert_array_equal(ref.tokens, c.tokens)
        assert ref.batch_size == c.batch_size
        assert ref.truncated == c.truncated
    # sticky placement is content-addressed: every routing decision says so
    rep = srv.report()
    assert rep.routing.get("sticky", 0) > 0
    assert set(rep.routing) <= {"sticky", "single"}


def test_sticky_routing_is_timing_independent():
    """Sticky assignment depends only on batch content (min rid mod R):
    two identical dispatch sequences land on identical replicas."""
    def placements():
        group = EngineGroup.from_servers(
            [SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.5)
             for _ in range(3)], routing="sticky")
        run = group.open().start()
        seen = []
        for i in range(9):
            pb = group.prepare_batch(sim_requests(2, rid_base=i * 10))
            seen.append(run.dispatch(pb))
        run.finish()
        return seen

    a, b = placements(), placements()
    assert a == b
    assert a == [(i * 10) % 3 for i in range(9)]


# ---------------------------------------------------------------------------
# least-outstanding-work routing under skewed decode lengths
# ---------------------------------------------------------------------------

def test_least_loaded_balances_skewed_decode_lengths():
    """Alternating heavy (long decode) and light batches: work-aware
    routing must not pile the heavy ones onto one replica — per-replica
    busy time stays balanced even though per-batch cost is 16x skewed."""
    group = EngineGroup.from_servers(
        [SimServer(host_ms_per_batch=0.0, device_ms_per_token=1.0)
         for _ in range(2)], routing="least_loaded")
    from repro_torch.serve import MetricsCollector
    metrics = MetricsCollector()
    run = group.open(metrics=metrics).start()
    # heavy batch = 16 decode steps (~16 ms), light = 1 (~1 ms)
    reqs = sim_requests(24, skew=(16, 1))
    for r in reqs:
        run.dispatch(group.prepare_batch([r]))
    run.finish()
    rep = metrics.report()
    assert set(rep.per_replica) == {0, 1}
    busy = [rep.per_replica[i].busy_s for i in (0, 1)]
    assert min(busy) > 0
    assert max(busy) / min(busy) < 2.0      # work-balanced, not count-based
    assert rep.routing.get("least_loaded", 0) > 0


def test_batch_work_counts_prefill_plus_padded_decode():
    rs = sim_requests(2, prompt_len=8, skew=(16, 2))
    # decode loop runs to the batch max for every row: 2*(8+16)
    assert batch_work(rs) == 2 * (8 + 16)
    assert batch_work([]) == 0


def test_tie_break_round_robin_cycles_replicas():
    """With zero outstanding work everywhere, ties cycle round-robin so
    cold replicas warm evenly."""
    group = EngineGroup.from_servers(
        [SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.0)
         for _ in range(3)])
    run = group.open()
    picks = [run._route(type("PB", (), {"requests": sim_requests(1)})())
             for _ in range(6)]
    assert [i for i, _, _ in picks] == [0, 1, 2, 0, 1, 2]
    assert all(reason == "tie_break" for _, reason, _ in picks)
    assert all(owner is None for _, _, owner in picks)


# ---------------------------------------------------------------------------
# straggler isolation: one slow replica must not stall shared admission
# ---------------------------------------------------------------------------

def test_slow_replica_does_not_stall_admission_queue():
    """Replica 0 is made a straggler via repro.ft.failures.DelayInjector.
    Least-outstanding-work routing must route around it: the full stream
    completes, and the healthy replica serves more batches."""
    group = EngineGroup.from_servers(
        [SimServer(host_ms_per_batch=0.0, device_ms_per_batch=1.0)
         for _ in range(2)],
        routing="least_loaded",
        delay=DelayInjector({0: 0.05}))     # +50 ms per batch on replica 0
    sched = AsyncScheduler(group, target_batch=2, deadline=0.001,
                           max_queue=8, policy="block")
    for r in sim_requests(32, max_new_tokens=2):
        sched.submit(r)                     # block policy: would wedge if
                                            # the straggler stalled the path
    outs = sched.result()
    assert len(outs) == 32
    rep = sched.report()
    assert rep.max_queue_depth <= 8
    healthy = rep.per_replica[1].n_batches
    straggler = rep.per_replica[0].n_batches
    assert healthy > straggler
    assert healthy + straggler == len(rep.batch_sizes)


# ---------------------------------------------------------------------------
# per-replica metrics + config plumbing
# ---------------------------------------------------------------------------

def test_per_replica_metrics_and_routing_counters():
    srv = build(ServeConfig(
        replicas=2, target_batch=4, deadline=1.0,
        server_factory=lambda i: SimServer(host_ms_per_batch=0.5,
                                           device_ms_per_batch=2.0)))
    outs = srv.serve(sim_requests(32), mode="pipelined")
    assert len(outs) == 32
    rep = srv.report()
    d = rep.as_dict()
    assert set(d["per_replica"]) == {0, 1}
    n_routed = sum(rep.routing.values())
    n_batches = sum(rep.per_replica[i].n_batches for i in (0, 1))
    assert n_routed == n_batches == len(rep.batch_sizes)
    for stats in rep.per_replica.values():
        assert 0.0 <= stats.idle_fraction <= 1.0
        assert stats.max_pipeline_depth >= 0
        assert stats.max_outstanding_work > 0


def test_scheduler_config_replicas_and_routing_expand_group():
    srv_cfg = SchedulerConfig(replicas=3, routing="sticky")
    assert srv_cfg.routing is RoutingPolicy.STICKY
    sched = AsyncScheduler(
        SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.0), srv_cfg)
    assert len(sched.group.replicas) == 3
    for r in sim_requests(6):
        sched.submit(r)
    assert len(sched.result()) == 6


def test_routing_policy_validation_lists_values():
    with pytest.raises(ValueError, match="least_loaded"):
        SchedulerConfig(routing="fastest_first")
    with pytest.raises(ValueError, match="least_loaded"):
        EngineGroup.from_servers([SimServer()], routing="bogus")


def test_replica_error_propagates_from_result():
    """A dead replica must surface its error out of result(), not wedge
    the dispatcher on the dead replica's full handoff queue."""
    class ExplodingServer(SimServer):
        def execute_prepared(self, pb, *, device=None):
            raise RuntimeError("boom")

    group = EngineGroup.from_servers([ExplodingServer(), ExplodingServer()])
    sched = AsyncScheduler(group, target_batch=1, deadline=0.001,
                           max_queue=16)
    for r in sim_requests(6):
        sched.submit(r)
    with pytest.raises(RuntimeError):
        sched.result()


# ---------------------------------------------------------------------------
# hit-aware routing: cache-ownership affinity with a straggler guard
# ---------------------------------------------------------------------------

def _fast_servers(n, **kw):
    kw.setdefault("host_ms_per_batch", 0.0)
    kw.setdefault("device_ms_per_batch", 0.0)
    return [SimServer(**kw) for _ in range(n)]


def _owned_cache(reqs, replica, *, ttl=1.0, expire_at=10.0):
    """A cache whose every key is an expired tombstone owned by
    ``replica`` — the state hit_aware routing sees when content must be
    recomputed."""
    from repro_torch.serve import CacheConfig, CachedResult, ResultCache, \
        request_key
    cache = ResultCache(CacheConfig(ttl=ttl))
    ref = SimServer()
    for r in reqs:
        cache.put(request_key(r),
                  CachedResult.of(ref.generate_batch([r])[0],
                                  replica=replica, now=0.0))
        assert cache.get(request_key(r), expire_at) is None
    return cache


def test_hit_aware_without_cache_decision_identical_to_least_loaded():
    """No cache (or an empty one): hit_aware must make exactly the
    decisions least_loaded would, including round-robin tie-break state."""
    from repro_torch.serve import CacheConfig, ResultCache
    ga = EngineGroup.from_servers(_fast_servers(3), routing="hit_aware")
    gb = EngineGroup.from_servers(_fast_servers(3), routing="least_loaded")
    runs = [ga.open(), ga.open(cache=ResultCache(CacheConfig())),
            gb.open()]
    pb = type("PB", (), {"requests": sim_requests(2)})()
    for loads in ([0, 0, 0], [5, 1, 3], [2, 2, 9], [7, 7, 7], [0, 4, 0]):
        picks = []
        for run in runs:
            run._outstanding = list(loads)
            picks.append(run._route(pb))
        assert picks[0] == picks[1] == picks[2]
        assert picks[0][1] in ("least_loaded", "tie_break")
        assert picks[0][2] is None


def test_hit_aware_prefers_owning_replica_for_expired_content():
    """Tombstone affinity: the recompute of TTL-expired content routes to
    the replica that produced the original result."""
    reqs = sim_requests(2, rid_base=0, content_seed=3)
    cache = _owned_cache(reqs, replica=2)
    group = EngineGroup.from_servers(_fast_servers(3), routing="hit_aware")
    run = group.open(cache=cache)
    fresh = sim_requests(2, rid_base=100, content_seed=3)  # same content
    pb = type("PB", (), {"requests": fresh})()
    assert run._route(pb) == (2, "affinity_hit", 2)


def test_hit_aware_spills_on_straggler_ewma_and_rehomes():
    """An owner whose latency EWMA marks it a straggler loses its
    affinity: the batch spills to the least-loaded healthy replica and
    the keys are re-homed there, so the next recompute follows the work."""
    from repro_torch.serve import request_key
    reqs = sim_requests(2, rid_base=0, content_seed=5)
    cache = _owned_cache(reqs, replica=0)
    group = EngineGroup.from_servers(_fast_servers(3), routing="hit_aware",
                                     straggler_factor=2.0)
    run = group.open(cache=cache)
    run._ewma = [0.02, 0.001, 0.001]        # replica 0 is 20x the others
    fresh = sim_requests(2, rid_base=100, content_seed=5)
    pb = type("PB", (), {"requests": fresh})()
    idx, reason, owner = run._route(pb)
    assert reason == "affinity_spill" and owner == 0 and idx != 0
    assert cache.owner_hint(request_key(fresh[0])) == idx
    assert cache.stats()["affinity_rehomes"] == len(fresh)
    # re-homed: the same content now affinity-hits its new replica
    assert run._route(pb) == (idx, "affinity_hit", idx)


def test_hit_aware_spills_on_outstanding_gap():
    """A healthy owner still spills when its outstanding-work gap over
    the least-loaded candidate exceeds spill_threshold (and holds the
    batch when it doesn't)."""
    reqs = sim_requests(2, rid_base=0, content_seed=9)
    fresh = sim_requests(2, rid_base=100, content_seed=9)
    pb = type("PB", (), {"requests": fresh})()
    tight = EngineGroup.from_servers(_fast_servers(3), routing="hit_aware",
                                     spill_threshold=5)
    run = tight.open(cache=_owned_cache(reqs, replica=0))
    run._outstanding = [10, 0, 0]
    idx, reason, owner = run._route(pb)
    assert reason == "affinity_spill" and owner == 0 and idx in (1, 2)
    loose = EngineGroup.from_servers(_fast_servers(3), routing="hit_aware",
                                     spill_threshold=96)
    run2 = loose.open(cache=_owned_cache(reqs, replica=0))
    run2._outstanding = [10, 0, 0]
    assert run2._route(pb) == (0, "affinity_hit", 0)


def test_delay_injector_straggler_shows_in_ewma():
    """The per-replica EWMA fed by worker batch timings must mark a
    DelayInjector-delayed replica as the straggler."""
    group = EngineGroup.from_servers(
        _fast_servers(2, device_ms_per_batch=1.0), routing="hit_aware",
        delay=DelayInjector({0: 0.05}))     # +50 ms per batch on replica 0
    run = group.open().start()
    for i in range(4):
        run.dispatch(group.prepare_batch(sim_requests(2, rid_base=i * 10)))
    run.finish()
    e = run.replica_ewma()
    assert e[0] is not None and e[1] is not None
    assert e[0] > group.straggler_factor * e[1]
    with run._lock:
        assert run._is_straggler_locked(0, 2)
        assert not run._is_straggler_locked(1, 2)


def test_ewma_persists_across_runs_on_the_group():
    """The straggler EWMA lives on the EngineGroup: a slow replica
    identified in one run still repels hit_aware traffic in the next run
    (runs are often shorter than the straggler's first batch)."""
    group = EngineGroup.from_servers(
        _fast_servers(2, device_ms_per_batch=1.0), routing="hit_aware",
        delay=DelayInjector({0: 0.05}))
    run = group.open().start()
    for i in range(4):
        run.dispatch(group.prepare_batch(sim_requests(2, rid_base=i * 10)))
    run.finish()
    run2 = group.open().start()
    e = run2.replica_ewma()             # before run2 executes anything
    assert e[0] is not None and e[0] > group.straggler_factor * e[1]
    with run2._lock:
        assert run2._is_straggler_locked(0, 2)
    run2.finish()


def test_hit_aware_end_to_end_spill_under_delay_injector():
    """Every key starts owned by a DelayInjector-straggled replica 0:
    hit_aware must spill most recomputes to the healthy replica, re-home
    the keys, and still complete the full stream."""
    import numpy as np
    from repro_torch.serve import CachedResult, request_key
    # enough batches that the post-EWMA regime (replica 0 confirmed as a
    # straggler after its first ~51 ms batch) dominates the early
    # gap-guard alternation
    n = 32
    cache_cfg = {"ttl": 5.0}
    srv = build(ServeConfig(
        server_factory=lambda i: SimServer(host_ms_per_batch=0.0,
                                           device_ms_per_batch=1.0),
        replicas=2, routing="hit_aware", spill_threshold=8,
        target_batch=2, deadline=0.01, cache=cache_cfg,
        delay=DelayInjector({0: 0.05})))
    seed_reqs = sim_requests(n, rid_base=0, content_seed=13,
                             arrivals=np.arange(n) * 1e-3)
    ref = SimServer()
    for r in seed_reqs:
        srv.cache.put(request_key(r),
                      CachedResult.of(ref.generate_batch([r])[0],
                                      replica=0, now=0.0))
    # logical arrivals 20s later: every entry is stale (ttl 5), leaving
    # replica-0 tombstones, so all n leaders recompute with affinity
    wave = sim_requests(n, rid_base=100, content_seed=13,
                        arrivals=20.0 + np.arange(n) * 1e-3)
    outs = srv.serve(wave, mode="pipelined")
    assert len(outs) == n
    rep = srv.report()
    assert rep.affinity_hits + rep.affinity_spills \
        == len(rep.batch_sizes)                 # every batch had an owner
    assert rep.affinity_spills > 0              # the straggler lost work
    assert srv.cache.stats()["affinity_rehomes"] > 0
    assert rep.per_replica[1].n_batches > rep.per_replica[0].n_batches


def test_hit_aware_knob_validation():
    with pytest.raises(ValueError, match="spill_threshold"):
        EngineGroup.from_servers([SimServer()], spill_threshold=-1)
    with pytest.raises(ValueError, match="straggler_factor"):
        EngineGroup.from_servers([SimServer()], straggler_factor=0.5)
    with pytest.raises(ValueError, match="ewma_alpha"):
        SchedulerConfig(ewma_alpha=0.0)
    with pytest.raises(ValueError, match="spill_threshold"):
        SchedulerConfig(spill_threshold=-2)


@pytest.mark.parametrize("routing", ["least_loaded", "sticky", "hit_aware"])
def test_every_policy_bit_identical_to_sync_with_warm_recomputes(routing):
    """All three routing policies only move *placement*: two waves of the
    same content (the second recomputed after TTL expiry, at warm-content
    device costs) stay bit-identical per rid to the single-replica sync
    baseline. Warmth changes time, never bits."""
    def factory(i):
        return SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.5,
                         device_ms_per_token=0.05, warm_factor=0.25)

    def wave(rid_base, t0):
        n = 12
        return sim_requests(n, rid_base=rid_base, content_seed=11,
                            arrivals=t0 + np.arange(n) * 1e-3)

    srv = build(ServeConfig(server_factory=factory, replicas=3,
                            routing=routing, target_batch=4, deadline=0.01,
                            cache={"ttl": 5.0}))
    w1 = srv.serve(wave(0, 0.0), mode="pipelined")
    # 20s of logical time later: every wave-1 entry is stale, so wave 2
    # recomputes through the router (hit_aware sees tombstone owners)
    w2 = srv.serve(wave(100, 20.0), mode="pipelined")
    ref_srv = build(ServeConfig(server_factory=factory, replicas=1,
                                target_batch=4, deadline=0.01))
    ref = {c.rid: c for c in ref_srv.serve(wave(0, 0.0), mode="sync")}
    assert len(w1) == len(w2) == len(ref) == 12
    for c in w1:
        np.testing.assert_array_equal(ref[c.rid].tokens, c.tokens)
        assert ref[c.rid].truncated == c.truncated
    for c in w2:
        np.testing.assert_array_equal(ref[c.rid - 100].tokens, c.tokens)
        assert ref[c.rid - 100].truncated == c.truncated
    if routing == "hit_aware":
        rep = srv.report()
        assert rep.affinity_hits + rep.affinity_spills > 0


# ---------------------------------------------------------------------------
# fault tolerance (the cases of test_ft.py that need no training loop)
# ---------------------------------------------------------------------------


def test_heartbeat_detection():
    hb = HeartbeatMonitor(timeout=5.0)
    hb.beat("h0", now=0.0)
    hb.beat("h1", now=0.0)
    hb.beat("h0", now=4.0)
    assert hb.failed(now=6.0) == ["h1"]
    assert hb.alive(now=6.0) == ["h0"]


def test_elastic_plan_preserves_model_parallelism():
    # 256 chips (16x16), lose 16 -> 240 survivors -> data=15
    p = plan_elastic_mesh(240, model_parallel=16, global_batch=256,
                          orig_data=16)
    assert p.model == 16 and p.data == 15
    assert p.n_devices == 240
    assert p.global_batch == 240  # 16 per replica x 15
    # atomic TP groups: 250 survivors still yield data=15
    p2 = plan_elastic_mesh(250, model_parallel=16, global_batch=256,
                           orig_data=16)
    assert p2.data == 15 and p2.dropped_devices == 10


def test_elastic_plan_raises_below_minimum():
    with pytest.raises(ValueError):
        plan_elastic_mesh(8, model_parallel=16, global_batch=64)


def test_straggler_policy_drops_and_rescales():
    sp = StragglerPolicy(tolerance=2.0)
    sp.observe(1.0)
    kept, scale = sp.commit([1.0, 1.1, 5.0, 0.9])
    assert 2 not in kept and len(kept) == 3
    assert scale == pytest.approx(4 / 3)


def test_straggler_all_late_keeps_fastest():
    sp = StragglerPolicy(tolerance=1.5)
    sp.observe(1.0)
    kept, scale = sp.commit([9.0, 5.0, 7.0])
    assert kept == [1]
    assert scale == 3.0



def test_delay_injector_applies_per_target():
    slept = []
    inj = DelayInjector({0: 0.05, "h1": 0.5})
    assert inj.apply(0, sleep=slept.append) == 0.05
    assert inj.apply(1, sleep=slept.append) == 0.0
    assert inj.delay_for("h1") == 0.5
    assert slept == [0.05]
    assert FailureInjector({3: "h2"}).check(3) == "h2"


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

SIM_CASES = [dict(n=12), dict(n=9, prompt_len=5, skew=(16, 1)),
             dict(n=16, unique_keys=3, content_seed=7, max_new_tokens=4),
             dict(n=8, rid_base=100, content_seed=13,
                  arrivals=20.0 + np.arange(8) * 1e-3)]


@pytest.mark.parametrize("case", range(len(SIM_CASES)))
def test_sim_requests_and_tokens_equal_reference(case):
    kw = SIM_CASES[case]
    j_reqs, reqs = J.sim_requests(**kw), sim_requests(**kw)
    assert len(reqs) == len(j_reqs)
    for a, b in zip(j_reqs, reqs):
        assert (a.rid, a.max_new_tokens, a.arrival) == \
            (b.rid, b.max_new_tokens, b.arrival)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    j_srv, srv = J.SimServer(), SimServer()
    for i in range(0, len(reqs), 4):
        j_out = j_srv.generate_batch(j_reqs[i:i + 4])
        out = srv.generate_batch(reqs[i:i + 4])
        assert [c.rid for c in out] == [c.rid for c in j_out]
        for a, b in zip(j_out, out):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert (a.batch_size, a.truncated) == (b.batch_size, b.truncated)


def test_sim_profiles_equal_reference():
    assert set(SIM_PROFILES) == set(J.SIM_PROFILES)
    for name, p in SIM_PROFILES.items():
        assert vars(p) == vars(J.SIM_PROFILES[name])


def _sticky_placements(pkg):
    group = pkg.EngineGroup.from_servers(
        [pkg.SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.2)
         for _ in range(3)], routing="sticky")
    run = group.open().start()
    seen = []
    for rs in pkg.form_batch_groups(pkg.sim_requests(
            30, arrivals=np.arange(30) * 3e-3), target_batch=4,
            deadline=0.01):
        seen.append(run.dispatch(group.prepare_batch(rs)))
    run.finish()
    return seen


def test_sticky_placements_equal_reference():
    import repro_torch.serve as P
    assert _sticky_placements(P) == _sticky_placements(J)


def test_sticky_serve_replica_of_each_request_equals_reference():
    def run(pkg):
        srv = pkg.build(pkg.ServeConfig(
            server_factory=lambda i: pkg.SimServer(host_ms_per_batch=0.0,
                                                   device_ms_per_batch=0.2),
            replicas=3, routing="sticky", target_batch=4, deadline=0.01))
        outs = srv.serve(pkg.sim_requests(
            24, arrivals=np.arange(24) * 2e-3), mode="pipelined")
        rep = srv.report()
        return ({c.rid: srv.metrics.replica_of(c.rid) for c in outs},
                rep.routing, {k: v.n_batches
                              for k, v in rep.per_replica.items()})
    import repro_torch.serve as P
    assert run(P) == run(J)


def test_route_decisions_equal_reference_on_fixed_loads():
    """least_loaded and hit_aware (cache off) decisions, tie-break state
    included, on the same sequence of outstanding-work vectors."""
    import repro_torch.serve as P
    loads_seq = ([0, 0, 0], [5, 1, 3], [2, 2, 9], [7, 7, 7], [0, 4, 0],
                 [1, 1, 1], [3, 0, 3])

    def picks(pkg, routing):
        g = pkg.EngineGroup.from_servers(
            [pkg.SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.0)
             for _ in range(3)], routing=routing)
        run = g.open()
        pb = type("PB", (), {"requests": pkg.sim_requests(2)})()
        out = []
        for loads in loads_seq:
            run._outstanding = list(loads)
            out.append(run._route(pb))
        return out
    for routing in ("least_loaded", "hit_aware"):
        assert picks(P, routing) == picks(J, routing)


def test_ft_policies_equal_reference():
    sp, j_sp = StragglerPolicy(tolerance=2.0), j_ft.StragglerPolicy(
        tolerance=2.0)
    for lat in ([1.0, 1.1, 5.0, 0.9], [9.0, 5.0, 7.0], [0.5, 0.6]):
        assert sp.commit(lat) == j_sp.commit(lat)
    for args in ((240, 16, 256, 1, 16), (250, 16, 256, 1, 16),
                 (64, 8, 512, 1, None)):
        assert vars(plan_elastic_mesh(*args)) == \
            vars(j_ft.plan_elastic_mesh(*args))
