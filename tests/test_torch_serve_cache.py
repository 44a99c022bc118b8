"""Port of the serving stack, result cache and coalescing: the cases of
``tests/test_serve_cache.py`` run against ``repro_torch.serve`` (the real
engine on the CPU, ``device="cpu"``), plus parity with the JAX package:
``request_key`` digests, and the cache, coalesce and negative-cache
counters of sync-mode replays with TTL expiry and LRU eviction, equal the
reference's exactly on the same streams.
"""
import threading

import numpy as np
import pytest

import repro.serve as J
from repro_torch.serve import (AsyncScheduler, CacheConfig, CachedResult,
                               Coalescer, NegativeResult, Request,
                               ResultCache, SchedulerConfig, ServeConfig,
                               SimServer, build, request_key, sim_requests)


def _req(rid, tokens, *, max_new=4, arrival=0.0):
    return Request(rid=rid, tokens=np.asarray(tokens, np.int32),
                   max_new_tokens=max_new, arrival=arrival)


def _sim_server_cfg(replicas=1, *, cache=True, sim_kw=None, **kw):
    sim_kw = dict(sim_kw or {})
    return ServeConfig(replicas=replicas,
                       cache=CacheConfig() if cache is True else cache,
                       server_factory=lambda i: SimServer(**sim_kw), **kw)


# -- content addressing -------------------------------------------------------

def test_request_key_ignores_rid_and_arrival():
    a = _req(1, [3, 5, 7], arrival=0.0)
    b = _req(999, [3, 5, 7], arrival=42.0)
    assert request_key(a) == request_key(b)


def test_request_key_depends_on_content():
    base = _req(1, [3, 5, 7], max_new=4)
    assert request_key(base) != request_key(_req(1, [3, 5, 8], max_new=4))
    assert request_key(base) != request_key(_req(1, [3, 5, 7], max_new=5))
    assert request_key(base) != request_key(_req(1, [3, 5], max_new=4))


def test_sim_tokens_are_content_derived():
    # the bit-identity anchor for cache substitution: same content, any
    # rid, same simulated output
    srv = SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.0)
    a, = srv.generate_batch([_req(1, [3, 5, 7])])
    b, = srv.generate_batch([_req(888, [3, 5, 7])])
    c, = srv.generate_batch([_req(1, [3, 5, 9])])
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, c.tokens)


# -- ResultCache unit behavior ------------------------------------------------

def test_ttl_expiry_is_judged_on_callers_clock():
    cache = ResultCache(CacheConfig(ttl=10.0))
    key = "k"
    comp = SimServer(host_ms_per_batch=0, device_ms_per_batch=0) \
        .generate_batch([_req(1, [2, 4])])[0]
    cache.put(key, CachedResult.of(comp, now=0.0))
    assert cache.get(key, 9.9) is not None          # fresh
    cache.put(key, CachedResult.of(comp, now=0.0))  # reset stored_at
    assert cache.get(key, 10.1) is None             # stale, evicted
    assert key not in cache
    s = cache.stats()
    assert s["stale"] == 1 and s["entries"] == 0 and s["bytes_resident"] == 0


def test_lru_eviction_is_deterministic():
    comp = SimServer(host_ms_per_batch=0, device_ms_per_batch=0) \
        .generate_batch([_req(1, [2, 4], max_new=4)])[0]
    entry = lambda: CachedResult.of(comp, now=0.0)  # noqa: E731
    # room for exactly two entries
    cache = ResultCache(CacheConfig(max_bytes=2 * entry().nbytes))
    cache.put("a", entry())
    cache.put("b", entry())
    assert cache.get("a", 0.0) is not None          # touch: b is now LRU
    cache.put("c", entry())                         # evicts b, not a
    assert "a" in cache and "c" in cache and "b" not in cache
    assert cache.stats()["evictions"] == 1
    # same sequence, same outcome: strict LRU has no tie-breaking noise
    cache2 = ResultCache(CacheConfig(max_bytes=2 * entry().nbytes))
    cache2.put("a", entry())
    cache2.put("b", entry())
    cache2.get("a", 0.0)
    cache2.put("c", entry())
    assert sorted(k for k in ("a", "b", "c") if k in cache2) \
        == sorted(k for k in ("a", "b", "c") if k in cache)


def test_oversized_entry_evicts_itself():
    comp = SimServer(host_ms_per_batch=0, device_ms_per_batch=0) \
        .generate_batch([_req(1, list(range(1, 9)), max_new=8)])[0]
    cache = ResultCache(CacheConfig(max_bytes=1))
    cache.put("k", CachedResult.of(comp, now=0.0))
    assert len(cache) == 0 and cache.bytes_resident == 0


# -- cached serve(): bit-identity + determinism -------------------------------

def test_cached_pipelined_bit_identical_to_uncached_sync():
    reqs = sim_requests(24, max_new_tokens=4, unique_keys=6,
                        repeat_alpha=0.8, content_seed=11)
    plain = build(_sim_server_cfg(cache=None))
    baseline = {c.rid: c for c in plain.serve(reqs, mode="sync")}

    cached = build(_sim_server_cfg(replicas=2, routing="sticky"))
    # two waves: second replays the same key population with fresh rids,
    # so it is served almost entirely from the cache
    out1 = {c.rid: c for c in cached.serve(reqs, mode="pipelined")}
    wave2 = sim_requests(24, max_new_tokens=4, rid_base=1000,
                         unique_keys=6, repeat_alpha=0.8, content_seed=11)
    base2 = {c.rid: c for c in plain.serve(wave2, mode="sync")}
    out2 = {c.rid: c for c in cached.serve(wave2, mode="pipelined")}

    assert set(out1) == set(baseline) and set(out2) == set(base2)
    for rid, c in baseline.items():
        np.testing.assert_array_equal(out1[rid].tokens, c.tokens)
        assert out1[rid].truncated == c.truncated
    for rid, c in base2.items():
        np.testing.assert_array_equal(out2[rid].tokens, c.tokens)

    rep = cached.report()
    assert rep.cache["hits"] > 0                    # wave 2 hit the cache
    assert rep.cache["hits"] + rep.cache["misses"] \
        + rep.cache["coalesced"] == 48


def test_cached_bit_identity_on_real_engine():
    reqs = [Request(rid=i, tokens=np.array([2 + i % 3, 5, 9], np.int32),
                    max_new_tokens=2, arrival=0.001 * i)
            for i in range(9)]       # 3 distinct contents, 3x repeated
    plain = build(ServeConfig(model="llama3.2-3b", device="cpu", max_seq=16,
                              target_batch=4, deadline=0.01))
    baseline = {c.rid: c for c in plain.serve(reqs, mode="sync")}
    cached = build(ServeConfig(model="llama3.2-3b", device="cpu", max_seq=16,
                               target_batch=4, deadline=0.01,
                               routing="sticky", cache=True))
    out = {c.rid: c for c in cached.serve(reqs, mode="pipelined")}
    assert set(out) == set(baseline)
    for rid, c in baseline.items():
        np.testing.assert_array_equal(out[rid].tokens, c.tokens)
        assert out[rid].truncated == c.truncated
    rep = cached.report()
    # 3 unique leaders executed; the other 6 coalesced onto them
    assert rep.cache["misses"] == 3
    assert rep.cache["coalesced"] == 6


def test_cache_off_is_unchanged():
    srv = build(_sim_server_cfg(cache=None))
    reqs = sim_requests(16, max_new_tokens=4, unique_keys=4,
                        repeat_alpha=1.0, content_seed=3)
    srv.serve(reqs, mode="pipelined")
    rep = srv.report()
    assert rep.as_dict()["cache"] == {}
    assert srv.cache is None


def test_serve_ttl_uses_logical_arrival_time():
    # TTL is judged against *logical* arrival time, not the microseconds
    # the wall-clock replay actually takes
    srv = build(_sim_server_cfg(cache=CacheConfig(ttl=1.0)))
    srv.serve([_req(0, [3, 3], arrival=0.0)], mode="sync")
    srv.serve([_req(1, [3, 3], arrival=5.0)], mode="sync")   # 5s later
    rep = srv.report()
    assert rep.cache["hits"] == 0
    assert rep.cache["stale"] == 1
    assert rep.cache["misses"] == 2

    # within TTL the revisit is a hit
    srv2 = build(_sim_server_cfg(cache=CacheConfig(ttl=1.0)))
    srv2.serve([_req(0, [3, 3], arrival=0.0)], mode="sync")
    srv2.serve([_req(1, [3, 3], arrival=0.5)], mode="sync")
    assert srv2.report().cache["hits"] == 1

    # same-stream duplicates do not coalesce across a logical gap > TTL:
    # the leader's result would already be stale by then
    srv3 = build(_sim_server_cfg(cache=CacheConfig(ttl=1.0)))
    srv3.serve([_req(0, [3, 3], arrival=0.0),
                _req(1, [3, 3], arrival=5.0),
                _req(2, [3, 3], arrival=5.2)], mode="sync")
    rep3 = srv3.report()
    assert rep3.cache["misses"] == 2          # two leaders (0 and 1)
    assert rep3.cache["coalesced"] == 1       # 2 rides on 1, within TTL


# -- single-flight coalescing under backpressure ------------------------------

def _gated_scheduler(gate, *, cache=None, **cfg_kw):
    """Scheduler over a SimServer whose host prepare blocks on ``gate`` —
    keeps a leader in flight while more submissions arrive."""
    sim = SimServer(host_ms_per_batch=1.0, device_ms_per_batch=0.0,
                    sleep=lambda dt: gate.wait(timeout=5.0))
    cfg = SchedulerConfig(cache=cache if cache is not None
                          else CacheConfig(), **cfg_kw)
    return AsyncScheduler(sim, cfg)


def _wait_for(pred, timeout=5.0):
    import time
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached")
        time.sleep(0.001)


def test_followers_resolve_with_their_leader():
    gate = threading.Event()
    sched = _gated_scheduler(gate, target_batch=1, deadline=0.001,
                             max_queue=8, policy="block")
    got = []
    sched.on_complete = lambda c: got.append(c.rid)
    sched.submit(_req(0, [9, 9]))                   # leader
    _wait_for(lambda: sched.queue_depth == 0)       # batcher holds it
    assert sched.submit(_req(1, [9, 9]))            # follower
    assert sched.submit(_req(2, [9, 9]))            # follower
    assert sched.n_coalesced == 2
    gate.set()
    outs = {c.rid: c for c in sched.result()}
    assert set(outs) == {0, 1, 2}
    for rid in (1, 2):
        np.testing.assert_array_equal(outs[rid].tokens, outs[0].tokens)
    assert sorted(got) == [0, 1, 2]                 # callbacks for all three
    rep = sched.report()
    assert rep.cache["coalesced"] == 2 and rep.cache["misses"] == 1


def test_shed_leader_promotes_its_first_follower():
    # shedding a coalescing leader no longer kills the whole flight: the
    # first follower is promoted to leader (taking a queue slot), so
    # eviction continues to the next-oldest until a slot genuinely frees
    gate = threading.Event()
    sched = _gated_scheduler(gate, target_batch=1, deadline=0.001,
                             max_queue=2, policy="shed_oldest")
    dropped = []
    sched.on_drop = dropped.append
    sched.submit(_req(0, [1, 1]))                   # plug: batcher blocks on
    _wait_for(lambda: sched.queue_depth == 0)       # its host prepare
    sched.submit(_req(1, [9, 9]))                   # leader, queued
    assert sched.submit(_req(2, [9, 9]))            # follower of 1
    sched.submit(_req(3, [5, 5]))                   # queue now full
    sched.submit(_req(4, [6, 6]))                   # sheds leader 1 -> 2
    gate.set()                                      # promoted; then sheds 3
    outs = {c.rid for c in sched.result()}
    assert outs == {0, 2, 4}                        # the flight survived
    assert sorted(dropped) == [1, 3]                # only single requests
    rep = sched.report()
    assert rep.n_shed == 2                          # old leader + next-oldest
    assert rep.cache["leader_promotions"] == 1
    assert rep.cache.get("follower_drops", 0) == 0  # no flight was killed
    # accounting: every accepted submission is a hit, miss, or coalesce
    assert rep.cache["hits"] + rep.cache["misses"] \
        + rep.cache["coalesced"] == sched.n_submitted == 5


def test_promote_on_shed_off_drops_the_flight_atomically():
    # promote_on_shed=False restores the PR 3 semantics: a shed leader
    # takes its followers down with it, in one atomic drop
    gate = threading.Event()
    sched = _gated_scheduler(gate, target_batch=1, deadline=0.001,
                             max_queue=2, policy="shed_oldest",
                             cache=CacheConfig(promote_on_shed=False))
    dropped = []
    sched.on_drop = dropped.append
    sched.submit(_req(0, [1, 1]))                   # plug
    _wait_for(lambda: sched.queue_depth == 0)
    sched.submit(_req(1, [9, 9]))                   # leader, queued
    assert sched.submit(_req(2, [9, 9]))            # follower of 1
    sched.submit(_req(3, [5, 5]))                   # queue now full
    sched.submit(_req(4, [6, 6]))                   # sheds oldest == leader 1
    gate.set()
    outs = {c.rid for c in sched.result()}
    assert outs == {0, 3, 4}                        # leader + follower gone
    assert sorted(dropped) == [1, 2]                # dropped *together*
    rep = sched.report()
    assert rep.n_shed == 1
    assert rep.cache["follower_drops"] == 1
    assert rep.cache.get("leader_promotions", 0) == 0


def test_followers_bypass_a_full_queue():
    gate = threading.Event()
    sched = _gated_scheduler(gate, target_batch=1, deadline=0.001,
                             max_queue=2, policy="reject")
    sched.submit(_req(0, [1, 1]))                   # plug
    _wait_for(lambda: sched.queue_depth == 0)
    sched.submit(_req(1, [9, 9]))                   # leader
    sched.submit(_req(2, [5, 5]))                   # queue full
    assert not sched.submit(_req(3, [6, 6]))        # unique: rejected
    assert sched.submit(_req(4, [9, 9]))            # duplicate: coalesces
    gate.set()
    outs = {c.rid for c in sched.result()}
    assert outs == {0, 1, 2, 4}
    assert sched.n_rejected == 1 and sched.n_coalesced == 1


def test_live_cache_hits_skip_the_pipeline():
    sched = AsyncScheduler(
        SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.0),
        SchedulerConfig(target_batch=4, deadline=0.001,
                        cache=CacheConfig()))
    for i in range(4):
        sched.submit(_req(i, [7, 7, 7]))
    # drain wave 1 into the cache, then resubmit the same content
    _wait_for(lambda: len(sched.cache) > 0)
    for i in range(4, 8):
        sched.submit(_req(i, [7, 7, 7]))
    outs = {c.rid: c for c in sched.result()}
    assert set(outs) == set(range(8))
    rep = sched.report()
    assert rep.cache["hits"] >= 1                   # wave 2 hit
    assert rep.cache["hits"] + rep.cache["misses"] \
        + rep.cache["coalesced"] == sched.n_submitted == 8
    hit = [outs[i] for i in range(4, 8) if outs[i].prefill_ms == 0.0]
    for c in hit:
        np.testing.assert_array_equal(c.tokens, outs[0].tokens)


# -- negative caching of MCT-filtered verdicts --------------------------------

class FilteringSim(SimServer):
    """SimServer whose execute stage silently drops any request whose
    first token is 13 — the MCT feasibility filter shape: the verdict is
    a property of the *content*, so it is worth negative-caching."""

    def __init__(self, **kw):
        kw.setdefault("host_ms_per_batch", 0.0)
        kw.setdefault("device_ms_per_batch", 0.0)
        super().__init__(**kw)
        self.n_executed = 0

    def execute_prepared(self, pb, *, device=None):
        comps = super().execute_prepared(pb, device=device)
        self.n_executed += len(pb.requests)
        keep = {r.rid for r in pb.requests if int(r.tokens[0]) != 13}
        return [c for c in comps if c.rid in keep]


def test_negative_cache_unit_ttl_and_gating():
    cache = ResultCache(CacheConfig(ttl=100.0, negative_ttl=1.0))
    assert cache.put_negative("k", 0.0)
    assert isinstance(cache.get("k", 0.5), NegativeResult)
    assert cache.get("k", 1.5) is None          # negative TTL expired
    assert "k" not in cache
    s = cache.stats()
    assert s["negative_stores"] == 1 and s["negative_hits"] == 1
    # off by default: put_negative is a no-op unless negative_ttl is set
    off = ResultCache(CacheConfig())
    assert not off.put_negative("k", 0.0)
    assert len(off) == 0


def test_scheduler_negative_hit_skips_execution():
    sim = FilteringSim()
    sched = AsyncScheduler(sim, SchedulerConfig(
        target_batch=1, deadline=0.001,
        cache=CacheConfig(negative_ttl=60.0)))
    dropped = []
    sched.on_drop = dropped.append
    sched.submit(_req(0, [13, 7]))              # executes, gets filtered
    _wait_for(lambda: sched.cache.stats()["negative_stores"] >= 1)
    executed_before = sim.n_executed
    assert sched.submit(_req(1, [13, 7]))       # negative hit: instant drop
    assert sched.submit(_req(2, [5, 5]))        # unrelated content flows
    outs = {c.rid for c in sched.result()}
    assert outs == {2}
    assert sorted(dropped) == [0, 1]
    assert sim.n_executed == executed_before + 1    # rid 1 never ran
    rep = sched.report()
    assert rep.cache["negative_stores"] == 1
    assert rep.cache["negative_hits"] == 1
    assert sched.n_negative_hits == 1
    # extended accounting: negative hits join the invariant
    assert rep.cache["hits"] + rep.cache["misses"] + rep.cache["coalesced"] \
        + rep.cache["negative_hits"] == sched.n_submitted == 3


def test_serve_negative_caching_uses_logical_time():
    srv = build(ServeConfig(cache=CacheConfig(negative_ttl=1.0),
                            server_factory=lambda i: FilteringSim()))
    # first arrival executes and is filtered; the verdict is remembered
    assert srv.serve([_req(0, [13, 4], arrival=0.0)], mode="sync") == []
    # second arrival within TTL: dropped straight from the negative cache
    assert srv.serve([_req(1, [13, 4], arrival=0.5)], mode="sync") == []
    # past TTL the verdict has expired: the content executes (and is
    # filtered, and re-stored) again
    assert srv.serve([_req(2, [13, 4], arrival=2.0)], mode="sync") == []
    rep = srv.report()
    assert rep.cache["negative_stores"] == 2
    assert rep.cache["negative_hits"] == 1
    assert rep.cache["stale"] == 1


def test_followers_of_a_filtered_leader_drop_and_store_once():
    srv = build(ServeConfig(cache=CacheConfig(negative_ttl=10.0),
                            server_factory=lambda i: FilteringSim()))
    out = srv.serve([_req(0, [13, 4], arrival=0.0),
                     _req(1, [13, 4], arrival=0.1)], mode="sync")
    assert out == []
    rep = srv.report()
    assert rep.cache["follower_drops"] == 1
    assert rep.cache["negative_stores"] == 1


# -- shared cache across replicas ---------------------------------------------

def test_shared_cache_hit_accounting_across_replicas():
    srv = build(_sim_server_cfg(replicas=2, routing="sticky",
                                target_batch=4, deadline=1.0))
    wave1 = sim_requests(16, max_new_tokens=4, unique_keys=16,
                         repeat_alpha=0.0, content_seed=21)
    wave2 = sim_requests(16, max_new_tokens=4, rid_base=100,
                         unique_keys=16, repeat_alpha=0.0, content_seed=21)
    srv.serve(wave1, mode="pipelined")
    srv.serve(wave2, mode="pipelined")
    rep = srv.report()
    # wave 2 is an exact content replay: every request hits
    assert rep.cache["hits"] == 16
    # hits are attributed to the replica that produced the cached entry,
    # and the per-replica attribution sums to the global counter
    assert sum(s.cache_hits for s in rep.per_replica.values()) \
        == rep.cache["hits"]
    assert any(s.cache_hits > 0 and 0.0 < s.cache_hit_rate <= 1.0
               for s in rep.per_replica.values())
    # both replicas executed under sticky routing, so both contributed
    assert sum(s.n_requests > 0 for s in rep.per_replica.values()) == 2


# -- accounting invariant (property test) -------------------------------------

def test_accounting_invariant_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=15, deadline=None)
    @given(keys=st.lists(st.integers(0, 4), min_size=1, max_size=30))
    def check(keys):
        sched = AsyncScheduler(
            SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.0),
            SchedulerConfig(target_batch=4, deadline=0.001,
                            max_queue=64, policy="block",
                            cache=CacheConfig()))
        for i, k in enumerate(keys):
            assert sched.submit(_req(i, [k + 1, k + 1]))
        outs = sched.result()
        rep = sched.report()
        assert rep.cache["hits"] + rep.cache["misses"] \
            + rep.cache["coalesced"] == sched.n_submitted == len(keys)
        assert len(outs) == len(keys)

    check()


# -- context managers / thread reaping ----------------------------------------

def test_scheduler_context_manager_drains_cleanly():
    with AsyncScheduler(
            SimServer(host_ms_per_batch=0.0, device_ms_per_batch=0.0),
            SchedulerConfig(target_batch=2, deadline=0.001)) as sched:
        for i in range(4):
            sched.submit(_req(i, [i + 1, 2]))
    assert not sched._batcher.is_alive()
    assert len(sched.result()) == 4


def test_scheduler_context_manager_reaps_on_exception():
    with pytest.raises(ValueError, match="boom"):
        with AsyncScheduler(
                SimServer(host_ms_per_batch=0.5, device_ms_per_batch=0.5),
                SchedulerConfig(target_batch=2, deadline=0.001)) as sched:
            sched.submit(_req(0, [3, 3]))
            raise ValueError("boom")
    assert not sched._batcher.is_alive()            # no leaked pipeline


def test_server_context_manager_reaps_default_session():
    with pytest.raises(ValueError, match="boom"):
        with build(_sim_server_cfg(cache=None)) as srv:
            srv.submit(_req(0, [3, 3]))
            sched = srv._session
            raise ValueError("boom")
    assert not sched._batcher.is_alive()
    assert srv._session is None                     # close() is idempotent
    srv.close()


def test_run_groups_reaps_workers_when_prepare_raises():
    class ExplodingSim(SimServer):
        def __init__(self):
            super().__init__(host_ms_per_batch=0.0, device_ms_per_batch=0.0)
            self.n_prepared = 0

        def prepare_batch(self, requests):
            self.n_prepared += 1
            if self.n_prepared > 1:
                raise RuntimeError("host encode failed")
            return super().prepare_batch(requests)

    srv = build(ServeConfig(server_factory=lambda i: ExplodingSim(),
                            target_batch=2, deadline=1.0))
    reqs = sim_requests(8, max_new_tokens=2)
    n0 = threading.active_count()
    with pytest.raises(RuntimeError, match="host encode failed"):
        srv.serve(reqs, mode="pipelined")
    _wait_for(lambda: threading.active_count() <= n0)


# -- loadgen repeat mode ------------------------------------------------------

def test_workload_zipf_reuse_bounds_key_population():
    from repro_torch.serve import SyntheticWorkload, zipf_probs
    wl = SyntheticWorkload(prompt_len=6, seed=3, unique_keys=5,
                           repeat_alpha=1.0)
    reqs = wl.build(64)
    keys = {request_key(r) for r in reqs}
    assert 1 <= len(keys) <= 5
    # seeded: same workload, same stream
    keys2 = [request_key(r) for r in SyntheticWorkload(
        prompt_len=6, seed=3, unique_keys=5, repeat_alpha=1.0).build(64)]
    assert keys2 == [request_key(r) for r in reqs]
    # default stays every-request-unique
    uniq = SyntheticWorkload(prompt_len=6, seed=3).build(64)
    assert len({request_key(r) for r in uniq}) == 64
    # zipf weights: normalised, head-heavy for alpha > 0
    p = zipf_probs(5, 1.0)
    assert p[0] > p[-1] and abs(p.sum() - 1.0) < 1e-12
    assert np.allclose(zipf_probs(4, 0.0), 0.25)


def test_sim_requests_content_seed_replays_key_population():
    a = sim_requests(20, unique_keys=4, repeat_alpha=0.5, content_seed=9)
    b = sim_requests(20, rid_base=500, unique_keys=4, repeat_alpha=0.5,
                     content_seed=9)
    assert [request_key(r) for r in a] == [request_key(r) for r in b]
    assert {r.rid for r in a}.isdisjoint({r.rid for r in b})


def test_coalescer_disabled_still_tracks_cache_fill():
    co = Coalescer(enabled=False)
    r = _req(0, [1, 2])
    key = request_key(r)
    assert co.attach(key, _req(1, [1, 2])) is None
    co.claim(key, 0)
    k, followers = co.resolve(0)
    assert k == key and followers == []
    assert co.in_flight() == 0


# -- replica affinity (hit_aware routing support) -----------------------------

def test_ttl_expiry_leaves_affinity_tombstone():
    """A TTL-expired entry forgets its *result* but not its *placement*:
    owner_hint survives as a tombstone so hit_aware routing can send the
    recompute back to the replica that produced it."""
    cache = ResultCache(CacheConfig(ttl=1.0))
    r = _req(1, [3, 5, 7])
    key = request_key(r)
    comp = SimServer().generate_batch([r])[0]
    cache.put(key, CachedResult.of(comp, replica=2, now=0.0))
    assert cache.owner_hint(key) == 2          # live entry's producer
    assert cache.get(key, 10.0) is None        # expired
    assert len(cache) == 0
    assert cache.owner_hint(key) == 2          # tombstone survives
    assert cache.stats()["affinity_entries"] == 1


def test_put_supersedes_affinity_tombstone():
    """A fresh live entry is the authoritative owner record: it clears any
    tombstone so a later expiry can't resurrect a stale owner."""
    cache = ResultCache(CacheConfig(ttl=1.0))
    r = _req(1, [3, 5, 7])
    key = request_key(r)
    comp = SimServer().generate_batch([r])[0]
    cache.put(key, CachedResult.of(comp, replica=0, now=0.0))
    assert cache.get(key, 10.0) is None        # tombstone -> replica 0
    cache.put(key, CachedResult.of(comp, replica=1, now=10.0))
    assert cache.stats()["affinity_entries"] == 0
    assert cache.owner_hint(key) == 1          # live entry wins
    assert cache.get(key, 20.0) is None        # re-expiry tombstones 1
    assert cache.owner_hint(key) == 1


def test_rehome_moves_owner_and_counts():
    cache = ResultCache(CacheConfig(ttl=1.0))
    r = _req(1, [3, 5, 7])
    key = request_key(r)
    comp = SimServer().generate_batch([r])[0]
    cache.put(key, CachedResult.of(comp, replica=0, now=0.0))
    assert cache.get(key, 5.0) is None
    cache.rehome(key, 3)
    assert cache.owner_hint(key) == 3
    assert cache.stats()["affinity_rehomes"] == 1


def test_affinity_map_is_bounded_and_disableable():
    cache = ResultCache(CacheConfig(ttl=1.0, max_affinity=2))
    comp = SimServer().generate_batch([_req(1, [1])])[0]
    keys = []
    for i in range(4):
        r = _req(i, [i, i + 1, i + 2])
        keys.append(request_key(r))
        cache.put(keys[-1], CachedResult.of(comp, replica=i, now=0.0))
        assert cache.get(keys[-1], 5.0) is None     # expire -> tombstone
    assert cache.stats()["affinity_entries"] == 2   # LRU-bounded
    assert cache.owner_hint(keys[0]) is None        # oldest evicted
    assert cache.owner_hint(keys[3]) == 3
    off = ResultCache(CacheConfig(ttl=1.0, max_affinity=0))
    off.put(keys[0], CachedResult.of(comp, replica=1, now=0.0))
    assert off.get(keys[0], 5.0) is None
    assert off.owner_hint(keys[0]) is None          # tombstones disabled


def test_owner_hint_does_not_touch_lru_or_counters():
    """Routing probes must not keep entries artificially fresh or skew
    hit/miss accounting."""
    cache = ResultCache(CacheConfig())
    ra, rb = _req(1, [1, 2, 3]), _req(2, [4, 5, 6])
    ka, kb = request_key(ra), request_key(rb)
    comp = SimServer().generate_batch([ra])[0]
    cache.put(ka, CachedResult.of(comp, replica=0, now=0.0))
    cache.put(kb, CachedResult.of(comp, replica=1, now=0.0))
    before = cache.stats()
    for _ in range(5):
        assert cache.owner_hint(ka) == 0
    after = cache.stats()
    assert after["hits"] == before["hits"]
    assert after["misses"] == before["misses"]
    # ka was probed 5x but kb must still be the most-recently-used entry
    assert next(iter(cache._entries)) == ka


# -- parity with the JAX package ------------------------------------------------

def _filtering_sim(pkg):
    """The pkg's SimServer that drops content whose first token is 13 (an
    MCT-filter stand-in), with no sleeps."""
    class _Filtering(pkg.SimServer):
        def __init__(self):
            super().__init__(host_ms_per_batch=0.0, device_ms_per_batch=0.0)

        def execute_prepared(self, pb, *, device=None):
            comps = super().execute_prepared(pb, device=device)
            keep = {r.rid for r in pb.requests if int(r.tokens[0]) != 13}
            return [c for c in comps if c.rid in keep]
    return _Filtering


def _stream(pkg, rid_base, t0):
    """12 requests over 5 contents, one of them filtered, 1 ms apart."""
    contents = [[13, 4], [3, 5, 7], [2, 2], [3, 5, 7], [9, 1, 1, 4],
                [13, 4], [2, 2], [6], [3, 5, 7], [9, 1, 1, 4], [6], [2, 2]]
    return [pkg.Request(rid=rid_base + i,
                        tokens=np.asarray(c, np.int32), max_new_tokens=3,
                        arrival=t0 + i * 1e-3)
            for i, c in enumerate(contents)]


CACHE_CASES = [dict(), dict(ttl=1.0), dict(negative_ttl=5.0),
               dict(ttl=1.0, negative_ttl=0.5, coalesce=False),
               dict(max_bytes=300, negative_ttl=5.0)]


@pytest.mark.parametrize("case", range(len(CACHE_CASES)))
def test_sync_cache_counters_equal_reference(case):
    import repro_torch.serve as P

    def run(pkg):
        srv = pkg.build(pkg.ServeConfig(
            cache=pkg.CacheConfig(**CACHE_CASES[case]), target_batch=4,
            deadline=0.005, server_factory=lambda i: _filtering_sim(pkg)()))
        outs = []
        for w, t0 in enumerate((0.0, 0.2, 3.0)):   # replay, stale replay
            outs += srv.serve(_stream(pkg, 100 * w, t0), mode="sync")
        rep = srv.report()
        return (sorted((c.rid, c.tokens.tolist()) for c in outs),
                rep.cache, srv.cache.stats())
    got, want = run(P), run(J)
    assert got == want
    assert got[1]["misses"] > 0


def test_request_key_equals_reference():
    qs = [{"a": 3, "b": -1}, {"b": 7, "a": 0}]
    for kw in (dict(), dict(mct_queries=qs, connect_minutes=[30, 45])):
        a = Request(rid=1, tokens=np.asarray([3, 5, 7], np.int32),
                    max_new_tokens=4, **kw)
        b = J.Request(rid=1, tokens=np.asarray([3, 5, 7], np.int32),
                      max_new_tokens=4, **kw)
        assert request_key(a) == J.request_key(b)
