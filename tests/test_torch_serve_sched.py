"""Port of the serving stack, scheduler and front end: the cases of
``tests/test_scheduler.py`` and ``tests/test_serve_api.py`` run against
``repro_torch.serve`` on the CPU (``device="cpu"``), plus parity with the
JAX package: one ``serve()`` end to end on the reduced float32
``llama3.2-3b`` (the reference's parameters carried across by
``convert.params_from_numpy``) behind a ~2,000-rule MCT filter gives the
reference's tokens and drops the reference's requests, exactly.

The reference's multi-device case runs here on two spellings of the CPU
device; its mesh cases run on one CPU rank here and on a 4-rank mesh in
``tests/test_torch_dist.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.compiler import compile_rules as j_compile
from repro.core.engine import ErbiumEngine as JEngine
from repro.core.rules import generate_queries as j_queries
from repro.core.rules import generate_rules as j_rules
from repro.serve import LMServer as JServer
from repro.serve import Request as JRequest
from repro.serve import serve as j_serve
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.compiler import compile_rules
from repro_torch.core.engine import ErbiumEngine
from repro_torch.core.rules import generate_queries, generate_rules
from repro_torch.serve import (AsyncScheduler, BackpressurePolicy,
                               ClosedLoopGen, EngineGroup, LMServer,
                               MetricsCollector, OpenLoopGen, Request,
                               SchedulerConfig, ServeConfig, SimServer,
                               SyntheticWorkload, build, form_batch_groups,
                               poisson_arrivals, serve, sim_requests)


def run_sync(server, reqs, *, target_batch, deadline):
    """Synchronous baseline: form batches with the paper's deadline policy,
    then run them one at a time (the device idles during host encode)."""
    out = []
    for rs in form_batch_groups(reqs, target_batch=target_batch,
                                deadline=deadline):
        out.extend(server.generate_batch(rs))
    return out


def run_pipe(server, reqs, *, target_batch, deadline, devices=None,
             metrics=None):
    """Pipelined replay of the same batch groups through EngineGroup —
    the implementation behind ``Server.serve(mode="pipelined")``."""
    groups = form_batch_groups(reqs, target_batch=target_batch,
                               deadline=deadline)
    group = EngineGroup.from_server(server, devices=devices)
    return group.run_groups(groups, metrics=metrics)


@pytest.fixture(scope="module")
def server():
    cfg = get_config("llama3.2-3b").reduced()
    return LMServer(cfg, device="cpu", max_seq=48)


@pytest.fixture(scope="module")
def workload(server):
    return SyntheticWorkload(vocab=server.cfg.vocab, prompt_len=6,
                             max_new_tokens=3, seed=1)


def test_poisson_arrivals_seeded():
    a = poisson_arrivals(64, 100.0, seed=5)
    b = poisson_arrivals(64, 100.0, seed=5)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.diff(a) > 0)
    # mean inter-arrival ~ 1/qps
    assert 0.5 / 100.0 < np.diff(a).mean() < 2.0 / 100.0


def test_async_identical_to_sync_baseline(server, workload):
    """(c) The pipelined path must be bit-identical to the synchronous
    baseline for the same request stream."""
    reqs = OpenLoopGen(workload, qps=200.0, n=12, seed=7).requests()
    sync = run_sync(server, reqs, target_batch=4, deadline=0.01)
    pipe = run_pipe(server, reqs, target_batch=4, deadline=0.01)
    assert len(sync) == len(pipe) == 12
    by_sync = {c.rid: c for c in sync}
    for c in pipe:
        ref = by_sync[c.rid]
        np.testing.assert_array_equal(ref.tokens, c.tokens)
        assert ref.batch_size == c.batch_size
        assert ref.truncated == c.truncated


def test_backpressure_bounds_queue_under_overload(server, workload):
    """(a) Under a 4x-overload burst the bounded queue never exceeds its
    configured depth, rejections happen, and the report carries the
    device-idle-fraction signal."""
    max_queue = 8
    sched = AsyncScheduler(server, target_batch=4, deadline=0.002,
                           max_queue=max_queue, policy="reject")
    reqs = workload.build(4 * max_queue)
    accepted = sum(sched.submit(r) for r in reqs)
    outs = sched.result()
    rep = sched.report(offered_qps=1000.0)
    assert rep.max_queue_depth <= max_queue
    assert sched.n_rejected > 0
    assert accepted + sched.n_rejected == 4 * max_queue
    assert len(outs) == accepted
    assert 0.0 <= rep.device_idle_fraction <= 1.0
    assert rep.breakdown["device"].n == accepted


def test_shed_oldest_policy_bounds_queue(server, workload):
    sched = AsyncScheduler(server, target_batch=4, deadline=0.002,
                           max_queue=8, policy="shed_oldest")
    reqs = workload.build(32, rid_base=100)
    for r in reqs:
        assert sched.submit(r)       # shed admits by evicting, never refuses
    outs = sched.result()
    rep = sched.report()
    assert rep.max_queue_depth <= 8
    assert sched.n_shed + len(outs) == 32


def test_open_loop_low_qps_small_batches(server, workload):
    """(b1) Open loop far below capacity: deadline flushes dominate, so
    batches stay well under target size (logical-time replay)."""
    gen = OpenLoopGen(workload, qps=10.0, n=12, seed=3)
    reqs = gen.requests()   # mean gap 100 ms >> 5 ms deadline
    outs = run_pipe(server, reqs, target_batch=8, deadline=0.005)
    assert len(outs) == 12
    assert max(o.batch_size for o in outs) <= 2


def test_closed_loop_fills_target_batches(server, workload):
    """(b2) Closed loop with concurrency >= target: every batch forms at
    exactly target size."""
    sched = AsyncScheduler(server, target_batch=4, deadline=5.0,
                           max_queue=32, policy="block")
    ClosedLoopGen(workload, concurrency=8, n=16).drive(sched)
    outs = sched.result()
    assert len(outs) == 16
    assert all(o.batch_size == 4 for o in outs)


def test_scheduler_tokens_match_solo_generation(server, workload):
    """Live scheduling must not change results: batching is composition-
    independent (masked attention), so tokens equal solo generation even
    though live batch composition is timing-dependent."""
    reqs = workload.build(8, rid_base=200)
    solo = {r.rid: server.generate_batch([r])[0].tokens for r in reqs}
    sched = AsyncScheduler(server, target_batch=4, deadline=0.005,
                           max_queue=32, policy="block")
    for r in reqs:
        sched.submit(r)
    outs = sched.result()
    assert sorted(c.rid for c in outs) == sorted(solo)
    for c in outs:
        np.testing.assert_array_equal(solo[c.rid], c.tokens)


def test_metrics_breakdown_complete(server, workload):
    metrics = MetricsCollector()
    reqs = OpenLoopGen(workload, qps=500.0, n=8, seed=11).requests()
    run_pipe(server, reqs, target_batch=4, deadline=0.01, metrics=metrics)
    rep = metrics.report(offered_qps=500.0)
    assert rep.n_completed == 8
    for part in ("encode", "device", "total"):
        assert rep.breakdown[part].n == 8
        assert rep.breakdown[part].p50_ms >= 0.0
    assert rep.achieved_qps > 0.0
    d = rep.as_dict()
    assert set(d["breakdown"]) == {"queue_wait", "encode", "device",
                                   "drain", "total"}


def test_scheduler_config_validation():
    with pytest.raises(ValueError):
        SchedulerConfig(policy="drop_everything")


def test_device_error_surfaces_instead_of_hanging(server, workload):
    """A request whose prompt exceeds max_seq kills the device stage; the
    error must propagate out of result(), not wedge producers on the full
    handoff queue."""
    sched = AsyncScheduler(server, target_batch=1, deadline=0.001,
                           max_queue=16, policy="block")
    bad = workload.build(1, rid_base=300)[0]
    bad.tokens = np.ones(server.max_seq + 4, np.int32)   # oversized prompt
    sched.submit(bad)
    for r in workload.build(6, rid_base=310):
        try:
            sched.submit(r)
        except RuntimeError:
            break                    # batcher already saw the worker die
    with pytest.raises(RuntimeError):
        sched.result()


def test_result_without_submissions_returns_empty(server):
    sched = AsyncScheduler(server, target_batch=4, deadline=0.01,
                           max_queue=8)
    assert sched.result() == []


def test_blocked_submitter_fails_fast_on_pipeline_death(server, workload):
    """policy='block' must not wedge forever when the pipeline dies: the
    waiter wakes and raises instead of waiting for space that will never
    free up."""
    sched = AsyncScheduler(server, target_batch=1, deadline=0.001,
                           max_queue=2, policy="block")
    bad = workload.build(1, rid_base=400)[0]
    bad.tokens = np.ones(server.max_seq + 4, np.int32)   # kills the worker
    sched.submit(bad)
    with pytest.raises(RuntimeError):
        for r in workload.build(8, rid_base=410):
            sched.submit(r)          # must raise, not hang
    with pytest.raises(RuntimeError):
        sched.result()


def test_closed_loop_survives_rejections(server, workload):
    """Rejected/never-completing requests must return their concurrency
    permit — the drive loop may not wedge under backpressure."""
    sched = AsyncScheduler(server, target_batch=2, deadline=0.001,
                           max_queue=2, policy="reject")
    gen = ClosedLoopGen(workload, concurrency=4, n=12, seed=9)
    accepted = gen.drive(sched)      # would deadlock on permit leaks
    outs = sched.result()
    assert len(outs) == accepted
    assert accepted + sched.n_rejected == 12


def test_multi_device_round_robin_identical(server, workload):
    """Batches round-robin across the listed devices (two spellings of the
    CPU here; the card's test file lists CUDA devices) and still produce
    bit-identical completions."""
    reqs = OpenLoopGen(workload, qps=200.0, n=10, seed=7).requests()
    sync = run_sync(server, reqs, target_batch=4, deadline=0.01)
    multi = run_pipe(server, reqs, target_batch=4, deadline=0.01,
                     devices=[torch.device("cpu"), "cpu"])
    by_sync = {c.rid: c for c in sync}
    for c in multi:
        np.testing.assert_array_equal(by_sync[c.rid].tokens, c.tokens)


# ---------------------------------------------------------------------------
# the serving front end (the cases of test_serve_api.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def srv():
    return build(ServeConfig(model="llama3.2-3b", device="cpu", max_seq=48,
                             target_batch=4, deadline=0.01))


@pytest.fixture(scope="module")
def api_workload(srv):
    return SyntheticWorkload(vocab=srv.engine.cfg.vocab, prompt_len=6,
                             max_new_tokens=3, seed=1)


def test_build_wires_full_stack(srv):
    assert len(srv.group.replicas) == 1
    assert srv.engine is srv.group.replicas[0].server
    assert srv.engines == [srv.engine]
    assert srv.report().n_requests == 0     # shared collector, fresh


def test_serve_modes_bit_identical(srv, api_workload):
    """Server.serve documents the bit-identity guarantee: pipelined mode
    must equal the synchronous baseline for the same stream."""
    reqs = OpenLoopGen(api_workload, qps=200.0, n=12, seed=7).requests()
    sync = srv.serve(reqs, mode="sync")
    pipe = srv.serve(reqs, mode="pipelined")
    assert len(sync) == len(pipe) == 12
    by_sync = {c.rid: c for c in sync}
    for c in pipe:
        np.testing.assert_array_equal(by_sync[c.rid].tokens, c.tokens)
        assert by_sync[c.rid].batch_size == c.batch_size


def test_serve_rejects_unknown_mode(srv, api_workload):
    with pytest.raises(ValueError, match="mode"):
        srv.serve(api_workload.build(2), mode="turbo")


def test_default_session_submit_result(srv, api_workload):
    for r in api_workload.build(6, rid_base=500):
        assert srv.submit(r)
    outs = srv.result()
    assert sorted(c.rid for c in outs) == list(range(500, 506))
    assert srv.result() == []               # session is drained + recycled
    rep = srv.report()
    assert rep.n_completed >= 6             # shared metrics saw the session


def test_session_overrides_scheduler_knobs(srv, api_workload):
    sched = srv.session(policy="block", deadline=5.0, max_queue=32,
                        target_batch=2)
    assert sched.cfg.policy is BackpressurePolicy.BLOCK
    for r in api_workload.build(4, rid_base=600):
        sched.submit(r)
    outs = sched.result()
    assert len(outs) == 4
    assert all(o.batch_size == 2 for o in outs)


# ---------------------------------------------------------------------------
# BackpressurePolicy enum
# ---------------------------------------------------------------------------

def test_policy_enum_accepts_strings_and_members():
    assert SchedulerConfig(policy="reject").policy \
        is BackpressurePolicy.REJECT
    assert SchedulerConfig(policy=BackpressurePolicy.SHED_OLDEST).policy \
        is BackpressurePolicy.SHED_OLDEST
    # str-mixin: existing string comparisons keep working
    assert SchedulerConfig(policy="block").policy == "block"
    assert str(BackpressurePolicy.BLOCK) == "block"


def test_policy_validation_error_lists_valid_values():
    with pytest.raises(ValueError) as ei:
        SchedulerConfig(policy="drop_everything")
    msg = str(ei.value)
    for valid in ("reject", "shed_oldest", "block"):
        assert valid in msg
    assert "drop_everything" in msg


# ---------------------------------------------------------------------------
# the PR-1/PR-2 era shims are gone — the unified surface is the only one
# ---------------------------------------------------------------------------

def test_deprecated_entry_points_removed(srv):
    import repro_torch.serve as S
    assert not hasattr(S, "run_pipelined")
    assert not hasattr(S.scheduler, "run_pipelined")
    assert not hasattr(srv.engine, "serve_stream")


# ---------------------------------------------------------------------------
# serve() one-call convenience
# ---------------------------------------------------------------------------

def test_serve_convenience_returns_completions_and_report():
    outs, rep = serve(
        sim_requests(12), replicas=2, target_batch=4, deadline=1.0,
        server_factory=lambda i: SimServer(device_ms_per_batch=1.0))
    assert len(outs) == 12
    assert rep.n_completed == 12
    assert rep.breakdown["device"].n == 12


def test_serve_convenience_config_xor_kwargs():
    cfg = ServeConfig(server_factory=lambda i: SimServer(), target_batch=4,
                      deadline=1.0)
    outs, rep = serve(sim_requests(4), config=cfg)
    assert len(outs) == 4
    with pytest.raises(ValueError, match="config"):
        serve(sim_requests(2), config=cfg, replicas=2)


def test_build_warmup_knob():
    class WarmSpy(SimServer):
        warmed = None

        def warmup(self, batch_sizes=(1, 8)):
            self.warmed = tuple(batch_sizes)

    srv = build(ServeConfig(server_factory=lambda i: WarmSpy(), replicas=2,
                            warmup=(2, 4)))
    assert all(e.warmed == (2, 4) for e in srv.engines)
    assert build(ServeConfig(server_factory=lambda i: WarmSpy(),
                             warmup=True)).engine.warmed == (1, 8)
    # default stays off; engines without warmup (plain SimServer) tolerate
    # the knob
    assert build(ServeConfig(
        server_factory=lambda i: WarmSpy())).engine.warmed is None
    build(ServeConfig(server_factory=lambda i: SimServer(), warmup=True))


def test_server_facade_works_with_sim_factory():
    srv = build(ServeConfig(
        replicas=2, target_batch=4, deadline=1.0,
        server_factory=lambda i: SimServer(device_ms_per_batch=1.0)))
    assert len(srv.group.replicas) == 2
    assert len(srv.engines) == 2            # distinct engines, one each
    outs = srv.serve(sim_requests(16), mode="pipelined")
    assert len(outs) == 16


# ---------------------------------------------------------------------------
# port-only: the device knob and the mesh constructor
# ---------------------------------------------------------------------------

def test_build_defaults_to_the_card(monkeypatch):
    assert ServeConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build(ServeConfig(model="llama3.2-3b", max_seq=16))


def test_build_places_the_server_on_the_first_listed_device():
    srv = build(ServeConfig(model="llama3.2-3b", max_seq=16,
                            devices=["cpu", torch.device("cpu")]))
    assert srv.engine.device == torch.device("cpu")
    assert [r.devices for r in srv.group.replicas] == \
        [["cpu"], [torch.device("cpu")]]


def test_params_copied_once_per_device_under_contention(monkeypatch):
    """Replica threads that reach a device together copy the parameters
    there once: 16 threads, a 1 us switch interval, a slow copy."""
    import sys
    import threading
    import time

    import repro_torch.serve.engine as eng_mod
    srv = LMServer(get_config("llama3.2-3b").reduced(), device="cpu",
                   max_seq=16)
    copies = []
    real = eng_mod._tree_to

    def slow_copy(tree, device):
        if tree is srv.params:               # not the recursive calls
            copies.append(device)
            time.sleep(0.01)
        return real(tree, device)
    monkeypatch.setattr(eng_mod, "_tree_to", slow_copy)
    got, start = [], threading.Barrier(16)

    def worker(dev):
        start.wait(timeout=10)
        got.append(srv._params_on(dev))
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(torch.device(d),))
                   for d in ["cpu", "meta"] * 8]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert sorted(map(str, copies)) == ["cpu", "meta"]
    assert len(got) == 16
    assert len({id(g) for g in got}) == 2


def test_mesh_waits_for_the_sharding_port(tmp_path):
    """``EngineGroup.from_mesh`` and ``ServeConfig.mesh`` on a one-rank
    (1, 1) CPU mesh: one replica on the CPU; an axis the mesh lacks is an
    error."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("cpu", init_method=f"file://{tmp_path}/store")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        group = EngineGroup.from_mesh(SimServer(), mesh)
        assert len(group.replicas) == 1
        assert [str(d) for d in group.replicas[0].devices] == ["cpu"]
        with pytest.raises(ValueError, match="axis"):
            EngineGroup.from_mesh(SimServer(), mesh, axis="pod")
        srv = build(ServeConfig(model="llama3.2-3b", reduced=True,
                                device="cpu", max_seq=16, mesh=mesh))
        assert len(srv.group.replicas) == 1
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parity with the JAX package: serve() end to end behind the MCT filter
# ---------------------------------------------------------------------------

def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _filtered_stream(queries, table, n=10):
    """Requests of 3-9 prompt tokens with 1-3 MCT queries each; every
    other request gets connect times below the matched rule's MCT, so the
    filter drops it. Returned as plain dicts for either package."""
    rng = np.random.default_rng(11)
    eng = ErbiumEngine(table, device="cpu")
    out, q = [], 0
    for i in range(n):
        k = int(rng.integers(1, 4))
        qs = queries[q:q + k]
        q += k
        dec = eng.match_queries(qs)[0].numpy()
        mct = [int(d) if d >= 0 else table.default_decision for d in dec]
        late = i % 2 == 1
        out.append(dict(
            rid=i, tokens=rng.integers(1, 256, int(rng.integers(3, 10))),
            max_new_tokens=int(rng.integers(2, 5)), arrival=i * 0.002,
            mct_queries=qs,
            connect_minutes=[m - 5 if late else m + 10 for m in mct]))
    return out


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_serve_end_to_end_matches_reference(mode):
    j_cfg = _f32(j_get_config("llama3.2-3b").reduced())
    cfg = _f32(get_config("llama3.2-3b").reduced())
    j_params = JServer(j_cfg, max_seq=8).params
    params = params_from_numpy(
        jax.tree_util.tree_map(lambda x: np.array(x, np.float32), j_params),
        cfg, device="cpu")
    rs_j = j_rules(2_000, version=2, seed=3)
    rs = generate_rules(2_000, version=2, seed=3)
    table = compile_rules(rs)
    qs = generate_queries(rs, 40, seed=5)
    assert qs == j_queries(rs_j, 40, seed=5)
    spec = _filtered_stream(qs, table)

    def mk(cls):
        return [cls(rid=r["rid"], tokens=np.asarray(r["tokens"], np.int32),
                    max_new_tokens=r["max_new_tokens"], arrival=r["arrival"],
                    mct_queries=r["mct_queries"],
                    connect_minutes=r["connect_minutes"]) for r in spec]

    knobs = dict(mode=mode, replicas=2, target_batch=4, deadline=0.005,
                 cache=True, trace=True)
    j_srv = JServer(j_cfg, j_params, max_seq=32,
                    rule_filter=JEngine(j_compile(rs_j), backend="ref"))
    srv = LMServer(cfg, params, device="cpu", max_seq=32,
                   rule_filter=ErbiumEngine(table, device="cpu"))
    j_outs, j_rep = j_serve(mk(JRequest), server_factory=lambda i: j_srv,
                            **knobs)
    outs, rep = serve(mk(Request), server_factory=lambda i: srv, **knobs)
    j_by, by = {c.rid: c for c in j_outs}, {c.rid: c for c in outs}
    assert sorted(by) == sorted(j_by)
    assert 0 < len(by) < len(spec)           # the filter dropped some
    for rid, c in by.items():
        np.testing.assert_array_equal(c.tokens, np.asarray(j_by[rid].tokens))
        assert c.truncated == j_by[rid].truncated
        assert c.batch_size == j_by[rid].batch_size
    assert sorted(rep.batch_sizes) == sorted(j_rep.batch_sizes)
    assert {k: rep.cache[k] for k in ("hits", "misses", "coalesced")} == \
        {k: j_rep.cache[k] for k in ("hits", "misses", "coalesced")}
