"""Port parity, engine and host integration: the port's ErbiumEngine (dense,
plain and partitioned, on its own compiled table and on the reference's
table carried across by ``convert.table_from_numpy``) and its MCTWrapper
against the JAX package's, exactly, on the CPU."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro.core.aggregator import paper_policy as j_paper_policy
from repro.core.compiler import compile_rules as j_compile
from repro.core.encoder import encode_queries as j_encode
from repro.core.engine import ErbiumEngine as JEngine
from repro.core.engine import cpu_match_numpy as j_cpu_numpy
from repro.core.engine import cpu_match_python as j_cpu_python
from repro.core.rules import generate_queries as j_queries
from repro.core.rules import generate_rules as j_rules
from repro.core.workload import generate_workload as j_workload
from repro.core.wrapper import MCTWrapper as JWrapper
from repro_torch.convert import table_from_numpy
from repro_torch.core.aggregator import Batch, paper_policy
from repro_torch.core.compiler import compile_rules
from repro_torch.core.encoder import queries_to_arrays
from repro_torch.core.engine import (ErbiumEngine, cpu_match_numpy,
                                     cpu_match_python)
from repro_torch.core.rules import generate_queries, generate_rules
from repro_torch.core.workload import generate_workload
from repro_torch.core.wrapper import MCTWrapper, measure_stage_times

CONFIGS = {
    "kernel": dict(tile_r=128),
    "ref": dict(backend="ref"),
    "partitioned": dict(tile_r=128, partitioned=True),
    "lanes": dict(tile_r=128, n_engines=2),
}


@pytest.fixture(scope="module")
def setup():
    """tests/test_engine.py's setup, in both packages."""
    jt = j_compile(j_rules(600, version=2, seed=11))
    enc = j_encode(jt, j_queries(j_rules(600, version=2, seed=11), 256,
                                 seed=12))
    want = [np.asarray(x) for x in
            JEngine(jt, tile_b=64, tile_r=128).match(enc)]
    tables = {"own": compile_rules(generate_rules(600, version=2, seed=11)),
              "converted": table_from_numpy(dataclasses.asdict(jt))}
    return jt, enc, want, tables


@pytest.mark.parametrize("source", ["own", "converted"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_equals_jax(setup, source, config):
    _, enc, want, tables = setup
    eng = ErbiumEngine(tables[source], device="cpu", **CONFIGS[config])
    got = eng.match(enc)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    assert float(np.mean(want[1] >= 0)) > 0.5   # the case has real matches


def test_converted_table_is_the_reference_table(setup):
    jt, _, _, tables = setup
    ct = tables["converted"]
    for k in ("mins", "maxs", "weights", "decisions", "rule_ids",
              "part_of_rule", "part_order", "part_offsets", "wildcard_rows"):
        assert getattr(ct, k).tobytes() == getattr(jt, k).tobytes(), k
    assert ct.dictionaries == jt.dictionaries
    assert [c.cross_fields for c in ct.columns] == \
        [c.cross_fields for c in jt.columns]
    assert ct.memory_bytes() == jt.memory_bytes()


def test_match_queries_equals_encode_then_match(setup):
    _, _, _, tables = setup
    t = tables["own"]
    qs = generate_queries(generate_rules(600, version=2, seed=11), 64, seed=3)
    eng = ErbiumEngine(t, device="cpu", tile_r=128)
    enc = eng.encode_queries_host(qs)
    assert enc.tobytes() == eng.encode(queries_to_arrays(qs)).tobytes()
    for a, b in zip(eng.match_queries(qs), eng.match(torch.as_tensor(enc))):
        assert torch.equal(a, b)


def test_cpu_baselines_equal_jax(setup):
    jt, enc, want, tables = setup
    t = tables["own"]
    for g, w in zip(cpu_match_numpy(t, enc), j_cpu_numpy(jt, enc)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(cpu_match_python(t, enc, limit=40),
                    j_cpu_python(jt, enc, limit=40)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(cpu_match_numpy(t, enc)[0], want[0])


def test_hot_reload_equals_fresh_jax_engine(setup):
    _, enc, _, tables = setup
    eng = ErbiumEngine(tables["own"], device="cpu", tile_r=128)
    us = eng.reload(generate_rules(600, version=2, seed=99))
    assert us > 0 and eng.reload_us == us
    jrs2 = j_rules(600, version=2, seed=99)
    jt2 = j_compile(jrs2)
    enc2 = j_encode(jt2, j_queries(jrs2, 256, seed=12))
    want = JEngine(jt2, backend="ref").match(enc2)
    for g, w in zip(eng.match(enc2), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_entry_points_need_a_card_unless_told_cpu(setup, monkeypatch):
    _, _, _, tables = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ErbiumEngine(tables["own"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ErbiumEngine(tables["own"], device="cuda:0")
    with pytest.raises(ValueError):
        ErbiumEngine(tables["own"], device="meta")
    assert ErbiumEngine(tables["own"], device="cpu").device.type == "cpu"


@pytest.fixture(scope="module")
def system():
    """tests/test_system.py's setup, in both packages."""
    jrs = j_rules(800, version=2, seed=21)
    jeng = JEngine(j_compile(jrs), tile_b=64, tile_r=256)
    jwl = j_workload(jrs, 6, seed=2, mean_ts=60.0)
    rs = generate_rules(800, version=2, seed=21)
    table = compile_rules(rs)
    eng = ErbiumEngine(table, device="cpu", tile_r=256)
    wl = generate_workload(rs, 6, seed=2, mean_ts=60.0)
    return (jeng, jwl), (rs, table, eng, wl)


def _run(wrapper_cls, engine, batches, n_workers):
    wrap = wrapper_cls([engine], n_workers=n_workers)
    wrap.start()
    try:
        for b in batches:
            wrap.submit(b)
        results = wrap.drain(len(batches), timeout=120)
    finally:
        wrap.stop()
    return sorted((r.uid, r.decisions.tobytes(), r.weights.tobytes())
                  for r in results), results


def test_wrapper_slice_equals_jax(system):
    """The whole slice — rules, compile, workload, paper_policy batches,
    MCTWrapper workers, engine — against the JAX package's."""
    (jeng, jwl), (rs, table, eng, wl) = system
    jb = [b for uq in jwl for b in j_paper_policy(uq)]
    tb = [b for uq in wl for b in paper_policy(uq)]
    want, _ = _run(JWrapper, jeng, jb, 2)
    got, results = _run(MCTWrapper, eng, tb, 2)
    assert len(got) == len(tb) > 1
    assert got == want
    for r in results:
        assert r.decisions.dtype == r.weights.dtype == np.int32
        assert r.rule_ids.shape == r.decisions.shape
        assert r.times.total_us > 0 and r.times.batch == len(r.decisions)


def test_wrapper_many_workers_stress(system):
    """More workers than cores, a short switch interval: every batch comes
    back once, with the synchronous path's answer."""
    _, (rs, table, eng, wl) = system
    batches = [b for uq in wl for b in paper_policy(uq)] * 3
    sync = MCTWrapper([eng])
    want = sorted((b.uid, sync.process(b).decisions.tobytes())
                  for b in batches)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, results = _run(MCTWrapper, eng, batches, 16)
    finally:
        sys.setswitchinterval(old)
    assert sorted((r.uid, r.decisions.tobytes()) for r in results) == want


def test_measure_stage_times(system):
    rs, table, eng, wl = system[1]
    qs = generate_queries(rs, 512, seed=9)

    def make_batch(n):
        return Batch(0, [qs[i % len(qs)] for i in range(n)], [(0, -1)] * n)

    times = measure_stage_times(eng, make_batch, [64, 256, 1024], repeats=2)
    assert [t.batch for t in times] == [64, 256, 1024]
    assert all(t.kernel_us > 0 and t.encode_us > 0 for t in times)
    assert times[-1].encode_us > times[0].encode_us
