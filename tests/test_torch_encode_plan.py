"""The host encoder's plan (``encoder.EncodePlan``) against the per-key path
(``queries_to_arrays`` + ``encode``) and the JAX reference's
``encode_queries``, byte for byte: v1 and v2 tables on several seeds, empty
to large batches, values outside, below and inside a dictionary's key range,
negative and 64-bit values, code-share indicators 0-2, extra fields and a
dictionary kept as sorted keys. Then the batches it hands to the per-key
path, its counts, reload, and the wrapper's ``encode`` spans."""
import functools
import itertools
import sys
import threading

import numpy as np
import pytest

from repro.core import compiler as j_comp
from repro.core import encoder as j_enc
from repro.core import rules as j_rules
from repro_torch.core import compiler as t_comp
from repro_torch.core import encoder as t_enc
from repro_torch.core import rules as t_rules
from repro_torch.core.aggregator import Batch, paper_policy
from repro_torch.core.engine import ErbiumEngine, cpu_match_numpy
from repro_torch.core.workload import generate_workload
from repro_torch.core.wrapper import MCTWrapper
from repro_torch.serve.trace import TraceConfig, Tracer

N_RULES = 600
POOL = 4096
SEEDS = [(11, 12), (21, 9)]          # (rule seed, query seed)
I64_MIN, I64_MAX = -2 ** 63, 2 ** 63 - 1


def _ruleset(mod, version, seed, wide):
    rs = mod.generate_rules(N_RULES, version=version, seed=seed)
    if wide:   # keys 2e9 apart: too wide a range for a direct-index lookup
        rs.rules[0].values["arr_terminal"] = 10 ** 9
        rs.rules[1].values["arr_terminal"] = -10 ** 9
    return rs


@functools.lru_cache(maxsize=None)
def _system(version, seed, qseed, wide=False):
    """(JAX table, port table, the port's plan, a pool of queries)."""
    jt = j_comp.compile_rules(_ruleset(j_rules, version, seed, wide))
    rs = _ruleset(t_rules, version, seed, wide)
    tt = t_comp.compile_rules(rs)
    return jt, tt, t_enc.EncodePlan(tt), t_rules.generate_queries(
        rs, POOL, seed=qseed)


def _range_fields(table):
    return sorted({f for c in table.columns if c.kind != "cat"
                   for f in (c.cross_fields or (c.source,))} - {
                       c.cross_fields[2] for c in table.columns
                       if c.cross_fields})


def _cat_fields(table):
    return sorted({f for c in table.columns if c.kind == "cat"
                   for f in (c.cross_fields or (c.source,))[:2]})


def _oov_values(table, field):
    """Raw values a categorical field's dictionary does not hold: below,
    above and (where the keys leave one) inside its key range."""
    src = next(c.source for c in table.columns
               if field in (c.cross_fields or (c.source,))[:2])
    keys = set(table.dictionaries[src])
    lo, hi = min(keys), max(keys)
    inside = itertools.islice((v for v in range(lo, hi) if v not in keys), 2)
    return [lo - 1, lo - 1000, hi + 1, hi + 7, -5, I64_MIN, I64_MAX, *inside]


def _edit(queries, table, kind, rng):
    """Copies of ``queries``, every other one carrying ``kind``'s values."""
    out = [dict(q) for q in queries]
    oov = {f: _oov_values(table, f) for f in _cat_fields(table)}
    for i, q in enumerate(out):
        if i % 2:
            continue
        if kind == "oov":
            for f, vals in oov.items():
                q[f] = int(rng.choice(vals))
        elif kind == "wide_range":
            vals = [2 ** 31, 2 ** 31 + 7, 2 ** 32 + 3, -2 ** 31 - 1, -1,
                    I64_MIN, I64_MAX]
            for f in _range_fields(table):
                q[f] = int(rng.choice(vals))
        elif kind == "code_share":
            for f in ("arr_cs", "dep_cs"):
                q[f] = int(rng.integers(0, 3))
        elif kind == "extra":
            q["aa_extra"], q["zz_extra"] = int(rng.integers(-9, 9)), 2 ** 40
    return out


def _per_key(table, queries):
    return t_enc.encode(table, t_enc.queries_to_arrays(queries))


def _check_equal(jt, tt, plan, queries):
    got, fallback = plan.encode(queries)
    want = j_enc.encode_queries(jt, queries)
    assert not fallback
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape == (len(queries), tt.n_cols)
    assert got.flags.c_contiguous
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == _per_key(tt, queries).tobytes()
    return got


@pytest.mark.parametrize("kind", ["plain", "oov", "wide_range", "code_share",
                                  "extra"])
@pytest.mark.parametrize("B", [1, 384, 4096])
@pytest.mark.parametrize("seeds", SEEDS)
@pytest.mark.parametrize("version", [1, 2])
def test_plan_equals_per_key_and_reference(version, seeds, B, kind):
    jt, tt, plan, pool = _system(version, *seeds)
    rng = np.random.default_rng([version, *seeds, B])
    start = int(rng.integers(0, POOL - B + 1))
    queries = _edit(pool[start:start + B], tt, kind, rng)
    got = _check_equal(jt, tt, plan, queries)
    if kind == "oov" and B > 1:
        assert (got == int(t_comp.OOV_CODE)).any()
    if kind == "wide_range" and B > 1:
        rng_cols = [j for j, c in enumerate(tt.columns) if c.kind != "cat"]
        assert (got[::2][:, rng_cols] < 0).any()   # wrapped as astype wraps


@pytest.mark.parametrize("seeds", SEEDS)
@pytest.mark.parametrize("version", [1, 2])
def test_empty_batch(version, seeds):
    """B = 0: a (0, C) array, the per-key ``encode`` of empty fields (the
    per-key path's ``queries_to_arrays([])`` holds no field to size it)."""
    jt, tt, plan, _ = _system(version, *seeds)
    got, fallback = plan.encode([])
    empty = {f: np.zeros(0, np.int64) for f in plan.fields}
    assert not fallback and got.shape == (0, tt.n_cols)
    assert got.dtype == np.int32
    assert got.tobytes() == j_enc.encode(jt, empty).tobytes() == \
        t_enc.encode(tt, empty).tobytes()
    eng = ErbiumEngine(tt, device="cpu", tile_r=128)
    assert eng.encode_queries_host([]).shape == (0, tt.n_cols)


@pytest.mark.parametrize("kind", ["plain", "oov"])
@pytest.mark.parametrize("B", [384, 4096])
@pytest.mark.parametrize("version", [1, 2])
def test_sorted_keys_dictionary(version, B, kind):
    """A dictionary whose keys span 2e9 is kept as sorted keys; the rest
    stay direct-index arrays, and the bytes do not change."""
    jt, tt, plan, pool = _system(version, 11, 12, wide=True)
    j = next(j for j, c in enumerate(tt.columns) if c.name == "arr_terminal")
    assert [s[0] for s in plan._sorted] == [j]
    assert j not in plan._dense and len(plan._dense) > 0
    rng = np.random.default_rng([version, B])
    queries = _edit(pool[:B], tt, kind, rng)
    for i, v in enumerate((10 ** 9, -10 ** 9, 10 ** 9 + 1, 0)):
        queries[2 * i + 1] = dict(queries[2 * i + 1], arr_terminal=v)
    got = _check_equal(jt, tt, plan, queries)
    assert got[5, j] == int(t_comp.OOV_CODE)
    assert int(t_comp.OOV_CODE) not in (got[1, j], got[3, j])


def test_dictionaries_at_this_scale_are_direct_index():
    for version in (1, 2):
        _, tt, plan, _ = _system(version, 11, 12)
        cats = [j for j, c in enumerate(tt.columns) if c.kind == "cat"]
        assert sorted(plan._dense.tolist()) == cats and not plan._sorted
        assert len(plan._cross) == (0 if version == 1 else 8)


def _outcome(fn):
    try:
        return "bytes", fn().tobytes()
    except Exception as e:          # the exception the per-key path raises
        return "raises", type(e)


FALLBACK_CASES = {
    "missing_in_one": lambda qs, f: qs[3].pop(f),
    "missing_in_all": lambda qs, f: [q.pop(f) for q in qs],
    "float": lambda qs, f: qs[2].update({f: 3.5}),
    "integral_float": lambda qs, f: qs[2].update({f: 7.0}),
    "string": lambda qs, f: qs[1].update({f: "abc"}),
    "none": lambda qs, f: qs[0].update({f: None}),
    "above_int64": lambda qs, f: qs[4].update({f: 2 ** 64}),
    "numpy_float": lambda qs, f: qs[4].update({f: np.float64(2.0)}),
}


@pytest.mark.parametrize("field", ["airport", "date"])
@pytest.mark.parametrize("case", sorted(FALLBACK_CASES))
def test_unreadable_batch_goes_to_the_per_key_path(case, field):
    """Today's bytes or today's exception, and one more fallback batch."""
    jt, tt, _, pool = _system(2, 11, 12)
    plan = t_enc.EncodePlan(tt)
    queries = [dict(q) for q in pool[:16]]
    FALLBACK_CASES[case](queries, field)
    want = _outcome(lambda: _per_key(tt, queries))
    assert want == _outcome(lambda: j_enc.encode_queries(jt, queries))
    assert _outcome(lambda: plan.encode(queries)[0]) == want
    assert (plan.n_plan, plan.n_fallback) == (0, 1)
    if want[0] == "bytes":
        assert plan.encode(queries)[1] is True
        assert (plan.n_plan, plan.n_fallback) == (0, 2)


def test_counts_are_thread_safe():
    """More threads than cores on one plan, a short switch interval: no
    batch is lost from either count, and each gets its own bytes."""
    _, tt, _, pool = _system(2, 11, 12)
    plan = t_enc.EncodePlan(tt)
    bad = [dict(q) for q in pool[:8]]
    del bad[5]["arr_cs"]
    want = {k: _per_key(tt, pool[k:k + 8]).tobytes() for k in range(40)}
    wrong = []

    def work():
        for k in range(40):
            if k % 4 == 0:
                plan.encode(bad)
            elif plan.encode(pool[k:k + 8])[0].tobytes() != want[k]:
                wrong.append(k)

    threads = [threading.Thread(target=work) for _ in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not wrong
    assert (plan.n_plan, plan.n_fallback) == (16 * 30, 16 * 10)


@pytest.mark.parametrize("new_version", [1, 2])
def test_reload_encodes_with_the_new_table(new_version):
    _, tt, _, pool = _system(2, 11, 12)
    eng = ErbiumEngine(tt, device="cpu", tile_r=128)
    old_plan = eng.plan
    before = eng.encode_queries_host(pool[:256])
    assert before.tobytes() == _per_key(tt, pool[:256]).tobytes()
    rs2 = t_rules.generate_rules(N_RULES, version=new_version, seed=99)
    eng.reload(rs2)
    assert eng.plan is not old_plan and eng.plan.table is eng.table
    qs = t_rules.generate_queries(rs2, 256, seed=5)
    got = eng.encode_queries_host(qs)
    assert got.shape == (256, eng.table.n_cols)
    assert got.tobytes() == _per_key(eng.table, qs).tobytes()
    if new_version == 2:      # the same queries read through another table
        assert eng.encode_queries_host(pool[:256]).tobytes() != \
            before.tobytes()
    for a, b in zip(eng.match_queries(qs),
                    cpu_match_numpy(eng.table, _per_key(eng.table, qs))):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("broken", [False, True])
def test_wrapper_encodes_with_the_plan(broken):
    """Generated traffic through MCTWrapper: answers equal to
    ``cpu_match_numpy`` of the per-key encoding, and every ``encode`` span
    says which path made it."""
    rs = t_rules.generate_rules(N_RULES, version=2, seed=21)
    table = t_comp.compile_rules(rs)
    eng = ErbiumEngine(table, device="cpu", tile_r=128)
    wl = generate_workload(rs, 4, seed=2, mean_ts=60.0)
    batches = [b for uq in wl for b in paper_policy(uq)]
    if broken:      # one query short of a field the table reads
        qs = [dict(q) for q in batches[1].queries]
        del qs[0]["dep_cs"]
        batches[1] = Batch(batches[1].uid, qs, batches[1].ts_index)
    tr = Tracer(TraceConfig(capacity=1 << 14))
    wrap = MCTWrapper([eng], n_workers=2, tracer=tr)
    wrap.start()
    try:
        for b in batches:
            wrap.submit(b)
        results = {r.uid: r for r in wrap.drain(len(batches), timeout=60)}
    finally:
        wrap.stop()
    assert len(batches) > 2 and len(results) == len(batches)
    for b in batches:
        want = cpu_match_numpy(table, _per_key(table, b.queries))
        r = results[b.uid]
        for g, w in zip((r.decisions, r.weights, r.rule_ids), want):
            np.testing.assert_array_equal(g, w)
    spans = {s.meta["uid"]: s.meta["fallback"] for s in tr.spans()
             if s.stage == "encode"}
    assert spans == {b.uid: int(broken and b.uid == batches[1].uid)
                     for b in batches}
    assert eng.plan.n_fallback == int(broken)
    assert eng.plan.n_plan == len(batches) - int(broken)
