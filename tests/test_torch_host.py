"""Port parity, host side: the port's copies of rules, compiler, encoder,
workload and aggregator give byte-equal outputs to the JAX package's on the
reference tests' seeds."""
import dataclasses

import numpy as np
import pytest

from repro.core import aggregator as j_agg
from repro.core import compiler as j_comp
from repro.core import encoder as j_enc
from repro.core import rules as j_rules
from repro.core import workload as j_wl
from repro_torch.core import aggregator as t_agg
from repro_torch.core import compiler as t_comp
from repro_torch.core import encoder as t_enc
from repro_torch.core import rules as t_rules
from repro_torch.core import workload as t_wl

_ARRAYS = ("mins", "maxs", "weights", "decisions", "rule_ids", "part_of_rule",
           "part_order", "part_offsets", "wildcard_rows")


def _rules_equal(a, b):
    assert a.version == b.version and a.default_decision == b.default_decision
    assert [dataclasses.asdict(c) for c in a.schema] == \
        [dataclasses.asdict(c) for c in b.schema]
    assert len(a.rules) == len(b.rules)
    for ra, rb in zip(a.rules, b.rules):
        assert (ra.values, ra.decision, ra.rule_id) == \
            (rb.values, rb.decision, rb.rule_id)


def _tables_equal(a, b):
    for k in _ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
    assert [dataclasses.asdict(c) for c in a.columns] == \
        [dataclasses.asdict(c) for c in b.columns]
    assert a.dictionaries == b.dictionaries
    assert (a.version, a.default_decision, a.partition_col, a.n_partitions) == \
        (b.version, b.default_decision, b.partition_col, b.n_partitions)


def test_schemas_equal():
    for fj, ft in ((j_rules.schema_v1, t_rules.schema_v1),
                   (j_rules.schema_v2, t_rules.schema_v2)):
        assert [dataclasses.asdict(c) for c in fj()] == \
            [dataclasses.asdict(c) for c in ft()]
    assert (t_rules.WILDCARD, t_rules.RANGE_MAX) == \
        (j_rules.WILDCARD, j_rules.RANGE_MAX)
    assert (t_comp.INT_MAX, t_comp.OOV_CODE) == (j_comp.INT_MAX, j_comp.OOV_CODE)
    assert t_comp.OOV_CODE.dtype == j_comp.OOV_CODE.dtype


@pytest.mark.parametrize("n,version,seed", [
    (2_000, 2, 1), (100, 2, 2), (50, 1, 0), (50, 2, 0), (600, 2, 11)])
def test_generate_rules_equal(n, version, seed):
    _rules_equal(j_rules.generate_rules(n, version=version, seed=seed),
                 t_rules.generate_rules(n, version=version, seed=seed))


@pytest.mark.parametrize("version,seed,qseed", [(2, 2, 3), (1, 9, 4),
                                                (2, 11, 12)])
def test_generate_queries_equal(version, seed, qseed):
    jr = j_rules.generate_rules(200, version=version, seed=seed)
    tr = t_rules.generate_rules(200, version=version, seed=seed)
    assert j_rules.generate_queries(jr, 120, seed=qseed) == \
        t_rules.generate_queries(tr, 120, seed=qseed)


def test_rule_weight_equal():
    s1, s2 = t_rules.schema_v1(), t_rules.schema_v2()
    for vals in ({"airport": 5}, {"airport": 5, "arr_terminal": 1},
                 {"airport": 1, "arr_flightno": (100, 110)},
                 {"airport": 1, "arr_flightno": (100, 5000)}):
        for schema in (s1, s2):
            for v in (1, 2):
                assert t_rules.Rule(vals, 30).weight(schema, v) == \
                    j_rules.Rule(vals, 30).weight(schema, v)


@pytest.mark.parametrize("n,version,seed", [
    (50, 1, 0), (50, 2, 0), (4_000, 2, 5), (500, 2, 1), (600, 2, 11)])
def test_compile_rules_equal(n, version, seed):
    jt = j_comp.compile_rules(j_rules.generate_rules(n, version=version,
                                                     seed=seed))
    tt = t_comp.compile_rules(t_rules.generate_rules(n, version=version,
                                                     seed=seed))
    _tables_equal(jt, tt)


def test_compile_overlap_split_equal():
    """The hand-built overlap case of tests/test_compiler.py."""
    def build(mod):
        base = {"airport": 1}
        rs = [mod.Rule(values={**base, "arr_flightno": (100, 500)},
                       decision=30, rule_id=0),
              mod.Rule(values={**base, "arr_flightno": (300, 800)},
                       decision=60, rule_id=1),
              mod.Rule(values={"airport": 1, "arr_terminal": 2}, decision=25),
              mod.Rule(values={"airport": 1,
                               "arr_terminal": mod.WILDCARD}, decision=60)]
        return mod.RuleSet(schema=mod.schema_v2(), rules=rs, version=2)
    _tables_equal(j_comp.compile_rules(build(j_rules)),
                  t_comp.compile_rules(build(t_rules)))


@pytest.mark.parametrize("version,seed,qseed,n", [(2, 11, 12, 256),
                                                  (1, 9, 4, 128),
                                                  (2, 21, 9, 512)])
def test_encode_equal(version, seed, qseed, n):
    jr = j_rules.generate_rules(600, version=version, seed=seed)
    tr = t_rules.generate_rules(600, version=version, seed=seed)
    jt, tt = j_comp.compile_rules(jr), t_comp.compile_rules(tr)
    qs = t_rules.generate_queries(tr, n, seed=qseed)
    qs[0] = dict(qs[0], airport=999_999, arr_terminal=123_456)   # OOV codes
    jf, tf = j_enc.queries_to_arrays(qs), t_enc.queries_to_arrays(qs)
    assert jf.keys() == tf.keys()
    assert all(jf[k].tobytes() == tf[k].tobytes() for k in jf)
    je, te = j_enc.encode(jt, jf), t_enc.encode(tt, tf)
    assert je.dtype == te.dtype == np.int32 and je.shape == te.shape
    assert je.tobytes() == te.tobytes()
    assert t_enc.encode_queries(tt, qs).tobytes() == je.tobytes()
    assert t_enc.queries_to_arrays([]) == {}


def _batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.uid, x.queries, x.ts_index) == (y.uid, y.queries, y.ts_index)


@pytest.mark.parametrize("n_rules,n_users,seed,mean_ts", [
    (100, 40, 1, 920.0), (800, 6, 2, 60.0), (2_000, 8, 3, 120.0)])
def test_workload_and_batches_equal(n_rules, n_users, seed, mean_ts):
    jr = j_rules.generate_rules(n_rules, version=2, seed=0)
    tr = t_rules.generate_rules(n_rules, version=2, seed=0)
    jw = j_wl.generate_workload(jr, n_users, seed=seed, mean_ts=mean_ts)
    tw = t_wl.generate_workload(tr, n_users, seed=seed, mean_ts=mean_ts)
    assert len(jw) == len(tw)
    for ju, tu in zip(jw, tw):
        assert (ju.uid, ju.required_ts, ju.n_mct) == \
            (tu.uid, tu.required_ts, tu.n_mct)
        assert [(s.n_connections, s.mct_queries) for s in ju.solutions] == \
            [(s.n_connections, s.mct_queries) for s in tu.solutions]
        _batches_equal(j_agg.paper_policy(ju), t_agg.paper_policy(tu))
        _batches_equal(j_agg.greedy_all(ju), t_agg.greedy_all(tu))
    assert j_wl.workload_stats(jw) == t_wl.workload_stats(tw)
    jb = [b for u in jw for b in j_agg.paper_policy(u)]
    tb = [b for u in tw for b in t_agg.paper_policy(u)]
    assert j_agg.batch_stats(jb) == t_agg.batch_stats(tb)


@pytest.mark.parametrize("pattern,required", [((1, 1, 1, 1), 2),
                                              ((0, 0, 3), 10),
                                              ((1, 0, 2, 1, 1), 3)])
def test_policies_on_hand_built_queries(pattern, required):
    def uq(mod):
        sols = [mod.TravelSolution(c, [{"q": i}] * c if c else [])
                for i, c in enumerate(pattern)]
        return mod.UserQuery(uid=0, required_ts=required, solutions=sols)
    for pol in ("paper_policy", "greedy_all"):
        _batches_equal(getattr(j_agg, pol)(uq(j_wl)),
                       getattr(t_agg, pol)(uq(t_wl)))


def test_deadline_aggregator_equal():
    """One scripted sequence of offers, polls, evictions and a flush."""
    script = [("offer", 0, 3, 0.0), ("offer", 1, 2, 0.1), ("poll", 0.5),
              ("offer", 2, 9, 0.6), ("evict", 0.7), ("poll", 11.0),
              ("offer", 3, 1, 12.0), ("poll", 12.5), ("flush",)]
    outs = []
    for mod in (j_agg, t_agg):
        agg = mod.DeadlineAggregator(target_batch=4, deadline=10.0)
        log = []
        for step in script:
            if step[0] == "offer":
                _, uid, n, now = step
                got = agg.offer(uid, [{"i": uid * 100 + i} for i in range(n)],
                                now=now)
            elif step[0] == "poll":
                got = agg.poll(now=step[1])
            elif step[0] == "evict":
                got = [agg.evict_oldest(now=step[1])]
            else:
                got = agg.flush()
            log.append([(b.uid, b.queries, b.ts_index) if hasattr(b, "uid")
                        else b for b in got])
            log.append((agg.pending(), agg.next_deadline()))
        outs.append(log)
    assert outs[0] == outs[1]
