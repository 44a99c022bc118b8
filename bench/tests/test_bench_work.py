"""bench/work counts against brute force, and the frozen generators."""
import hashlib
import json

import numpy as np
import pytest

from bench.harness import gen
from bench.reference import mct as ref
from bench.work import mct as work


def _brute(dense, values, order):
    """Compares by definition: every pair, criteria in ``order``, the
    leading one charged once per distinct value and rule."""
    lo, hi = dense.lo[:, order], dense.hi[:, order]
    q = values[:, order]
    bound = (lo > -(1 << 39)) | (hi < (1 << 39))
    total = 0
    for code in np.unique(q[:, 0]):
        total += int(np.where(code < lo[:, 0], 1, 2).sum())
    for b in range(len(q)):
        for r in range(len(lo)):
            if q[b, 0] != lo[r, 0]:
                continue
            for k in range(1, lo.shape[1]):
                if not bound[r, k]:
                    continue
                if q[b, k] < lo[r, k]:
                    total += 1
                    break
                total += 2
                if q[b, k] > hi[r, k]:
                    break
    return total


@pytest.mark.parametrize("seed", [0, 1])
def test_compares_equal_brute_force(seed):
    rs = gen.generate_rules(300, version=2, seed=seed)
    dense = ref.dense_rules(rs)
    values = ref.query_values(rs, gen.generate_queries(rs, 40, seed=seed))
    order = list(range(len(dense.names)))
    order.remove(dense.names.index("airport"))
    order = [dense.names.index("airport")] + order
    assert work.compares(dense, values, order) == _brute(dense, values, order)


def test_lane_bound_picks_the_larger_term():
    rs = gen.generate_rules(200, version=2, seed=3)
    dense = ref.dense_rules(rs)
    values = ref.query_values(rs, gen.generate_queries(rs, 64, seed=4))
    order = [dense.names.index("airport")] + [
        i for i in range(len(dense.names)) if dense.names[i] != "airport"]
    b = work.lane_bound(dense, values, order)
    assert b["bytes"] == 4 * (200 * 53 + 64 * 26 + 64 * 3)
    assert b["bound_s"] == max(b["ops"] / work.peaks.INT32_OPS,
                               b["bytes"] / work.peaks.HBM_BYTES_PER_S)


GOLDEN = "58207b9e300500a3"


def _digest(rs, queries, shapes):
    blob = json.dumps([[r.values, r.decision, r.rule_id] for r in rs.rules]
                      + [queries] + [[s.required_ts, s.connections]
                                     for s in shapes], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def test_frozen_generators_golden_hash():
    rs = gen.generate_rules(500, version=2, seed=42)
    qs = gen.generate_queries(rs, 50, seed=7)
    shapes = gen.search_shapes(5, seed=3)
    assert _digest(rs, qs, shapes) == GOLDEN


def test_frozen_generators_equal_the_programs():
    from repro_torch.core import rules as prules, workload as pwork
    rs = gen.generate_rules(400, version=2, seed=5)
    prs = prules.generate_rules(400, version=2, seed=5)
    assert [(r.values, r.decision) for r in rs.rules] == \
        [(r.values, r.decision) for r in prs.rules]
    assert gen.generate_queries(rs, 30, seed=9) == \
        prules.generate_queries(prs, 30, seed=9)
    wl = pwork.generate_workload(prs, 4, seed=3, mean_ts=50.0)
    shapes = gen.search_shapes(4, seed=3, mean_ts=50.0)
    assert [[ts.n_connections for ts in u.solutions] for u in wl] == \
        [s.connections for s in shapes]
    assert [u.required_ts for u in wl] == [s.required_ts for s in shapes]
