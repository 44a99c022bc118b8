"""The plain references against the program's CPU paths at tiny sizes, and
the controls against the references."""
import numpy as np
import pytest

from bench.harness import gen
from bench.reference import mct as ref_mct

@pytest.fixture(scope="module")
def mct_case():
    from repro_torch.core.compiler import compile_rules
    from repro_torch.core.engine import ErbiumEngine
    rs = gen.generate_rules(2_000, version=2, seed=42)
    qs = gen.generate_queries(rs, 400, seed=11)
    eng = ErbiumEngine(compile_rules(rs), device="cpu")
    dec, w, rid = (x.numpy() for x in eng.match_queries(qs))
    return rs, qs, dec, w, rid


def test_mct_reference_accepts_the_program(mct_case):
    rs, qs, dec, w, rid = mct_case
    dense = ref_mct.dense_rules(rs)
    values = ref_mct.query_values(rs, qs)
    assert (w >= 0).sum() > 200          # most queries match some rule
    assert ref_mct.judge(dense, values, dec, w, rid) == 0
    rdec, rw, rrid = ref_mct.answers(dense, values)
    assert (rw == w).all()


def test_mct_judge_catches_an_altered_answer(mct_case):
    rs, qs, dec, w, rid = mct_case
    dense = ref_mct.dense_rules(rs)
    values = ref_mct.query_values(rs, qs)
    hit = np.flatnonzero(w >= 0)[:3]
    for field in (dec, w, rid):
        bad = field.copy()
        bad[hit] += 1
        args = [bad if f is field else f for f in (dec, w, rid)]
        assert ref_mct.judge(dense, values, *args) == 3


def test_mct_control_fails(mct_case):
    """The control breaks v2's precision guarantee (no penalty for wide
    ranges): its answers are judged wrong."""
    rs, qs, _, _, _ = mct_case
    values = ref_mct.query_values(rs, qs)
    cdec, cw, crid = ref_mct.answers(
        ref_mct.dense_rules(rs, dynamic_weights=False), values)
    assert ref_mct.judge(ref_mct.dense_rules(rs), values, cdec, cw, crid) > 0
