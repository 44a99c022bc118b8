"""Port parity, packed rule-match table: ``pack``/``criterion_order``, the
packed plain version behind ``rule_match_packed`` (with the batch sorted and
unsorted as the main path does) and ``match_rules`` against the Pallas kernel
in interpret mode and the JAX oracle, exactly, on the CPU. The CUDA kernel on
the packed table is held against these in test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

pytest.importorskip(
    "hypothesis",
    reason="property tests need the 'test' extra (pip install -e .[test])")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.compiler import compile_rules as j_compile  # noqa: E402
from repro.core.encoder import encode_queries as j_encode  # noqa: E402
from repro.core.rules import generate_queries as j_queries  # noqa: E402
from repro.core.rules import generate_rules as j_rules  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels.ref import rule_match_ref as j_ref  # noqa: E402
from repro.kernels.rule_match import rule_match_pallas  # noqa: E402
from repro_torch.core.compiler import OOV_CODE  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rule_match as rm  # noqa: E402

SHAPES = [(64, 128, 8, 64, 128), (128, 256, 26, 64, 128),
          (256, 512, 31, 256, 512), (32, 512, 3, 32, 256),
          (512, 128, 13, 128, 128)]
I32 = np.iinfo(np.int32)
WILD_MAX = I32.max - 1


def _random_tables(rng, B, R, C, weight_max=100):
    q = rng.integers(0, 50, (B, C)).astype(np.int32)
    mins = rng.integers(0, 50, (R, C)).astype(np.int32)
    maxs = mins + rng.integers(0, 30, (R, C)).astype(np.int32)
    wild = rng.random((R, C)) < 0.5
    mins = np.where(wild, 0, mins).astype(np.int32)
    maxs = np.where(wild, WILD_MAX, maxs).astype(np.int32)
    w = rng.integers(0, weight_max, (R,)).astype(np.int32)
    return q, mins, maxs, w


def _brute(q, mins, maxs, w):
    """numpy brute force in int64: highest weight, lowest index, or -1."""
    q64, mn, mx = (a.astype(np.int64) for a in (q, mins, maxs))
    ok = ((q64[:, None, :] >= mn[None]) & (q64[:, None, :] <= mx[None])).all(-1)
    score = np.where(ok, w[None, :].astype(np.int64), -1)
    best = score.max(1)
    idx = np.where(best >= 0, score.argmax(1), -1)
    return best.astype(np.int32), idx.astype(np.int32)


def _jax_ref(q, mins, maxs, w):
    rw, ri = j_ref(jnp.asarray(q), jnp.asarray(mins), jnp.asarray(maxs),
                   jnp.asarray(w))
    return np.asarray(rw), np.asarray(ri)


def _packed(q, mins, maxs, w, crit=None, sort=True):
    """The main path's use of the packed table on the CPU: pack once, sort
    the batch by the leading criterion, match, unsort."""
    mins_t, maxs_t = torch.as_tensor(mins.T), torch.as_tensor(maxs.T)
    if crit is None:
        crit = rm.criterion_order(mins_t, maxs_t)
    bounds, wk = rm.pack(mins_t, maxs_t, torch.as_tensor(w), crit)
    qt = torch.as_tensor(q)
    order = torch.argsort(qt[:, int(crit[0])]) if sort else None
    bw, bi = rm.rule_match_packed(qt, bounds, wk, crit, order)
    assert bw.dtype == bi.dtype == torch.int32
    return bw.numpy(), bi.numpy()


@pytest.mark.parametrize("B,R,C,tb,tr", SHAPES)
def test_packed_plain_version_matches_pallas_and_oracle(B, R, C, tb, tr):
    rng = np.random.default_rng(B + R + C)
    q, mins, maxs, w = _random_tables(rng, B, R, C)
    kw, ki = rule_match_pallas(jnp.asarray(q.T), jnp.asarray(mins.T),
                               jnp.asarray(maxs.T), jnp.asarray(w[None]),
                               tile_b=tb, tile_r=tr, interpret=True)
    rw, ri = _jax_ref(q, mins, maxs, w)
    pw, pi = _packed(q, mins, maxs, w)
    np.testing.assert_array_equal(pw, np.asarray(kw)[0])
    np.testing.assert_array_equal(pi, np.asarray(ki)[0])
    np.testing.assert_array_equal(pw, rw)
    np.testing.assert_array_equal(pi, ri)


EDGE = np.array([I32.min, I32.min + 1, -7, -1, 0, 1, 2, 5, 40,
                 int(OOV_CODE), WILD_MAX, I32.max], np.int64)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 70), st.integers(1, 140), st.integers(1, 9),
       st.integers(0, 2**31 - 1))
def test_property_one_compare_test_edges(B, R, C, seed):
    """The (q - base) <= span test on int32 extremes, negative codes,
    min > max on rules of weight >= 0, wildcards met by OOV queries and
    ties spread over many rules equals the two-compare semantics."""
    rng = np.random.default_rng(seed)
    pick = rng.random
    q = np.where(pick((B, C)) < 0.6, rng.choice(EDGE, (B, C)),
                 rng.integers(-3, 45, (B, C))).astype(np.int32)
    q = np.where(pick((B, C)) < 0.1, OOV_CODE, q).astype(np.int32)
    a = np.where(pick((R, C)) < 0.5, rng.choice(EDGE, (R, C)),
                 rng.integers(-3, 45, (R, C)))
    b = np.where(pick((R, C)) < 0.5, rng.choice(EDGE, (R, C)),
                 a + rng.integers(-2, 30, (R, C)))
    mins = np.clip(a, I32.min, I32.max).astype(np.int32)
    maxs = np.clip(b, I32.min, I32.max).astype(np.int32)
    wild = pick((R, C)) < 0.4
    mins = np.where(wild, 0, mins).astype(np.int32)
    maxs = np.where(wild, WILD_MAX, maxs).astype(np.int32)
    w = rng.integers(0, 3, (R,)).astype(np.int32)     # many ties
    want = _brute(q, mins, maxs, w)
    got = _packed(q, mins, maxs, w)
    for g, e, r in zip(got, want, _jax_ref(q, mins, maxs, w)):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(g, r)


def test_pack_layout():
    """(base, span) rows in crit_order, span as uint32 in int32, -1 weight
    where min > max, an even rule count."""
    mins = np.array([[0, I32.min, 5], [3, 9, -4], [2, 0, 0]], np.int32)
    maxs = np.array([[10, I32.max, 5], [1, 9, -1], [WILD_MAX, 0, 0]],
                    np.int32)
    crit = torch.tensor([2, 0, 1], dtype=torch.int32)
    bounds, wk = rm.pack(torch.as_tensor(mins.T), torch.as_tensor(maxs.T),
                         torch.tensor([4, 6, 8], dtype=torch.int32), crit)
    assert bounds.shape == (3, 4, 2) and wk.tolist() == [4, -1, 8, -1]
    span_u32 = (maxs.astype(np.int64) - mins).T[[2, 0, 1]] & 0xFFFFFFFF
    got = bounds[:, :3, 1].numpy().astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(got[:, [0, 2]], span_u32[:, [0, 2]])
    np.testing.assert_array_equal(bounds[:, :3, 0].numpy(), mins.T[[2, 0, 1]])
    assert int(bounds[2, 0, 1]) == -1          # INT32_MIN..INT32_MAX: 2**32-1
    assert bounds[:, 3].abs().sum() == 0


def test_criterion_order_from_the_table_alone():
    t = j_compile(j_rules(600, version=2, seed=11))
    mins_t, maxs_t = (torch.as_tensor(a.T.copy()) for a in (t.mins, t.maxs))
    crit = rm.criterion_order(mins_t, maxs_t)
    assert crit.dtype == torch.int32
    assert sorted(crit.tolist()) == list(range(t.n_cols))
    assert int(crit[0]) == t.partition_col      # airport: never a wildcard
    assert torch.equal(crit, rm.criterion_order(mins_t.clone(),
                                                maxs_t.clone()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_results_do_not_depend_on_crit_order_or_batch_order(seed):
    """A random criterion permutation and a shuffled batch give bit-identical
    outputs (the batch's results follow its queries)."""
    rng = np.random.default_rng(seed)
    q, mins, maxs, w = _random_tables(rng, 200, 300, 12, weight_max=5)
    base = _packed(q, mins, maxs, w)
    perm = torch.as_tensor(rng.permutation(12).astype(np.int32))
    for got in (_packed(q, mins, maxs, w, crit=perm),
                _packed(q, mins, maxs, w, sort=False)):
        for g, b in zip(got, base):
            np.testing.assert_array_equal(g, b)
    shuffle = rng.permutation(200)
    got = _packed(q[shuffle], mins, maxs, w, crit=perm)
    for g, b in zip(got, base):
        np.testing.assert_array_equal(g, b[shuffle])


@pytest.fixture(scope="module")
def v2_setup():
    rs = j_rules(400, version=2, seed=21)
    t = j_compile(rs)
    return t, j_encode(t, j_queries(rs, 200, seed=22))


@pytest.mark.parametrize("n_engines", [1, 2, 4])
def test_match_rules_packed_equal_jax(v2_setup, n_engines):
    t, enc = v2_setup
    want = j_ops.match_rules(jnp.asarray(enc), j_ops.device_table(t, tile_r=128),
                             tile_b=32, tile_r=128, n_engines=n_engines)
    dt = ops.device_table(t, tile_r=128, device="cpu")
    got = ops.match_rules(torch.as_tensor(enc), dt, n_engines=n_engines)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(np.mean(np.asarray(want[1]) >= 0)) > 0.5


def test_device_table_packs_once_in_kernel_order(v2_setup):
    t, enc = v2_setup
    dt = ops.device_table(t, tile_r=128, device="cpu")
    crit = dt.crit_order.long()
    assert dt.lead_col == int(crit[0])
    assert dt.bounds.shape == (t.n_cols, dt.mins_t.shape[1], 2)
    np.testing.assert_array_equal(dt.bounds[..., 0].numpy(),
                                  dt.mins_t[crit].numpy())
    np.testing.assert_array_equal(dt.weights_k.numpy(), dt.weights[0].numpy())
    # a repacked table in another order matches the same
    perm = torch.arange(t.n_cols - 1, -1, -1, dtype=torch.int32)
    bounds, wk = rm.pack(dt.mins_t, dt.maxs_t, dt.weights, perm)
    other = dt._replace(crit_order=perm, bounds=bounds, weights_k=wk,
                        lead_col=int(perm[0]))
    qt = torch.as_tensor(enc)
    for g, w in zip(ops.match_rules(qt, other), ops.match_rules(qt, dt)):
        assert torch.equal(g, w)


def test_lane_sort_glue_on_the_cpu(monkeypatch, v2_setup):
    """match_lane hands the kernel's plain version the batch sorted by the
    leading criterion and returns the results in the lane's order."""
    t, enc = v2_setup
    dt = ops.device_table(t, tile_r=128, device="cpu")
    seen = []
    plain = ref.rule_match_packed_ref

    def spy(q, *a):
        seen.append(q[:, dt.lead_col].clone())
        return plain(q, *a)
    monkeypatch.setattr(rm.ref_mod, "rule_match_packed_ref", spy)
    lane = torch.as_tensor(enc)
    w, i = ops.match_lane(lane, dt)
    assert torch.equal(seen[0], seen[0].sort().values)
    rw, ri = ref.rule_match_ref(lane, dt.mins_t.T, dt.maxs_t.T, dt.weights[0])
    assert torch.equal(w, rw) and torch.equal(i, ri)


def test_packed_wrapper_rejects_bad_inputs():
    q, mins, maxs, w = _random_tables(np.random.default_rng(0), 8, 10, 3)
    crit = torch.arange(3, dtype=torch.int32)
    bounds, wk = rm.pack(torch.as_tensor(mins.T), torch.as_tensor(maxs.T),
                         torch.as_tensor(w), crit)
    qt = torch.as_tensor(q)
    with pytest.raises(TypeError):
        rm.rule_match_packed(qt.long(), bounds, wk, crit)
    with pytest.raises(TypeError):
        rm.rule_match_packed(qt, bounds, wk, crit, torch.arange(8).int())
    with pytest.raises(ValueError):
        rm.rule_match_packed(qt[:, :2], bounds, wk, crit)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rm.rule_match_packed(*(x.to("meta") for x in (qt, bounds, wk, crit)))
    with pytest.raises(ValueError, match="not both"):
        rm.rule_match_packed(qt, bounds, wk, crit, torch.arange(8),
                             sort_col=0)


@pytest.mark.parametrize("sort_col", [0, 2])
def test_sort_col_equals_a_given_order(sort_col):
    """Sorting by a column inside the call is the same as passing its
    argsort, and as no sort at all."""
    q, mins, maxs, w = _random_tables(np.random.default_rng(sort_col), 90,
                                      200, 5, weight_max=4)
    crit = torch.tensor([2, 0, 1, 4, 3], dtype=torch.int32)
    bounds, wk = rm.pack(torch.as_tensor(mins.T), torch.as_tensor(maxs.T),
                         torch.as_tensor(w), crit)
    qt = torch.as_tensor(q)
    by_col = rm.rule_match_packed(qt, bounds, wk, crit, sort_col=sort_col)
    by_order = rm.rule_match_packed(qt, bounds, wk, crit,
                                    torch.argsort(qt[:, sort_col]))
    plain = rm.rule_match_packed(qt, bounds, wk, crit)
    for a, b, c in zip(by_col, by_order, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
