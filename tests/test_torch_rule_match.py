"""Port parity, rule-match kernel: the port's wrapper (its plain version on
CPU tensors) and ``match_rules`` against the Pallas kernel in interpret mode
and the JAX oracle, exactly. The CUDA kernel is held against its plain
version in test_torch_gpu.py."""
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
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rule_match as rm  # noqa: E402

SHAPES = [(64, 128, 8, 64, 128), (128, 256, 26, 64, 128),
          (256, 512, 31, 256, 512), (32, 512, 3, 32, 256),
          (512, 128, 13, 128, 128)]


def _random_tables(rng, B, R, C, weight_max=100):
    q = rng.integers(0, 50, (B, C)).astype(np.int32)
    mins = rng.integers(0, 50, (R, C)).astype(np.int32)
    widths = rng.integers(0, 30, (R, C)).astype(np.int32)
    maxs = mins + widths
    wild = rng.random((R, C)) < 0.5
    mins = np.where(wild, 0, mins).astype(np.int32)
    maxs = np.where(wild, np.iinfo(np.int32).max - 1, maxs).astype(np.int32)
    w = rng.integers(0, weight_max, (R,)).astype(np.int32)
    return q, mins, maxs, w


def _port(q, mins, maxs, w, tb, tr, device="cpu"):
    t = [torch.as_tensor(a, device=device) for a in (q.T, mins.T, maxs.T,
                                                     w[None])]
    bw, bi = rm.rule_match(*(x.contiguous() for x in t), tile_b=tb, tile_r=tr)
    return bw.cpu().numpy(), bi.cpu().numpy()


def _pallas(q, mins, maxs, w, tb, tr):
    bw, bi = rule_match_pallas(jnp.asarray(q.T), jnp.asarray(mins.T),
                               jnp.asarray(maxs.T), jnp.asarray(w[None]),
                               tile_b=tb, tile_r=tr, interpret=True)
    return np.asarray(bw), np.asarray(bi)


@pytest.mark.parametrize("B,R,C,tb,tr", SHAPES)
def test_port_matches_pallas_and_oracle(B, R, C, tb, tr):
    rng = np.random.default_rng(B + R + C)
    q, mins, maxs, w = _random_tables(rng, B, R, C)
    pw, pi = _port(q, mins, maxs, w, tb, tr)
    kw, ki = _pallas(q, mins, maxs, w, tb, tr)
    rw, ri = j_ref(jnp.asarray(q), jnp.asarray(mins), jnp.asarray(maxs),
                   jnp.asarray(w))
    assert pw.dtype == pi.dtype == np.int32
    np.testing.assert_array_equal(pw, kw)
    np.testing.assert_array_equal(pi, ki)
    np.testing.assert_array_equal(pw[0], np.asarray(rw))
    np.testing.assert_array_equal(pi[0], np.asarray(ri))


@pytest.mark.parametrize("max_elems", [1, 64, 1 << 27])
def test_plain_version_chunking_is_invisible(monkeypatch, max_elems):
    """Rule chunks of any size give the unchunked answer, ties included."""
    monkeypatch.setattr(ref, "MAX_ELEMS", max_elems)
    rng = np.random.default_rng(5)
    q, mins, maxs, w = _random_tables(rng, 40, 300, 6, weight_max=4)
    got = ref.rule_match_ref(*(torch.as_tensor(a) for a in (q, mins, maxs, w)))
    rw, ri = j_ref(jnp.asarray(q), jnp.asarray(mins), jnp.asarray(maxs),
                   jnp.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(rw))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ri))


def _tie_case():
    C = 4
    return (np.zeros((8, C), np.int32), np.zeros((256, C), np.int32),
            np.full((256, C), 10, np.int32), np.full((256,), 7, np.int32))


def _no_match_case():
    C = 3
    return (np.full((16, C), 100, np.int32), np.zeros((64, C), np.int32),
            np.full((64, C), 5, np.int32), np.full((64,), 3, np.int32))


def test_tie_break_lowest_rule_index():
    q, mins, maxs, w = _tie_case()
    pw, pi = _port(q, mins, maxs, w, 8, 64)
    kw, ki = _pallas(q, mins, maxs, w, 8, 64)
    assert (pi == 0).all() and (pw == 7).all()
    np.testing.assert_array_equal(pi, ki)
    np.testing.assert_array_equal(pw, kw)


def test_no_match_returns_minus_one():
    q, mins, maxs, w = _no_match_case()
    pw, pi = _port(q, mins, maxs, w, 16, 64)
    kw, ki = _pallas(q, mins, maxs, w, 16, 64)
    assert (pw == -1).all() and (pi == -1).all()
    np.testing.assert_array_equal(pw, kw)
    np.testing.assert_array_equal(pi, ki)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 97), st.integers(1, 130), st.integers(1, 12),
       st.integers(0, 2**31 - 1))
def test_property_match_semantics(B, R, C, seed):
    """With padding, the port's wrapper equals brute-force numpy and the JAX
    oracle."""
    rng = np.random.default_rng(seed)
    q, mins, maxs, w = _random_tables(rng, B, R, C)
    ok = (q[:, None, :] >= mins[None]) & (q[:, None, :] <= maxs[None])
    score = np.where(ok.all(-1), w[None, :], -1)
    exp_w = score.max(1)
    exp_i = np.where(exp_w >= 0, score.argmax(1), -1)

    qp = ops._pad_to(torch.as_tensor(q.T), 32, 1, 0)
    mp = ops._pad_to(torch.as_tensor(mins.T), 64, 1, 1)
    xp = ops._pad_to(torch.as_tensor(maxs.T), 64, 1, 0)
    wp = ops._pad_to(torch.as_tensor(w[None]), 64, 1, -1)
    bw, bi = rm.rule_match(qp, mp, xp, wp, tile_b=32, tile_r=64)
    np.testing.assert_array_equal(bw[0].numpy()[:B], exp_w)
    np.testing.assert_array_equal(bi[0].numpy()[:B], exp_i)
    rw, ri = j_ref(jnp.asarray(q), jnp.asarray(mins), jnp.asarray(maxs),
                   jnp.asarray(w))
    np.testing.assert_array_equal(bw[0].numpy()[:B], np.asarray(rw))
    np.testing.assert_array_equal(bi[0].numpy()[:B], np.asarray(ri))


@pytest.fixture(scope="module")
def lanes_setup():
    rs = j_rules(200, version=1, seed=9)
    t = j_compile(rs)
    enc = j_encode(t, j_queries(rs, 128, seed=4))
    return t, enc


@pytest.mark.parametrize("n_engines", [1, 2, 4])
def test_match_rules_lanes_equal_jax(lanes_setup, n_engines):
    t, enc = lanes_setup
    jd = j_ops.device_table(t, tile_r=128)
    want = j_ops.match_rules(jnp.asarray(enc), jd, tile_b=32, tile_r=128,
                             n_engines=n_engines)
    dt = ops.device_table(t, tile_r=128, device="cpu")
    got = ops.match_rules(torch.as_tensor(enc), dt, n_engines=n_engines)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("tile_r,max_block", [(128, None), (64, 40)])
def test_device_table_padding_contract(lanes_setup, tile_r, max_block):
    """Padding and partition blocks equal the reference's, array for array."""
    t, _ = lanes_setup
    jd = j_ops.device_table(t, tile_r=tile_r, partitioned=True,
                            max_block=max_block)
    dt = ops.device_table(t, tile_r=tile_r, partitioned=True,
                          max_block=max_block, device="cpu")
    for name in ("mins_t", "maxs_t", "weights", "decisions", "rule_ids",
                 "part_mins", "part_maxs", "part_w", "part_rows"):
        got, want = getattr(dt, name), np.asarray(getattr(jd, name))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert (dt.n_rules, dt.partition_col) == (jd.n_rules, jd.partition_col)


@pytest.mark.parametrize("max_gather_bytes", [1, 1 << 30])
def test_match_rules_partitioned_equal_jax(monkeypatch, lanes_setup,
                                           max_gather_bytes):
    monkeypatch.setattr(ops, "MAX_GATHER_BYTES", max_gather_bytes)
    t, enc = lanes_setup
    want = j_ops.match_rules_partitioned(
        jnp.asarray(enc), j_ops.device_table(t, tile_r=128, partitioned=True))
    dt = ops.device_table(t, tile_r=128, partitioned=True, device="cpu")
    got = ops.match_rules_partitioned(torch.as_tensor(enc), dt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_wrapper_rejects_bad_inputs():
    q, mins, maxs, w = (torch.as_tensor(a) for a in _tie_case())
    args = (q.T.contiguous(), mins.T.contiguous(), maxs.T.contiguous(),
            w[None])
    with pytest.raises(ValueError):
        rm.rule_match(*args, tile_b=3, tile_r=64)
    with pytest.raises(TypeError):
        rm.rule_match(args[0].long(), *args[1:], tile_b=8, tile_r=64)
    with pytest.raises(ValueError):
        ops.match_rules(q, None, backend="pallas")


def test_wrapper_never_falls_back_off_the_cpu(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises; it never calls
    the plain version."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(rm.ref_mod, "rule_match_ref", forbidden)
    q, mins, maxs, w = (torch.as_tensor(a).to("meta") for a in _tie_case())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rm.rule_match(q.T, mins.T, maxs.T, w[None], tile_b=8, tile_r=64)
