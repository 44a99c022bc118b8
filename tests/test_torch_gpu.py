"""The CUDA rule-match kernel against its plain PyTorch versions on the card.

Marked ``gpu``: each test asks for the ``cuda_device`` fixture, which skips
with a reason where there is no card. This file imports neither JAX nor the
JAX package, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.compiler import compile_rules
from repro_torch.core.encoder import encode_queries
from repro_torch.core.engine import ErbiumEngine
from repro_torch.core.rules import generate_queries, generate_rules
from repro_torch.kernels import ops
from repro_torch.kernels import rule_match as rm
from repro_torch.kernels.ref import rule_match_packed_ref, rule_match_ref

SHAPES = [(64, 128, 8, 64, 128), (128, 256, 26, 64, 128),
          (256, 512, 31, 256, 512), (32, 512, 3, 32, 256),
          (512, 128, 13, 128, 128), (96, 384, 64, 32, 128),
          (4096, 160256, 31, 256, 512)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _random_tables(rng, B, R, C, weight_max=100):
    q = rng.integers(0, 50, (B, C)).astype(np.int32)
    mins = rng.integers(0, 50, (R, C)).astype(np.int32)
    maxs = mins + rng.integers(0, 30, (R, C)).astype(np.int32)
    wild = rng.random((R, C)) < 0.5
    mins = np.where(wild, 0, mins).astype(np.int32)
    maxs = np.where(wild, np.iinfo(np.int32).max - 1, maxs).astype(np.int32)
    w = rng.integers(0, weight_max, (R,)).astype(np.int32)
    return q, mins, maxs, w


def _kernel_and_plain(dev, q, mins, maxs, w, tb, tr):
    q, mins, maxs, w = (torch.as_tensor(a, device=dev)
                        for a in (q, mins, maxs, w))
    before = rm.rule_match.launches
    bw, bi = rm.rule_match(q.T.contiguous(), mins.T.contiguous(),
                           maxs.T.contiguous(), w[None], tile_b=tb, tile_r=tr)
    torch.cuda.synchronize(dev)
    assert rm.rule_match.launches == before + 1
    pw, pi = rule_match_ref(q, mins, maxs, w)
    return (bw[0].cpu().numpy(), bi[0].cpu().numpy(),
            pw.cpu().numpy(), pi.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("B,R,C,tb,tr", SHAPES)
def test_kernel_matches_plain(cuda_device, B, R, C, tb, tr):
    kw, ki, pw, pi = _kernel_and_plain(
        cuda_device, *_random_tables(np.random.default_rng(B + R + C),
                                     B, R, C), tb, tr)
    np.testing.assert_array_equal(kw, pw)
    np.testing.assert_array_equal(ki, pi)


@pytest.mark.gpu
def test_kernel_tie_break_and_no_match(cuda_device, monkeypatch):
    monkeypatch.setattr(rm.ref_mod, "rule_match_ref", None)  # never reached
    dev = cuda_device
    C = 4
    q = torch.zeros((C, 8), dtype=torch.int32, device=dev)
    mins = torch.zeros((C, 256), dtype=torch.int32, device=dev)
    maxs = torch.full((C, 256), 10, dtype=torch.int32, device=dev)
    w = torch.full((1, 256), 7, dtype=torch.int32, device=dev)
    bw, bi = rm.rule_match(q, mins, maxs, w, tile_b=8, tile_r=64)
    assert bool((bi == 0).all()) and bool((bw == 7).all())
    bw, bi = rm.rule_match(q + 100, mins, maxs, w, tile_b=8, tile_r=64)
    assert bool((bi == -1).all()) and bool((bw == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_engines", [1, 2, 4])
def test_engine_on_card_equals_plain(cuda_device, n_engines):
    rs = generate_rules(600, version=2, seed=11)
    t = compile_rules(rs)
    enc = encode_queries(t, generate_queries(rs, 256, seed=12))
    want = ErbiumEngine(t, device="cpu", backend="ref").match(enc)
    for kw in (dict(tile_r=128, n_engines=n_engines),
               dict(tile_r=128, partitioned=True)):
        got = ErbiumEngine(t, device=cuda_device, **kw).match(enc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    dev = cuda_device
    q = torch.zeros((65, 32), dtype=torch.int32, device=dev)
    r = torch.zeros((65, 64), dtype=torch.int32, device=dev)
    w = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="criteria"):
        rm.rule_match(q, r, r, w, tile_b=32, tile_r=64)
    C = 65
    r = torch.zeros((C, 64), dtype=torch.int32, device=dev)
    crit = torch.arange(C, dtype=torch.int32, device=dev)
    bounds, wk = rm.pack(r, r, r[0], crit)
    with pytest.raises(ValueError, match="criteria"):
        rm.rule_match_packed(torch.zeros((64, C), dtype=torch.int32,
                                         device=dev), bounds, wk, crit)


def _packed_case(dev, B, R, C, seed, weight_max=100):
    q, mins, maxs, w = (torch.as_tensor(a, device=dev) for a in _random_tables(
        np.random.default_rng(seed), B, R, C, weight_max))
    crit = rm.criterion_order(mins.T, maxs.T)
    bounds, wk = rm.pack(mins.T, maxs.T, w, crit)
    return q, mins, maxs, w, crit, bounds, wk


PACKED = ([(B, R, C) for B, R, C, _, _ in SHAPES]
          + [(300, 1000, 31), (256, 4102, 31), (77, 999, 13)]  # ragged R, B
          + [(9000, 3000, 31)]              # above SORT_MAX: argsort sorts
          + [(512, 3000, C) for C in (1, 8, 31, 32, 33, 64)])


@pytest.mark.gpu
@pytest.mark.parametrize("B,R,C", PACKED)
def test_packed_kernel_matches_plain(cuda_device, B, R, C):
    """The packed kernel, batch sorted in the launch or by a given order,
    against the packed plain version and rule_match_ref, exactly; stage
    width 64 does not divide R = 1000, 4102 or the padded 999; two queries
    a thread up to C = 32, one above."""
    q, mins, maxs, w, crit, bounds, wk = _packed_case(cuda_device, B, R, C,
                                                      B + R + C)
    lead = int(crit[0])
    pw, pi = rule_match_packed_ref(q, bounds, wk, crit)
    rw, ri = rule_match_ref(q, mins, maxs, w)
    for kw in (dict(sort_col=lead), dict(order=torch.argsort(q[:, lead]))):
        before = rm.rule_match.launches
        kw_, ki = rm.rule_match_packed(q, bounds, wk, crit, **kw)
        torch.cuda.synchronize(cuda_device)
        assert rm.rule_match.launches == before + 1
        for got, want in ((kw_, pw), (ki, pi), (kw_, rw), (ki, ri)):
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())


@pytest.mark.gpu
def test_packed_kernel_strided_queries_and_ties(cuda_device):
    """Queries read through strides (a transposed view), and identical rules
    in every run of rules: the lowest index wins everywhere."""
    dev = cuda_device
    q, mins, maxs, w, crit, bounds, wk = _packed_case(dev, 600, 20_000, 31, 5,
                                                      weight_max=3)
    qt = q.T.contiguous()
    kw, ki = rm.rule_match_packed(qt.T, bounds, wk, crit)
    rw, ri = rule_match_ref(q, mins, maxs, w)
    assert torch.equal(kw, rw) and torch.equal(ki, ri)
    C = 4
    zeros = torch.zeros((C, 10_000), dtype=torch.int32, device=dev)
    crit = torch.arange(C, dtype=torch.int32, device=dev)
    bounds, wk = rm.pack(zeros, zeros + 10, zeros[0] + 7, crit)
    bw, bi = rm.rule_match_packed(torch.zeros((300, C), dtype=torch.int32,
                                              device=dev), bounds, wk, crit)
    assert bool((bi == 0).all()) and bool((bw == 7).all())


@pytest.mark.gpu
def test_refused_launch_raises_and_never_falls_back(cuda_device, monkeypatch):
    """Past the wrapper's checks, a launch the library refuses (65 criteria)
    raises; neither plain version is called."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(rm.ref_mod, "rule_match_ref", forbidden)
    monkeypatch.setattr(rm.ref_mod, "rule_match_packed_ref", forbidden)
    monkeypatch.setattr(rm, "MAX_CRIT", 128)
    dev = cuda_device
    C = 65
    r = torch.zeros((C, 64), dtype=torch.int32, device=dev)
    crit = torch.arange(C, dtype=torch.int32, device=dev)
    bounds, wk = rm.pack(r, r, r[0], crit)
    before = rm.rule_match.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        rm.rule_match_packed(torch.zeros((32, C), dtype=torch.int32,
                                         device=dev), bounds, wk, crit)
    assert rm.rule_match.launches == before
