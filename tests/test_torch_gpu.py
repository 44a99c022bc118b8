"""The CUDA rule-match kernel against its plain PyTorch version on the card.

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
from repro_torch.kernels.ref import rule_match_ref

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
    for kw in (dict(tile_b=64, tile_r=128, n_engines=n_engines),
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
    dt = ops.device_table(compile_rules(generate_rules(50, version=2, seed=0)),
                          tile_r=64, device=dev)
    with pytest.raises(ValueError, match="criteria"):
        ops.match_rules(torch.zeros((64, 31), dtype=torch.int32, device=dev),
                        dt, tile_b=2048, tile_r=64)
