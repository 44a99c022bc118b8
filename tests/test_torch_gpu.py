"""The CUDA rule-match kernel against its plain PyTorch versions on the card,
the route scorer (``LMServer``, its MCT filter on the kernel) on the card
against the same server on the CPU, and the serving stack (``serve()`` with
two replicas on one card) against that server on the CPU.

Marked ``gpu``: each test asks for the ``cuda_device`` fixture, which skips
with a reason where there is no card. This file imports neither JAX nor the
JAX package, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.compiler import compile_rules
from repro_torch.core.encoder import encode_queries
from repro_torch.core.engine import ErbiumEngine
from repro_torch.core.rules import generate_queries, generate_rules
from repro_torch.kernels import ops
from repro_torch.kernels import rule_match as rm
from repro_torch.kernels.ref import rule_match_packed_ref, rule_match_ref
from repro_torch.models.registry import build_model
from repro_torch.serve import (LMServer, Request, ServeConfig, build,
                               form_batch_groups)

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


@pytest.fixture
def no_tf32():
    """float32 products in full float32 on the card (TF32 off)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


def _lm_servers(dev, filters=(None, None), **kw):
    """A 2-layer float32 reduced llama3.2-3b on the CPU and on the card,
    the same weights in both; ``filters``: their rule filters."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              n_layers=2, dtype="float32",
                              param_dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    return (LMServer(cfg, params, device="cpu", rule_filter=filters[0], **kw),
            LMServer(cfg, params, device=dev, rule_filter=filters[1], **kw))


@pytest.mark.gpu
def test_lm_server_on_card_equals_cpu(cuda_device, no_tf32):
    cpu, gpu = _lm_servers(cuda_device, max_seq=32)
    reqs = [Request(rid=0, tokens=np.asarray([3, 5, 7, 11, 2], np.int32),
                    max_new_tokens=6),
            Request(rid=1, tokens=np.asarray([9, 4], np.int32),
                    max_new_tokens=4),
            Request(rid=2, tokens=np.arange(1, 29, dtype=np.int32),
                    max_new_tokens=8)]      # hits max_seq: truncated
    want = cpu.generate_batch(reqs)
    got = gpu.generate_batch(reqs)
    assert [c.rid for c in got] == [c.rid for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.truncated == w.truncated
    # every row decodes from the longest prompt: rows 0 and 2 run out of room
    assert [c.truncated for c in got] == [True, False, True]
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cpu.cfg.vocab, (2, 12)), dtype=torch.long)
    lg_cpu = cpu.model.logits(cpu.params, {"tokens": toks})
    lg_gpu = gpu.model.logits(gpu._params_on(cuda_device),
                              {"tokens": toks.to(cuda_device)})
    torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_lm_server_rule_filter_launches_the_kernel(cuda_device, no_tf32):
    rs = generate_rules(150, version=2, seed=3)
    table = compile_rules(rs)
    cpu_eng = ErbiumEngine(table, device="cpu")
    gpu_eng = ErbiumEngine(table, device=cuda_device)
    qs = generate_queries(rs, 6, seed=5, match_bias=1.0)
    dec = cpu_eng.match_queries(qs)[0].numpy()
    mct = np.where(dec >= 0, dec, table.default_decision)
    reqs = [Request(rid=i, tokens=np.asarray([1 + i, 2, 3], np.int32),
                    max_new_tokens=3, mct_queries=[qs[2 * i], qs[2 * i + 1]],
                    connect_minutes=[int(mct[2 * i]) + 30,
                                     0 if i == 1 else int(mct[2 * i + 1])])
            for i in range(3)]
    cpu, gpu = _lm_servers(cuda_device, (cpu_eng, gpu_eng), max_seq=16)
    want = cpu.generate_batch(reqs)
    before = rm.rule_match.launches
    got = gpu.generate_batch(reqs)
    assert rm.rule_match.launches == before + 1
    assert [c.rid for c in got] == [c.rid for c in want] == [0, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.gpu
@pytest.mark.parametrize("topology", ["replicas", "devices"])
def test_serve_two_replicas_on_card_equal_cpu(cuda_device, no_tf32,
                                              topology):
    """serve() on the reduced float32 model with two replicas on one card
    (colocated, or pinned to two spellings of the card): pipelined tokens
    equal sync tokens equal the CPU server's, and the filter launches the
    kernel once a batch from the replica threads."""
    rs = generate_rules(150, version=2, seed=3)
    table = compile_rules(rs)
    cpu_eng = ErbiumEngine(table, device="cpu")
    gpu_eng = ErbiumEngine(table, device=cuda_device)
    qs = generate_queries(rs, 24, seed=5, match_bias=1.0)
    dec = cpu_eng.match_queries(qs)[0].numpy()
    mct = np.where(dec >= 0, dec, table.default_decision)
    reqs = [Request(rid=i, tokens=np.arange(1 + i, 4 + i + i % 5,
                                            dtype=np.int32),
                    max_new_tokens=3 + i % 3, arrival=i * 0.002,
                    mct_queries=[qs[2 * i], qs[2 * i + 1]],
                    connect_minutes=[int(mct[2 * i]) + 30,
                                     0 if i % 3 == 1 else int(mct[2 * i + 1])])
            for i in range(12)]
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype="float32", param_dtype="float32")
    topo = dict(replicas=2) if topology == "replicas" \
        else dict(devices=[cuda_device, "cuda"])
    srv = build(ServeConfig(model=cfg, reduced=False, device=cuda_device,
                            rule_filter=gpu_eng, max_seq=32, target_batch=4,
                            deadline=0.005, **topo))
    groups = form_batch_groups(reqs, target_batch=4, deadline=0.005)
    sync = {c.rid: c for c in srv.serve(reqs, mode="sync")}
    callers = []
    match = gpu_eng.match

    def counted(encoded):
        callers.append(threading.current_thread().name)
        return match(encoded)
    gpu_eng.match = counted
    before = rm.rule_match.launches
    pipe = {c.rid: c for c in srv.serve(reqs, mode="pipelined")}
    assert rm.rule_match.launches == before + len(groups)
    assert len(callers) == len(groups)
    assert threading.main_thread().name not in callers
    cpu = LMServer(cfg, srv.engine._params_on(torch.device("cpu")),
                   device="cpu", rule_filter=cpu_eng, max_seq=32)
    want = {c.rid: c for g in groups for c in cpu.generate_batch(g)}
    assert sorted(pipe) == sorted(sync) == sorted(want)
    assert {r.rid for r in reqs} - set(want) == {1, 4, 7, 10}
    for rid, w in want.items():
        np.testing.assert_array_equal(sync[rid].tokens, w.tokens)
        np.testing.assert_array_equal(pipe[rid].tokens, w.tokens)
        assert pipe[rid].batch_size == sync[rid].batch_size == w.batch_size
