"""The decode step with its position as a device tensor, and the decoders
a server keeps per device (``models/decode.py``: ``decoder``,
``EagerDecoder``, ``GraphDecoder``).

On the CPU: ``decode_step`` with ``pos`` a 0-d int64 tensor gives logits
and cache bit for bit equal to ``pos`` an int (the small Falcon-H1 of
``tests/test_torch_falcon_h1.py`` after a ragged prefill, and two reference
archs, ``gemma3-1b`` with a sliding window shorter than the decode);
``GraphDecoder``, run uncaptured, serves successive batches of other row
counts and prompt lengths through its one kept cache exactly as a fresh
``init_cache`` and eager ``decode_step`` serve each alone; ``LMServer``'s
``decode_counts`` and the ``lm.decode`` spans' ``graph`` count what ran.

Marked ``gpu`` (skipped without a card): on a reduced bf16 Falcon-H1 on
the card, the captured path against the eager one over batches of 5, 16
and 23 rows, and a batch above every warmed bucket capturing its own.
This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_decode_graph.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.configs.falcon_h1_34b import PUBLISHED, from_hf
from repro_torch.models import decode
from repro_torch.models.registry import build_model
from repro_torch.serve import LMServer, Request
from repro_torch.serve.trace import Tracer

SMALL = dict(PUBLISHED, hidden_size=256, num_attention_heads=4,
             num_key_value_heads=2, head_dim=64, intermediate_size=512,
             vocab_size=512, num_hidden_layers=4, mamba_n_heads=4,
             mamba_d_head=32, mamba_d_ssm=128, mamba_d_state=16,
             mamba_n_groups=2, mamba_chunk_size=8,
             attention_in_multiplier=0.8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _falcon(dtype="float32"):
    return dataclasses.replace(from_hf(SMALL), dtype=dtype,
                               param_dtype=dtype)


def _model(cfg, device="cpu", seed=0):
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return model, model.init(gen, device=device)


CONFIGS = {
    "falcon-h1-small": _falcon,
    "llama3.2-3b": lambda: dataclasses.replace(
        get_config("llama3.2-3b").reduced(), dtype="float32",
        param_dtype="float32"),
    # windowed layers of 6 beside a global one, shorter than the decode
    "gemma3-1b": lambda: dataclasses.replace(
        get_config("gemma3-1b").reduced(), dtype="float32",
        param_dtype="float32", attn_pattern=(6, 0)),
}


def _prompts(rng, lens, vocab):
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, vocab, n)
    return toks


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_tensor_pos_equals_int_pos_bit_for_bit(arch):
    cfg = CONFIGS[arch]()
    model, params = _model(cfg)
    rng = np.random.default_rng(1)
    lens = [3, 9, 6]
    toks = _prompts(rng, lens, cfg.vocab)
    with torch.inference_mode():
        cache = model.init_cache(len(lens), 24, device="cpu")
        last, _, _ = model.prefill_prompts(params, cache, toks, lens)
        other = copy.deepcopy(cache)
        cur = last[:, -1].argmax(-1)
        for pos in range(max(lens), max(lens) + 10):
            a, cache = model.decode_step(params, cache, cur[:, None], pos)
            b, other = model.decode_step(params, other, cur[:, None],
                                         torch.tensor(pos))
            assert torch.equal(a, b)
            cur = a[:, -1].argmax(-1)
    _equal_trees(cache, other)


def _eager_batch(model, params, toks, lens, steps, max_seq):
    """A fresh ``init_cache`` of the batch's rows, its prefill, and
    ``steps`` eager greedy steps with an int pos: (tokens (B, steps + 1),
    logits (B, steps + 1, V))."""
    dev = params["embed"].device
    with torch.inference_mode():
        cache = model.init_cache(len(lens), max_seq, device=dev)
        last, _, _ = model.prefill_prompts(params, cache, toks, lens)
        outs, cur = [last[:, -1]], last[:, -1].argmax(-1)
        got = [cur]
        for s in range(steps):
            lg, cache = model.decode_step(params, cache, cur[:, None],
                                          max(lens) + s)
            outs.append(lg[:, -1])
            cur = lg[:, -1].argmax(-1)
            got.append(cur)
    return torch.stack(got, 1), torch.stack(outs, 1)


def _decoder_batch(dec, model, params, toks, lens, steps):
    """The same batch through ``dec``: (tokens, logits, graphs a step)."""
    with torch.inference_mode(), dec.batch(len(lens)) as cache:
        last, _, _ = model.prefill_prompts(params, cache, toks, lens)
        outs, cur = [last[:, -1]], last[:, -1].argmax(-1)
        got, graphs = [cur], []
        for s in range(steps):
            lg, cur, g = dec.step(cache, cur, max(lens) + s)
            outs.append(lg[:, -1].clone())
            got.append(cur.clone())
            graphs.append(g)
    return torch.stack(got, 1), torch.stack(outs, 1), graphs


def _assert_same_batch(got_t, got_l, want_t, want_l):
    """Equal tokens; logits bit for bit where the batch fills its bucket,
    else within float32 rounding: the CPU's matrix products block their
    rows by the row count, so the padding rows can move a real row's
    rounding (by about 2e-6 here), never its values beyond that."""
    assert torch.equal(got_t, want_t)
    if got_t.shape[0] % decode.ROW_BUCKET == 0:
        assert torch.equal(got_l, want_l)
    else:
        err = (got_l - want_l).abs().max() / want_l.abs().max()
        assert float(err) < 1e-5


def test_graph_decoder_serves_batches_through_its_kept_cache():
    cfg = _falcon()
    model, params = _model(cfg)
    dec = decode.GraphDecoder(params, cfg, 40, torch.device("cpu"))
    dec.warm(9)
    assert dec.rows == 16 and dec.graphs == {} and dec.n_captures == 0
    rng = np.random.default_rng(2)
    # 13 rows (bucket 16), then 5 (bucket 8: rows the first batch wrote),
    # then 16 and 8, each with another longest prompt
    for lens in ([7, 3, 12, 5, 9, 1, 4, 11, 6, 2, 8, 10, 3],
                 [4, 17, 2, 9, 5],
                 [6, 2, 19, 3, 8, 1, 14, 5, 7, 9, 2, 11, 4, 13, 6, 3],
                 [3, 9, 1, 6, 2, 21, 4, 5]):
        toks = _prompts(rng, lens, cfg.vocab)
        want_t, want_l = _eager_batch(model, params, toks, lens, 6, 40)
        got_t, got_l, graphs = _decoder_batch(dec, model, params, toks,
                                              lens, 6)
        _assert_same_batch(got_t, got_l, want_t, want_l)
        assert graphs == [0] * 6
    assert dec.rows == 16 and dec.n_captures == 0
    # a batch above the kept cache grows it
    lens = list(range(1, 20))
    toks = _prompts(rng, lens, cfg.vocab)
    want_t, want_l = _eager_batch(model, params, toks, lens, 3, 40)
    got_t, got_l, _ = _decoder_batch(dec, model, params, toks, lens, 3)
    assert dec.rows == 24
    _assert_same_batch(got_t, got_l, want_t, want_l)


def test_decoder_choice():
    cfg = _falcon()
    model, params = _model(cfg)
    assert isinstance(model.decoder(params, 16, "cpu"), decode.EagerDecoder)
    llama = CONFIGS["llama3.2-3b"]()
    m2, p2 = _model(llama)
    assert isinstance(m2.decoder(p2, 16, "cpu"), decode.EagerDecoder)


class _Replay:
    def __init__(self, fn):
        self.replay = fn


class _CPUGraphs(decode.GraphDecoder):
    """A stand-in for the card: each bucket's "graph" replays the step
    eagerly into its static logits, so that the counters see replays and
    captures on the CPU."""

    def _ready(self, b):
        if b not in self.graphs:
            logits = self._step(b)
            self.graphs[b] = (_Replay(lambda: logits.copy_(self._step(b))),
                              logits)
            self.n_captures += 1


def _requests(rng, lens, vocab, rid0):
    return [Request(rid=rid0 + i, tokens=rng.integers(1, vocab, n).astype(
        np.int32), max_new_tokens=3 + i % 3, capture=True)
        for i, n in enumerate(lens)]


def test_decode_counts_and_spans_count_what_ran():
    cfg = _falcon()
    _, params = _model(cfg)
    batches = ([9, 4, 13, 2, 7], [5, 11, 3, 8, 6, 2, 10, 4, 9, 12, 1, 7, 3],
               list(range(2, 21)))
    runs = {}
    for name, dec in (("eager", None),
                      ("graphs", lambda p, m, d: _CPUGraphs(p, cfg, m, d))):
        tr = Tracer()
        srv = LMServer(cfg, params, device="cpu", max_seq=48, tracer=tr)
        if dec is not None:
            srv.model = srv.model._replace(decoder=dec)
        srv.warmup((16,), prompt_len=5, max_new_tokens=2)
        warm = srv.decode_counts()
        rng = np.random.default_rng(3)
        outs = [srv.generate_batch(_requests(rng, lens, cfg.vocab, 100 * k))
                for k, lens in enumerate(batches)]
        spans = [s for s in tr.spans() if s.stage == "lm.decode"]
        runs[name] = (srv, warm, outs, spans)
    eager, graphs = runs["eager"], runs["graphs"]
    # the warm-up batch of 16 runs one step; each batch max_new - 1 = 4
    n_steps = 1 + 4 * len(batches)
    assert eager[1] == (0, 1, 0)
    assert eager[0].decode_counts() == (0, n_steps, 0)
    assert [s.meta["graph"] for s in eager[3]] == [0] * n_steps
    # buckets 8 and 16 captured at warm-up; the 19-row batch grows the
    # cache and captures 24
    assert graphs[1] == (1, 0, 2)
    assert graphs[0].decode_counts() == (n_steps, 0, 3)
    assert [s.meta["graph"] for s in graphs[3]] == \
        [16] + [8] * 4 + [16] * 4 + [24] * 4
    assert [s.meta["rows"] for s in graphs[3]] == \
        [16] + [len(b) for b in batches for _ in range(4)]
    for a, b in zip(eager[2], graphs[2]):
        for x, y in zip(a, b):
            assert x.rid == y.rid
            assert x.tokens.tolist() == y.tokens.tolist()
            want = eager[0].captured[x.rid]["logits"]
            got = graphs[0].captured[y.rid]["logits"]
            assert got.shape == want.shape
            assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs capture only there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_captured_decode_equals_eager_on_the_card(cuda_device):
    cfg = _falcon("bfloat16")
    model, params = _model(cfg, device=cuda_device)
    srv = LMServer(cfg, params, device=cuda_device, max_seq=48)
    srv.warmup((16,), prompt_len=5, max_new_tokens=2)
    assert srv.decode_counts() == (1, 0, 2)
    dec = srv._decoders[cuda_device]
    assert isinstance(dec, decode.GraphDecoder) and sorted(dec.graphs) == \
        [8, 16]
    rng = np.random.default_rng(4)
    for rows, captures in ((5, 2), (16, 2), (23, 3)):
        lens = [int(n) for n in rng.integers(2, 30, rows)]
        toks = _prompts(rng, lens, cfg.vocab)
        want_t, want_l = _eager_batch(model, params, toks, lens, 6, 48)
        got_t, got_l, graphs = _decoder_batch(dec, model, params, toks,
                                              lens, 6)
        assert graphs == [-(-rows // 8) * 8] * 6
        assert torch.equal(got_t, want_t)
        err = (got_l.float() - want_l.float()).abs().max()
        assert float(err / want_l.float().abs().max()) < 2e-2
        assert srv.decode_counts()[2] == captures
