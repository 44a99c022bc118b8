"""Falcon-H1 (``falcon-h1-34b``), a port-only arch, against the benchmark's
plain reference ``bench/reference/falcon_h1.py`` at a small size on the CPU
in float32: d_model 256, 4 query and 2 KV heads of 64, a Mamba-2 mixer of
4 heads x 32 with state 16 in 2 groups and chunks of 8, 4 layers, vocab
512, the published muP multipliers and an attention input multiplier of
0.8. The norms' weights are drawn off 1, so that the reference's reading
of the port's parameters is tested too. Float32 rounding is all that may
differ: logits within 1e-4 of the largest.

Also: the chunked SSD against the plain recurrence, the ragged prefill
(each row equal to itself alone, and several passes at their offsets and
cache rows equal to one), the model's length-sorted prefill groups
(``decode.prefill_prompts``: the split against a brute-force search, the
result against one pass, in the caller's row order), ``LMServer`` behind a
2,000-rule filter, its spans and counters, the published parameter counts,
and the reference against transformers' ``FalconH1ForCausalLM`` where
transformers is installed.
"""
import dataclasses
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import falcon_h1 as ref  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ASSIGNED_ARCHS, PORT_ONLY_ARCHS, get_config)
from repro_torch.configs.falcon_h1_34b import (CONFIG, PUBLISHED,  # noqa: E402
                                               from_hf)
from repro_torch.models import decode, mamba2  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

SMALL = dict(PUBLISHED, hidden_size=256, num_attention_heads=4,
             num_key_value_heads=2, head_dim=64, intermediate_size=512,
             vocab_size=512, num_hidden_layers=4, mamba_n_heads=4,
             mamba_d_head=32, mamba_d_ssm=128, mamba_d_state=16,
             mamba_n_groups=2, mamba_chunk_size=8,
             attention_in_multiplier=0.8)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return dataclasses.replace(from_hf(SMALL), dtype="float32",
                               param_dtype="float32")


@pytest.fixture(scope="module")
def small():
    cfg = _cfg()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    for blk in params["blocks"][0]:
        for t in (blk["norm1"]["w"], blk["norm2"]["w"],
                  blk["mamba2"]["norm_w"]):
            t += 0.2 * torch.randn(t.shape, generator=g)
    params["norm_f"]["w"] += 0.2 * torch.randn(
        params["norm_f"]["w"].shape, generator=g)
    return cfg, model, params


def _ref_logits(params, tokens):
    with torch.no_grad():
        return ref.forward(ref.from_port(params), torch.as_tensor(tokens),
                           SMALL)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_forward_matches_reference(small):
    cfg, model, params = small
    tok = torch.randint(0, 512, (2, 37), generator=torch.Generator()
                        .manual_seed(2))
    with torch.no_grad():
        mine = model.logits(params, {"tokens": tok})
    for b in range(2):
        assert _rel(mine[b], _ref_logits(params, tok[b])) < TOL


@pytest.mark.parametrize("T", [1, 7, 8, 9, 37])
def test_chunked_ssd_is_the_recurrence(T):
    g = torch.Generator().manual_seed(T)
    b, H, P, G, N = 2, 4, 8, 2, 6
    x = torch.randn(b, T, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, T, H, generator=g))
    A = -torch.arange(1, H + 1, dtype=torch.float32) * 0.3
    B = torch.randn(b, T, G, N, generator=g)
    C = torch.randn(b, T, G, N, generator=g)
    y, h = mamba2.ssd_chunked(x, dt, A, B, C, chunk=8)
    y0, h0 = mamba2.ssd_sequential(x, dt, A, B, C)
    assert _rel(y, y0) < 1e-5
    assert _rel(h, h0) < 1e-5


def _generate(model, params, rows, n_new, max_seq=64):
    """Ragged prefill of ``rows`` (lists of ids) and ``n_new`` greedy steps
    through the cache: per row, its tokens and logits (n_new, V)."""
    P = max(len(r) for r in rows)
    left = torch.zeros(len(rows), P, dtype=torch.long)
    start = torch.tensor([P - len(r) for r in rows])
    for i, r in enumerate(rows):
        left[i, P - len(r):] = torch.as_tensor(r)
    with torch.no_grad():
        cache = model.init_cache(len(rows), max_seq, device="cpu")
        lg, cache = decode.prefill_ragged(params, cache, left, start,
                                          model.cfg)
        out = [lg[:, 0]]
        cur = lg[:, 0].argmax(-1)
        toks = [cur]
        for s in range(n_new - 1):
            lg, cache = model.decode_step(params, cache, cur[:, None], P + s)
            out.append(lg[:, 0])
            cur = lg[:, 0].argmax(-1)
            toks.append(cur)
    return torch.stack(toks, 1), torch.stack(out, 1)


def test_prefill_and_decode_match_reference(small):
    cfg, model, params = small
    prompt = list(np.random.default_rng(3).integers(0, 512, 19))
    toks, logits = _generate(model, params, [prompt], 9)
    seq = prompt + toks[0, :-1].tolist()
    want = _ref_logits(params, seq)[len(prompt) - 1:]
    assert want.shape == logits[0].shape
    assert _rel(logits[0], want) < TOL


def test_ragged_rows_equal_alone(small):
    cfg, model, params = small
    rng = np.random.default_rng(4)
    rows = [list(rng.integers(0, 512, n)) for n in (1, 5, 17, 33)]
    toks, logits = _generate(model, params, rows, 4)
    for i, r in enumerate(rows):
        t1, l1 = _generate(model, params, [r], 4)
        assert torch.equal(toks[i], t1[0])
        assert _rel(logits[i], l1[0]) < 1e-5


def _left(rows):
    """Rows left-padded to the longest: (tokens (B, P), start (B,))."""
    P = max(len(r) for r in rows)
    left = torch.zeros(len(rows), P, dtype=torch.long)
    for i, r in enumerate(rows):
        left[i, P - len(r):] = torch.as_tensor(r)
    return left, torch.tensor([P - len(r) for r in rows])


def test_prefill_ragged_groups_at_offsets_equal_one_pass(small):
    cfg, model, params = small
    rng = np.random.default_rng(6)
    lens = (9, 2, 33, 5, 17, 9, 26)
    rows = [list(rng.integers(0, 512, n)) for n in lens]
    left, start = _left(rows)
    P = left.shape[1]
    order = torch.tensor(sorted(range(len(lens)), key=lens.__getitem__))
    s = sorted(lens)
    with torch.no_grad():
        one = model.init_cache(len(rows), 48, device="cpu")
        want, one = decode.prefill_ragged(params, one, left, start, cfg)
        split = model.init_cache(len(rows), 48, device="cpu")
        got = torch.empty_like(want)
        for r0, r1 in [(4, 7), (0, 2), (2, 4)]:
            off = P - s[r1 - 1]
            idx = order[r0:r1]
            lg, _ = decode.prefill_ragged(
                params, split, left[idx, off:], start[idx] - off, cfg,
                offset=off, rows=idx)
            got[idx] = lg
    assert _rel(got, want) < 1e-5
    assert torch.equal(split["start"], one["start"])
    assert torch.equal(split["start"], start)
    for a, b in zip(split["runs"], one["runs"]):
        for i, n in enumerate(lens):
            # the keys and values of the row's own tokens, where one pass
            # puts them; the padding before them is masked in decode
            for k in ("k", "v"):
                assert _rel(a[k][:, i, P - n:P], b[k][:, i, P - n:P]) < 1e-5
                assert not a[k][:, i, P:].any()
        for k in ("mamba_conv", "mamba_h"):
            assert _rel(a[k], b[k]) < 1e-5


def test_prefill_prompts_keeps_the_callers_row_order(small, monkeypatch):
    cfg, model, params = small
    monkeypatch.setattr(decode, "PASS_COST_TOKENS", 0.0)
    rng = np.random.default_rng(8)
    lens = [14, 3, 27, 8, 3, 19]
    rows = [list(rng.integers(1, 512, n)) for n in lens]
    left, start = _left(rows)
    P = left.shape[1]
    toks = np.zeros((len(rows), P), np.int32)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r
    with torch.no_grad():
        one = model.init_cache(len(rows), 40, device="cpu")
        want, one = decode.prefill_ragged(params, one, left, start, cfg)
        cache = model.init_cache(len(rows), 40, device="cpu")
        got, passes, computed = model.prefill_prompts(params, cache, toks,
                                                      lens)
    assert passes == len(set(lens)) and computed == sum(lens)
    assert got.shape == want.shape
    for i, n in enumerate(lens):
        assert _rel(got[i], want[i]) < 1e-5
        assert int(cache["start"][i]) == P - n == int(one["start"][i])
    for a, b in zip(cache["runs"], one["runs"]):
        for i, n in enumerate(lens):
            for k in ("k", "v"):
                assert _rel(a[k][:, i, P - n:P], b[k][:, i, P - n:P]) < 1e-5
            for k in ("mamba_conv", "mamba_h"):
                assert _rel(a[k][:, i], b[k][:, i]) < 1e-5


def _brute_force_cost(lens, cost):
    n = len(lens)
    best = float("inf")
    for cuts in itertools.product((False, True), repeat=n - 1):
        ends = [i + 1 for i, c in enumerate(cuts) if c] + [n]
        total, r0 = 0.0, 0
        for r1 in ends:
            total += (r1 - r0) * lens[r1 - 1] + cost
            r0 = r1
        best = min(best, total)
    return best


@pytest.mark.parametrize("n", range(1, 9))
def test_prefill_groups_is_the_best_contiguous_split(n):
    rng = np.random.default_rng(n)
    for cost in (0.0, 7.0, 60.0, decode.PASS_COST_TOKENS):
        for _ in range(6):
            lens = sorted(int(x) for x in np.exp(
                rng.uniform(np.log(32), np.log(384), n)))
            groups = decode.prefill_groups(lens, cost)
            assert groups[0][0] == 0 and groups[-1][1] == n
            assert all(a[1] == b[0] and a[0] < a[1]
                       for a, b in zip(groups, groups[1:] + [(n, n + 1)]))
            got = sum((r1 - r0) * lens[r1 - 1] + cost for r0, r1 in groups)
            assert got == pytest.approx(_brute_force_cost(lens, cost))


@pytest.mark.parametrize("cost", [0.0, 295.0])
def test_prefill_groups_equal_lengths_one_group(cost):
    assert decode.prefill_groups([7] * 5, cost) == [(0, 5)]
    assert decode.prefill_groups([3], cost) == [(0, 1)]
    # a pass costs at least its weight read
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS
    assert decode.PASS_COST_TOKENS >= PEAK_FLOPS / HBM_BW


def _serve_batch(cfg, params, monkeypatch, cost, lens):
    from repro_torch.serve import LMServer, Request
    from repro_torch.serve.trace import Tracer
    monkeypatch.setattr(decode, "PASS_COST_TOKENS", cost)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=10 + i, tokens=rng.integers(1, 512, n).astype(
        np.int32), max_new_tokens=3 + i % 3, capture=True)
        for i, n in enumerate(lens)]
    tr = Tracer()
    srv = LMServer(cfg, params, device="cpu", max_seq=48, tracer=tr)
    outs = srv.generate_batch(reqs)
    return srv, outs, [s for s in tr.spans() if s.stage == "lm.prefill"]


def test_run_decode_in_groups_equals_one_pass(small, monkeypatch):
    cfg, model, params = small
    lens = [21, 4, 30, 9, 4, 16, 27]
    srv1, one, _ = _serve_batch(cfg, params, monkeypatch, 1e9, lens)
    srv, split, _ = _serve_batch(cfg, params, monkeypatch, 0.0, lens)
    assert srv1.n_prefill_passes == 1
    assert srv.n_prefill_passes == len(set(lens)) >= 2
    assert [c.rid for c in split] == [c.rid for c in one] == \
        [10 + i for i in range(len(lens))]
    for a, b in zip(split, one):
        assert a.tokens.tolist() == b.tokens.tolist()
        assert len(a.tokens) == 3 + (a.rid - 10) % 3
        got = srv.captured[a.rid]["logits"]
        want = srv1.captured[a.rid]["logits"]
        assert got.shape == want.shape
        assert _rel(torch.as_tensor(got), torch.as_tensor(want)) < 1e-5


def test_prefill_counts_and_span_follow_the_split(small, monkeypatch):
    cfg, model, params = small
    lens = [12, 3, 12, 30, 5, 29]
    srv, outs, spans = _serve_batch(cfg, params, monkeypatch, 10.0, lens)
    s = sorted(lens)
    groups = decode.prefill_groups(s, 10.0)
    assert len(groups) >= 2
    computed = sum((r1 - r0) * s[r1 - 1] for r0, r1 in groups)
    assert srv.prefill_counts() == (sum(lens), computed - sum(lens))
    assert srv.n_prefill_passes == len(groups)
    (p,) = spans
    assert p.meta["rows"] == len(lens) and p.meta["lens"] == lens
    assert p.meta["real_tokens"] == sum(lens)
    assert p.meta["padded_tokens"] == computed - sum(lens)
    assert p.meta["passes"] == len(groups)
    assert computed < len(lens) * max(lens)


@pytest.fixture(scope="module")
def rule_filter():
    from repro_torch.core.compiler import compile_rules
    from repro_torch.core.engine import ErbiumEngine
    from repro_torch.core.rules import generate_queries, generate_rules
    rs = generate_rules(2_000, version=2, seed=3)
    table = compile_rules(rs)
    return ErbiumEngine(table, device="cpu"), table, \
        generate_queries(rs, 48, seed=5)


def _requests(table, queries, n=8, capture=()):
    """n requests of 3-21 prompt tokens, 4 new tokens, 2-4 MCT queries;
    about half with one connection shorter than its MCT. Returns them and
    the rids ``cpu_match_numpy``'s decisions make infeasible."""
    from repro_torch.core.encoder import encode_queries
    from repro_torch.core.engine import cpu_match_numpy
    from repro_torch.serve import Request
    rng = np.random.default_rng(11)
    out, drop = [], set()
    for i in range(n):
        qs = [queries[j] for j in rng.integers(0, len(queries),
                                               int(rng.integers(2, 5)))]
        dec = cpu_match_numpy(table, encode_queries(table, qs))[0]
        have = np.where(dec >= 0, dec, table.default_decision) + 30
        if rng.random() < 0.5:
            have[rng.integers(0, len(qs))] = 0
            drop.add(i)
        out.append(Request(rid=i, tokens=rng.integers(1, 512, int(
            rng.integers(3, 22))).astype(np.int32), max_new_tokens=4,
            arrival=i * 0.002, mct_queries=qs,
            connect_minutes=[int(x) for x in have], capture=i in capture))
    return out, drop


def test_lmserver_behind_filter_matches_reference(small, rule_filter):
    from repro_torch.serve import ServeConfig, build
    cfg, model, params = small
    engine, table, queries = rule_filter
    reqs, drop = _requests(table, queries, capture=(0, 1, 2, 3))
    srv = build(ServeConfig(model=cfg, reduced=False, device="cpu",
                            max_seq=32, target_batch=4, deadline=0.005,
                            rule_filter=engine))
    srv.engine.params = params
    with srv:
        outs = {c.rid: c for c in srv.serve(reqs, mode="sync")}
    assert set(outs) == {r.rid for r in reqs} - drop
    for r in reqs:
        if r.rid in outs:
            seq = list(r.tokens) + outs[r.rid].tokens[:-1].tolist()
            want = _ref_logits(params, seq)[len(r.tokens) - 1:]
            assert outs[r.rid].tokens.tolist() == \
                want.argmax(-1).tolist()
            if r.capture:
                got = srv.engine.captured[r.rid]["logits"]
                assert _rel(torch.as_tensor(got), want) < TOL
        if r.capture:
            dec = srv.engine.captured[r.rid]["mct"][0]
            assert len(dec) == len(r.mct_queries)


def test_lm_spans_tile_execute_and_count(small, rule_filter):
    import time

    from repro_torch.serve import LMServer
    from repro_torch.serve.trace import LIFECYCLE_STAGES, Tracer, \
        chrome_events
    cfg, model, params = small
    engine, table, queries = rule_filter
    reqs, drop = _requests(table, queries, n=6)
    tr = Tracer()
    srv = LMServer(cfg, params, device="cpu", max_seq=32,
                   rule_filter=engine, tracer=tr)
    pb = srv.prepare_batch(reqs)
    t0 = time.perf_counter()
    outs = srv.execute_prepared(pb)
    t1 = time.perf_counter()
    spans = [s for s in tr.spans() if s.stage.startswith("lm.")]
    assert [s.stage for s in spans] == \
        ["lm.filter", "lm.prefill"] + ["lm.decode"] * 3
    assert all(s.stage in LIFECYCLE_STAGES for s in spans)
    assert t0 <= spans[0].t0 and spans[-1].t1 <= t1
    for a, b in zip(spans, spans[1:]):
        assert a.t1 == b.t0
    assert spans[-1].t1 - spans[0].t0 >= 0.9 * (t1 - t0)
    kept = [r for r in reqs if r.rid not in drop]
    f, p = spans[0].meta, spans[1].meta
    assert f["queries"] == sum(len(r.mct_queries) for r in reqs)
    assert f["dropped"] == len(drop)
    lens = [len(r.tokens) for r in kept]
    # the ragged prefill pads no rows, only each row to the longest prompt
    assert p["rows"] == len(kept) and p["lens"] == lens
    assert p["real_tokens"] == sum(lens)
    assert p["padded_tokens"] == len(kept) * max(lens) - sum(lens)
    assert srv.prefill_counts() == (p["real_tokens"], p["padded_tokens"])
    assert [s.meta["pos"] for s in spans[2:]] == \
        [max(lens) + k for k in range(3)]
    assert len({s.meta["batch"] for s in spans}) == 1
    assert len(outs) == len(kept)
    lanes = {e["tid"] for e in chrome_events(spans) if e["ph"] == "X"}
    assert len(lanes) == 1


@pytest.mark.parametrize("layers,want", [(72, 33_642_516_224),
                                         (36, 18_158_195_072)])
def test_published_parameter_count(layers, want):
    cfg = dataclasses.replace(CONFIG, n_layers=layers)
    assert cfg.n_params() == want
    tree = build_model(cfg).init(device="meta")

    def numel(t):
        if isinstance(t, dict):
            return sum(numel(v) for v in t.values())
        if isinstance(t, list):
            return sum(numel(v) for v in t)
        return t.numel()
    assert numel(tree) == want


def test_config_lists_and_published_values():
    assert "falcon-h1-34b" in PORT_ONLY_ARCHS
    assert "falcon-h1-34b" not in ASSIGNED_ARCHS
    assert get_config("falcon-h1-34b") == CONFIG == from_hf(PUBLISHED)
    c = CONFIG
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab) == (72, 5120, 20, 4, 128, 21504, 261120)
    m = c.mamba2
    assert (m.n_heads, m.head_dim, m.n_groups, m.state_dim, m.conv_width,
            m.chunk, m.conv_dim) == (32, 128, 2, 256, 4, 128, 5120)
    struct = build_model(dataclasses.replace(c, n_layers=36)).cache_struct(
        2, 512)
    run = struct["runs"][0]
    assert tuple(run["mamba_conv"].shape) == (36, 2, 3, 5120)
    assert tuple(run["mamba_h"].shape) == (36, 2, 32, 128, 256)
    assert run["mamba_h"].dtype == torch.float32
    r = c.reduced()
    assert (r.d_model, r.mamba2.n_heads, r.mamba2.chunk) == (256, 4, 8)
    with pytest.raises(ValueError, match="not supported"):
        from_hf(dict(PUBLISHED, mlp_bias=True))


def _hf_weights(sd, n_layers):
    """transformers' state dict in the reference's layout."""
    def lin(t):
        return t.T.contiguous()
    layers = []
    for i in range(n_layers):
        p = f"model.layers.{i}."
        layers.append({
            "input_norm": sd[p + "input_layernorm.weight"],
            "pre_ff_norm": sd[p + "pre_ff_layernorm.weight"],
            "attn": {k: lin(sd[p + f"self_attn.{k}_proj.weight"])
                     for k in "qkvo"},
            "mamba": {"in_proj": lin(sd[p + "mamba.in_proj.weight"]),
                      "conv_w": sd[p + "mamba.conv1d.weight"][:, 0],
                      "conv_b": sd[p + "mamba.conv1d.bias"],
                      "dt_bias": sd[p + "mamba.dt_bias"],
                      "A_log": sd[p + "mamba.A_log"],
                      "D": sd[p + "mamba.D"],
                      "norm": sd[p + "mamba.norm.weight"],
                      "out_proj": lin(sd[p + "mamba.out_proj.weight"])},
            "mlp": {"gate": lin(sd[p + "feed_forward.gate_proj.weight"]),
                    "up": lin(sd[p + "feed_forward.up_proj.weight"]),
                    "down": lin(sd[p + "feed_forward.down_proj.weight"])}})
    return {"embed": sd["model.embed_tokens.weight"],
            "unembed": sd["lm_head.weight"],
            "final_norm": sd["model.final_layernorm.weight"],
            "layers": layers}


def test_reference_is_transformers_falcon_h1():
    transformers = pytest.importorskip("transformers")
    hf = dict(SMALL, hidden_size=64, head_dim=16, intermediate_size=96,
              vocab_size=128, num_hidden_layers=2, mamba_d_head=8,
              mamba_d_ssm=32, mamba_d_state=8, mamba_chunk_size=4)
    conf = transformers.FalconH1Config(
        **{k: v for k, v in hf.items() if k != "model_type"},
        attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.FalconH1ForCausalLM(conf).eval()
    sd = model.state_dict()
    g = torch.Generator().manual_seed(5)
    for k, t in sd.items():
        noise = torch.randn(t.shape, generator=g)
        if "norm" in k or k.endswith(".D"):
            t.copy_(1.0 + 0.2 * noise)
        else:
            t.copy_(0.3 * noise)
    tok = torch.randint(0, 128, (11,), generator=g)
    with torch.no_grad():
        want = model(tok[None], logits_to_keep=0).logits[0]
        got = ref.forward(_hf_weights(sd, 2), tok, hf)
    assert _rel(got, want) < 1e-5
