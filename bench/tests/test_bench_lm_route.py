"""The route scorer's cell (``falcon-h1-route``) on the CPU at a tiny size:
a whole run is ``correct``, tied embeddings too; the float8 controls
(every weight matrix, the MLP's alone) and a route scored against its
connect times are not; what the driver takes from the configuration (the
limit, the counters) and from the reference module (the head, the
controls' matrices); the readers of its per-layer metrics on a traced run
and on made-up spans; the work counter against the program's parameter
count."""
import dataclasses
import time

import pytest
import torch

from bench.harness import core
from bench.harness.profile import DeviceTrace
from bench.work import falcon_h1 as work

TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "intermediate_size": 96, "vocab_size": 128,
        "num_hidden_layers": 2, "mamba_n_heads": 4, "mamba_d_head": 8,
        "mamba_d_ssm": 32, "mamba_d_state": 8, "mamba_n_groups": 2,
        "mamba_chunk_size": 4, "dtype": "float32",
        "mct_overrides": {"n_rules": 2_000}}
ROUTE = {"searchers": 2, "routes": 6, "prompt_min": 4, "prompt_max": 20,
         "new_tokens": 3, "n_searches": 8, "query_pool": 256,
         "target_batch": 8, "max_seq": 32, "warmup_s": 0.3,
         "capture_every": 2, "capture_max": 6, "profile_s": 0.5}


def _run(seed=3, trace=False, config=None, **traffic):
    torch.set_num_threads(2)
    return core.run("falcon-h1-route", seed, 2.0, trace, device="cpu",
                    config_overrides={**TINY, **(config or {})},
                    traffic_overrides={**ROUTE, **traffic})


def _driver(config=None):
    """The cell's driver at the tiny size, not yet set up."""
    res = core.resolve("falcon-h1-route")
    Driver = core.load_driver(res["traffic"]["driver"])
    return Driver(res["cell"], {**res["config"], **TINY, **(config or {})},
                  {**res["traffic"], **ROUTE}, 3, torch.device("cpu"), False)


def _tiny_params(config=None):
    """The tiny model's parameters as the program draws them, with the
    driver's model config and reference."""
    from repro_torch.models.transformer import init_params
    d = _driver(config)
    return d, init_params(d.model_cfg, torch.Generator().manual_seed(5))


def test_sound_run_is_correct():
    out = _run(seed=2 ** 31 + 5)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    m = out["metrics"]
    assert m["mct_queries_per_s"]["value"] > 0
    assert {"search_p95_ms", "setup_s"} <= set(m)
    assert out["checks"]["lm_logits_err"]["value"] < 1e-4


def test_sound_run_with_tied_embeddings_is_correct():
    """A tied model's tree has no head of its own: the check takes the
    embedding through the reference's mapping."""
    out = _run(seed=2 ** 31 + 6, config={"tie_word_embeddings": True})
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["lm_logits_err"]["value"] < 1e-4


# the tiny model's limit (the configuration's, 0.03, is set at the
# published widths)
TINY_LIMIT = {"lm_logits_err_limit": 0.01}


def _control_is_refused(control):
    """At this size the float32 program reads about 3e-7, its float8 MLP
    control about 0.03 and every matrix in float8 about 0.07: the tiny
    model's limit, given as the configuration's, is 0.01."""
    out = _run(control=control, config=TINY_LIMIT)
    assert out["checks"]["lm_logits_err"]["limit"] == 0.01
    assert out["correct"] is False
    c = out["checks"]["lm_logits_err"]
    assert c["value"] > c["limit"]
    assert out["checks"]["mct_wrong"]["value"] == 0
    return c["value"]


def test_fp8_mlp_control_is_not_correct():
    _control_is_refused("mlp_fp8")


def test_fp8_whole_model_control_is_not_correct():
    """Every weight matrix in float8 reads above the MLP's alone."""
    whole = _control_is_refused("fp8")
    assert whole > _control_is_refused("mlp_fp8")


@pytest.mark.parametrize("key", ["lm_logits_err_limit", "lm_logits_err_why"])
def test_configuration_without_the_limit_is_refused(key):
    """The limit and its reason come from the configuration, with no
    default: without them the driver stops before set-up, naming the key."""
    res = core.resolve("falcon-h1-route")
    cfg = {k: v for k, v in res["config"].items() if k != key}
    Driver = core.load_driver(res["traffic"]["driver"])
    with pytest.raises(KeyError, match=key):
        Driver(res["cell"], cfg, res["traffic"], 1, torch.device("cpu"),
               False)


def _old_matrices(params, parts):
    """The controls' matrices as the driver listed them before the
    reference module did."""
    out = [params[k] for k in ("embed", "unembed") if k in parts]
    for run in params["blocks"]:
        for blk in run:
            for g, keys in (("attn", ("wq", "wk", "wv", "wo")),
                            ("mamba2", ("w_in", "w_out")),
                            ("ffn", ("wg", "wi", "wo"))):
                if g in parts:
                    out += [blk[g][k] for k in keys]
    return out


@pytest.mark.parametrize("control,parts", [
    ("mlp_fp8", ("ffn",)),
    ("fp8", ("embed", "unembed", "attn", "mamba2", "ffn"))])
def test_control_matrices_are_the_old_list_in_its_order(control, parts):
    d, params = _tiny_params()
    assert tuple(d.ref.CONTROLS[control]) == parts
    got = list(d.ref.matrices(params, d.ref.CONTROLS[control]))
    want = _old_matrices(params, parts)
    assert len(got) == len(want) > 0
    assert all(a is b for a, b in zip(got, want))


def test_head_path_equals_the_old_formula():
    """Untied: the check's final norm and head, through the reference's
    mapping, give the logits that ``1 + norm_f`` and ``unembed`` gave."""
    d, params = _tiny_params()
    keys = d.cfg
    x = torch.randn(5, keys["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    w = d.ref.from_port(params, keys)
    assert w["unembed"] is params["unembed"]
    got = d.ref.logits(d.ref.to_float32(
        {k: v for k, v in w.items() if k not in ("embed", "layers")}), x,
        keys)
    want = d.ref.head(1.0 + params["norm_f"]["w"].float(),
                      params["unembed"].float(), x, keys)
    assert torch.equal(got, want)


def test_tied_head_is_the_embedding():
    d, params = _tiny_params({"tie_word_embeddings": True})
    assert "unembed" not in params
    w = d.ref.from_port(params, d.cfg)
    assert w["unembed"] is params["embed"]
    got = list(d.ref.matrices(params, d.ref.CONTROLS["fp8"]))
    assert got[0] is params["embed"] and got[1] is not params["embed"]


@pytest.mark.parametrize("counters", [["prefill_counts"],
                                      ["prefill_counts", "decode_counts"]])
def test_counters_are_read_at_both_edges_of_the_window(monkeypatch,
                                                       counters):
    """Each counter the configuration lists is read once as the window
    opens and once as it closes, into ``run.data["counts"]``."""
    from repro_torch.serve.engine import LMServer
    reads = {k: [] for k in counters}
    for k in counters:
        def wrapped(self, _f=getattr(LMServer, k), _k=k):
            v = _f(self)
            reads[_k].append((time.perf_counter(), v))
            return v
        monkeypatch.setattr(LMServer, k, wrapped)
    torch.set_num_threads(2)
    core.prepare_environment()
    d = _driver({"counters": counters})
    d.setup()
    run = d.window(1.5, None)
    d.release()
    counts = run.data["counts"]
    assert set(counts) == set(counters)
    for k in counters:
        first, last = counts[k]
        assert any(t <= run.t0 and v == first for t, v in reads[k])
        assert any(t >= run.t1 and v == last for t, v in reads[k])
    (r0, _), (r1, _) = counts["prefill_counts"]
    assert r1 > r0
    assert core.load_reader("scorer_pad_share").read(run) is not None


def test_every_counter_a_configuration_names_is_the_programs():
    from repro_torch.serve.engine import LMServer
    spec = core.load_spec()
    for c in spec["configs"]:
        for k in core.load_config(c["name"]).get("counters", ()):
            assert callable(getattr(LMServer, k, None)), (c["name"], k)


def test_route_kept_against_its_connect_times_is_not_correct(monkeypatch):
    from repro_torch.serve.engine import LMServer
    feasible = LMServer._mct_feasible
    monkeypatch.setattr(LMServer, "_mct_feasible",
                        lambda self, *a: [True] * len(
                            feasible(self, *a)))
    out = _run()
    assert out["correct"] is False
    assert out["checks"]["mct_wrong"]["value"] > 0


def test_traced_run_reads_what_the_cpu_has():
    out = _run(trace=True)
    m = out["metrics"]
    assert 0 < m["scorer_pad_share"]["value"] < 100
    # no device trace on the CPU: the device readers read nothing
    assert "scorer_mfu" not in m and "device_idle.scorer" not in m


def _spans():
    from repro_torch.serve.trace import Span
    return [Span("lm.filter", 0.9, 1.0, meta={"batch": 1, "queries": 9,
                                              "dropped": 2}),
            Span("lm.prefill", 1.0, 2.0, meta={"batch": 1, "rows": 2,
                                               "lens": [10, 20],
                                               "real_tokens": 30,
                                               "padded_tokens": 10}),
            Span("lm.decode", 2.0, 2.5, meta={"batch": 1, "rows": 2,
                                              "pos": 20}),
            Span("lm.decode", 2.5, 3.0, meta={"batch": 1, "rows": 2,
                                              "pos": 21})]


def _keys():
    from bench.harness.core import load_config
    return {**load_config("falcon-h1-34b-pp2"), **TINY}


def test_scorer_readers_on_made_up_spans():
    keys = _keys()
    dev = DeviceTrace(t0=0.5, t1=3.5, aligned=True, ops=[
        ("gemm", 2.1, 2.2), ("gemm", 2.6, 2.9), ("Memcpy HtoD", 2.3, 2.4),
        ("gemm", 1.1, 1.5)])
    run = core.TracedRun(0.0, 4.0, device=dev, data={
        "spans": _spans(), "spans_dropped": 0, "work": work,
        "model_keys": keys,
        "counts": {"prefill_counts": ((100, 0), (130, 10))}})
    mfu = core.load_reader("scorer_mfu").read(run)
    want = (work.prefill_flops(keys, [10, 20])
            + work.decode_flops(keys, [10, 20], 0)
            + work.decode_flops(keys, [10, 20], 1))
    assert mfu == pytest.approx(100 * want / (3.0 * work.PEAK_BF16_FLOPS))
    roof = core.load_reader("scorer_decode_roofline").read(run)
    bound = (work.decode_bytes(keys, [10, 20], 0)
             + work.decode_bytes(keys, [10, 20], 1)) / 3.35e12
    assert roof == pytest.approx(100 * bound / 0.4)
    assert core.load_reader("scorer_pad_share").read(run) == \
        pytest.approx(25.0)
    assert core.load_reader("device_idle.scorer").read(run) == \
        pytest.approx(100 * (1 - 0.9 / 3.0))
    # no spans, dropped spans or no device trace: nothing read, nothing
    # raised (the parent of a PR without the spans)
    for data in ({}, {"spans": _spans(), "spans_dropped": 3}):
        empty = core.TracedRun(0.0, 4.0, device=dev, data=data)
        for name in ("scorer_mfu", "scorer_decode_roofline",
                     "scorer_pad_share"):
            assert core.load_reader(name).read(empty) is None


def test_work_counts_the_programs_parameters():
    from repro_torch.configs.falcon_h1_34b import CONFIG
    keys = core.load_config("falcon-h1-34b-pp2")
    cfg = dataclasses.replace(CONFIG, n_layers=keys["num_hidden_layers"])
    V, D, L, H = cfg.vocab, cfg.d_model, cfg.n_layers, cfg.mamba2.n_heads
    assert work.weight_bytes(keys) == 2 * (cfg.n_params() - V * D) \
        + L * 6 * H
    # a decode step moves at least the weights and the rows' states
    state = 4 * L * (3 * 5120 + 32 * 128 * 256)
    assert work.decode_bytes(keys, [100] * 8, 0) > \
        work.weight_bytes(keys) + 2 * 8 * state
    # prefill: at least 2 x (block parameters) a token
    n = 2 * L * (cfg.n_params() - 2 * V * D - D) // L
    assert work.prefill_flops(keys, [1]) >= n + 2 * D * V
    assert work.prefill_flops(keys, [64, 64]) == \
        2 * work.prefill_flops(keys, [64])


def test_parent_without_the_arch_fails_at_once(monkeypatch):
    """A program without the configuration's arch stops before set-up."""
    import importlib
    real = importlib.import_module

    def missing(name, *a, **k):
        if name.startswith("repro_torch.configs.falcon"):
            raise ModuleNotFoundError(name)
        return real(name, *a, **k)
    monkeypatch.setattr(importlib, "import_module", missing)
    res = core.resolve("falcon-h1-route")
    Driver = core.load_driver(res["traffic"]["driver"])
    with pytest.raises(ModuleNotFoundError):
        Driver(res["cell"], res["config"], res["traffic"], 1,
               torch.device("cpu"), False)
