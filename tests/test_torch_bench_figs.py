"""Port parity, the paper-figure harnesses: ``benchmarks/torch_*.py``
against the JAX package's ``benchmarks/*.py`` on the CPU, at small sizes
(512 rules, B <= 256, the reduced float32 route scorer). The reference's
harnesses run with their rule systems, batches or stage times patched to
the same small inputs, so that their rows can be read beside the port's.

Only deterministic facts are held: rule systems byte for byte, int32
results exactly, the deployment series and cost tables to the last bit on
one list of stage times, tokens, call counts and row names; never a time.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "benchmarks"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import benchmarks.common as j_common  # noqa: E402
import benchmarks.fig4_throughput as j_fig4  # noqa: E402
import benchmarks.fig6_overheads as j_fig6  # noqa: E402
import benchmarks.fig12_cpu_accel as j_fig12  # noqa: E402
import benchmarks.fig7_10_parallel as j_fig7_10  # noqa: E402
import benchmarks.fig11_pareto as j_fig11  # noqa: E402
import benchmarks.table2_3_cost as j_table2_3  # noqa: E402
import torch_common as tc  # noqa: E402
import torch_fig4_throughput as fig4  # noqa: E402
import torch_fig6_overheads as fig6  # noqa: E402
import torch_fig7_10_parallel as fig7_10  # noqa: E402
import torch_fig11_pareto as fig11  # noqa: E402
import torch_fig12_cpu_accel as fig12  # noqa: E402
import torch_fig13_endtoend as fig13  # noqa: E402
import torch_fig15_trace as fig15  # noqa: E402
import torch_run  # noqa: E402
import torch_table2_3_cost as table2_3  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.core.aggregator import paper_policy as j_paper_policy  # noqa: E402
from repro.core.wrapper import StageTimes as JStageTimes  # noqa: E402
from repro.core.workload import generate_workload as j_workload  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.serve import OpenLoopGen as JOpenLoopGen  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import SyntheticWorkload as JSyntheticWorkload  # noqa: E402
from repro.serve import build as j_build  # noqa: E402
from repro.serve.engine import LMServer as JServer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.cost_model import H100CostParams  # noqa: E402
from repro_torch.core.wrapper import StageTimes  # noqa: E402
from repro_torch.serve import LMServer, OpenLoopGen  # noqa: E402
from repro_torch.serve import ServeConfig, build  # noqa: E402

N_RULES, N_QUERIES = 512, 512
BATCHES = (64, 256)
# stage costs (us) at the reference's three stage batches: host-bound,
# balanced and device-bound points
STAGES = [dict(batch=256, queue_us=3.0, encode_us=5_900.0, dispatch_us=510.0,
               kernel_us=1_400.0, collect_us=350.0),
          dict(batch=1024, queue_us=2.0, encode_us=21_000.0,
               dispatch_us=640.0, kernel_us=2_100.0, collect_us=420.0),
          dict(batch=4096, queue_us=4.0, encode_us=83_000.0,
               dispatch_us=900.0, kernel_us=95_000.0, collect_us=700.0)]
PARAMS = H100CostParams(host_qps_per_vcpu=1.8e5, accel_qps_per_chip=1.1e7)


def _rows(results):
    return [(r["name"], r["us_per_call"], r["derived"]) for r in results]


def _reference_system(monkeypatch, version):
    """The reference's ``common.rule_system`` body at the small sizes."""
    monkeypatch.setattr(j_common, "N_RULES", N_RULES)
    monkeypatch.setattr(j_common, "N_QUERIES", N_QUERIES)
    return j_common.rule_system.__wrapped__(version)


@pytest.fixture
def bench(monkeypatch):
    monkeypatch.setitem(tc.SIZES, "cpu", (N_RULES, N_QUERIES))
    return tc.Bench.on("cpu")


@pytest.fixture
def j_results(monkeypatch):
    """The reference's rows, emitted into a fresh ``common.RESULTS``."""
    monkeypatch.setattr(j_common, "RESULTS", [])
    return j_common


@pytest.mark.parametrize("version", [1, 2])
def test_rule_system_is_the_references(monkeypatch, version):
    j_rs, j_table, j_qs, j_enc = _reference_system(monkeypatch, version)
    rs, table, qs, enc = tc.rule_system(version, N_RULES, N_QUERIES)
    assert [dataclasses.astuple(r) for r in rs.rules] == \
        [dataclasses.astuple(r) for r in j_rs.rules]
    for f in ("mins", "maxs", "weights", "decisions", "rule_ids",
              "part_offsets", "part_order", "wildcard_rows"):
        got, want = getattr(table, f), getattr(j_table, f)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f
    assert qs == j_qs
    assert enc.dtype == j_enc.dtype and enc.tobytes() == j_enc.tobytes()


def test_fig4_equals_reference_match_rules(monkeypatch, bench, j_results):
    systems = {v: _reference_system(monkeypatch, v) for v in (1, 2)}
    monkeypatch.setattr(j_fig4, "rule_system", systems.__getitem__)
    monkeypatch.setattr(j_fig4, "BATCHES", BATCHES)
    monkeypatch.setattr(fig4, "BATCHES", BATCHES)
    j_fig4.run()
    qps, outputs = fig4.run(bench)
    assert [r["name"] for r in bench.results] == \
        [r["name"] for r in j_results.RESULTS]
    assert set(qps) == set(outputs) == {
        (v, e, b) for v in fig4.VERSIONS for e in fig4.ENGINES
        for b in BATCHES}
    for v in fig4.VERSIONS:
        _, j_table, _, j_enc = systems[v]
        dt = j_ops.device_table(j_table, tile_r=512)
        for b in BATCHES:
            want = j_ops.match_rules(jnp.asarray(j_enc[:b]), dt,
                                     tile_b=256, tile_r=512, n_engines=4,
                                     interpret=True)
            for e in fig4.ENGINES:
                for got, w in zip(outputs[(v, e, b)], want):
                    np.testing.assert_array_equal(got, np.asarray(w))


def test_fig12_counts_and_paths(bench):
    out = fig12.run(bench)
    rs = tc.rule_system(2, N_RULES, N_QUERIES).ruleset
    wl = sorted(j_workload(rs, fig12.N_USERS, seed=7, mean_ts=400.0),
                key=lambda u: u.n_mct)
    want = [(u.n_mct, len(j_paper_policy(u))) for u in wl
            if j_paper_policy(u)]
    assert [(r["n_mct"], r["calls"]) for r in out["rows"]] == want
    names = [r["name"] for r in bench.results]
    assert names == [f"fig12/uq_mct{n}" for n, _ in want] \
        + ["fig12/speedup_above_400q"]
    assert set(out["crossover"]) == set(fig12.PATHS)


def test_fig12_crossover():
    rows = [dict(n_mct=n, cpu_us=c, kernel_us=k)
            for n, c, k in ((100, 10, 20), (300, 30, 25), (500, 50, 60),
                            (700, 70, 30), (900, 90, 40))]
    assert fig12.crossover(rows, "kernel") == 700
    rows[-1]["kernel_us"] = 95
    assert fig12.crossover(rows, "kernel") is None


def test_fig7_11_series_equal_the_references(monkeypatch, bench, j_results):
    j_st = [JStageTimes(**s) for s in STAGES]
    st = [StageTimes(**s) for s in STAGES]
    monkeypatch.setattr(j_fig7_10, "_stage_times", lambda: j_st)
    monkeypatch.setattr(j_fig11, "_stage_times", lambda: j_st)
    j_out = j_fig7_10.run()
    j_front = j_fig11.run()
    out = fig7_10.run(bench, stage_times=st)
    front = fig11.run(bench, stage_times=st)
    assert _rows(bench.results) == _rows(j_results.RESULTS)
    assert [(s, c.label(), p.latency_us, p.throughput_qps)
            for (s, c), p in out.items()] == \
        [(s, c.label(), p.latency_us, p.throughput_qps)
         for (s, c), p in j_out.items()]
    assert [(p.config.label(), p.latency_us, p.throughput_qps)
            for p in front] == \
        [(p.config.label(), p.latency_us, p.throughput_qps)
         for p in j_front]


def test_table2_3_equal_the_references(bench, j_results):
    assert j_table2_3.run() is True
    got = table2_3.run(bench, params=PARAMS)
    assert got["ok"] is True and got["worst"] < table2_3.TABLE2_TOL
    ref = [(n.replace("tpu_balance/", "h100_balance/"), d)
           for n, _, d in _rows(j_results.RESULTS)]
    port = [(n, d) for n, _, d in _rows(bench.results)]
    assert [n for n, _ in port] == [n for n, _ in ref]
    # tables 2 and 3 print the same totals; the balance rows are the
    # H100's, fed from PARAMS
    assert [r for r in port if r[0].startswith("table")] == \
        [r for r in ref if r[0].startswith("table")]
    assert set(got["balance"]) == {f"{q:.0e}" for q in table2_3.BALANCE_QPS}


def test_fig13_inset_tokens_equal_the_reference_serve(bench):
    arch = "llama3.2-3b"

    def f32(cfg):
        return dataclasses.replace(cfg.reduced(), dtype="float32",
                                   param_dtype="float32")
    j_cfg, cfg = f32(j_get_config(arch)), f32(get_config(arch))
    j_lm = JServer(j_cfg, max_seq=fig13.MAX_SEQ)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  j_lm.params)
    lm = LMServer(cfg, params_from_numpy(tree, cfg, device="cpu"),
                  device="cpu", max_seq=fig13.MAX_SEQ)
    knobs = dict(target_batch=fig13.TARGET_BATCH, deadline=fig13.DEADLINE_S,
                 max_queue=fig13.MAX_QUEUE, policy="reject")
    qps = 200.0
    with build(ServeConfig(server_factory=lambda i: lm, **knobs)) as srv:
        wl = fig13.workload(srv)
        inset = fig13.pipeline_inset(bench, srv, wl, qps)
    assert inset["tokens_equal"]
    j_srv = j_build(JServeConfig(server_factory=lambda i: j_lm, **knobs))
    j_wl = JSyntheticWorkload(vocab=j_cfg.vocab, prompt_len=6,
                              max_new_tokens=3, seed=1)
    j_reqs = JOpenLoopGen(j_wl, qps=qps, n=fig13.INSET_N, seed=5).requests()
    reqs = OpenLoopGen(wl, qps=qps, n=fig13.INSET_N, seed=5).requests()
    assert [(r.rid, r.arrival, r.tokens.tolist()) for r in reqs] == \
        [(r.rid, r.arrival, np.asarray(r.tokens).tolist()) for r in j_reqs]
    j_outs = {c.rid: c for c in j_srv.serve(j_reqs, mode="sync")}
    assert sorted(j_outs) == sorted(c.rid for c in inset["sync"])
    for c in inset["pipelined"]:
        np.testing.assert_array_equal(c.tokens,
                                      np.asarray(j_outs[c.rid].tokens))
    assert [r["name"] for r in bench.results] == ["fig13_pipeline_overlap"]


def test_fig13_load_point_accounts_for_every_request(bench):
    """A load point's batch sizes add up to its completions, and every
    offered request completes or is rejected."""
    n = 24
    with fig13.server(bench) as srv:
        point, = fig13.load_sweep(bench, srv, fig13.workload(srv), 50.0,
                                  fractions=(4.0,), n=n)
    hist = {int(k): v for k, v in point["batch_hist"].items()}
    assert sum(hist.values()) == point["n_batches"]
    assert sum(k * v for k, v in hist.items()) == point["n_completed"]
    assert point["n_completed"] + point["n_rejected"] == n
    assert max(hist) <= fig13.TARGET_BATCH
    assert point["mean_batch"] == point["n_completed"] / point["n_batches"]
    assert 0.0 <= point["execute_idle"] <= 1.0
    assert [r["name"] for r in bench.results] == [f"fig13_load_4x_n{n}"]


def test_fig15_smoke(bench, tmp_path):
    points = fig15.run(bench, smoke=True,
                       chrome_path=tmp_path / "trace.json")
    dom = [p for p in points if "profile" in p]
    assert [p["profile"] for p in dom] == ["weak_host", "balanced"]
    assert all(p["reconciles_with_run_report"] for p in dom)
    overhead, = [p["overhead"] for p in points if "overhead" in p]
    assert overhead["bit_identical"]
    export, = [p["chrome_export"] for p in points if "chrome_export" in p]
    assert export["lifecycle_complete"]
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert [r["name"] for r in bench.results] == \
        torch_run.reference_rows("fig15")


def test_reference_rows_of_the_sim_suites_are_the_baselines():
    """fig13, fig14 and fig15's names against the reference's committed
    run (BENCH_endtoend.json: its fig13 routing rows come from
    ``fig13_endtoend.py --routing``, not from the suite's ``run``)."""
    names = {r["name"] for r in
             json.loads((ROOT / "BENCH_endtoend.json").read_text())["results"]}
    for suite in ("fig13", "fig14", "fig15"):
        want = {n for n in names if n.startswith(suite + "_")
                and not n.startswith("fig13_routing_")}
        assert set(torch_run.reference_rows(suite)) == want, suite


def test_torch_run_cpu_table2_fig11(bench, tmp_path, j_results):
    path = tmp_path / "bench.json"
    assert torch_run.main(["--device", "cpu", "--only", "table2,fig11",
                           "--json", str(path)]) == 0
    out = json.loads(path.read_text())
    assert out["suites"] == ["fig11", "table2"] and out["failed"] == []
    assert out["device"] == "cpu"
    for r in out["results"]:
        assert set(r) >= {"name", "us_per_call", "derived", "device"}
    for suite in ("fig11", "table2"):
        assert not torch_run.missing_rows(
            out["results"], torch_run.reference_rows(suite)), suite
    j_table2_3.run()
    ref = [r["name"].replace("tpu_balance/", "h100_balance/")
           for r in j_results.RESULTS]
    assert [r["name"] for r in out["results"]
            if r["name"].split("/")[0] in ("table2", "table3",
                                          "h100_balance")] == ref
    assert set(torch_run.reference_rows("table2")) == set(ref)


@pytest.mark.parametrize("suite", ["fig6", "fig12"])
def test_reference_rows_are_the_reference_harnesses(monkeypatch, bench,
                                                     j_results, suite):
    """The reference's harness and the port's on one small rule system:
    the same row names, each matched by ``reference_rows`` and each of its
    names or patterns matched by a row."""
    system = _reference_system(monkeypatch, 2)
    if suite == "fig6":
        for mod in (j_fig6, fig6):
            monkeypatch.setattr(mod, "BATCHES", BATCHES)
        monkeypatch.setattr(j_fig6, "rule_system", lambda v: system)
        j_fig6.run()
        fig6.run(bench)
    else:
        monkeypatch.setattr(j_fig12, "rule_system", lambda v: system)
        j_fig12.run()
        fig12.run(bench)
    names = [r["name"] for r in j_results.RESULTS]
    assert [r["name"] for r in bench.results] == names
    patterns = torch_run.reference_rows(suite)
    assert torch_run.missing_rows(j_results.RESULTS, patterns) == []
    for n in names:
        assert any(n == p or (p.endswith("*") and n.startswith(p[:-1]))
                   for p in patterns), n


def test_torch_run_rejects_unknown_suites():
    with pytest.raises(SystemExit):
        torch_run.main(["--device", "cpu", "--only", "fig99"])


def test_missing_rows_patterns():
    rows = [{"name": "fig11/front_1p1w1k4e"}, {"name": "table2/x"}]
    assert torch_run.missing_rows(rows, ["fig11/front_*", "table2/x"]) == []
    assert torch_run.missing_rows(rows, ["fig12/uq_mct*", "table2/y"]) == \
        ["fig12/uq_mct*", "table2/y"]
