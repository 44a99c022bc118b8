"""Port parity, deployment and cost models: ``repro_torch.core.deployment``
and ``repro_torch.core.cost_model`` against the JAX package's, on the same
stage times and rates (host arithmetic, so equal to the last bit), plus the
cases of ``tests/test_cost_model.py`` on the H100 re-parameterisation."""
import dataclasses

import pytest

from repro.core import cost_model as j_cost
from repro.core import deployment as j_dep
from repro.core.wrapper import StageTimes as JStageTimes
from repro_torch.core import cost_model as cost
from repro_torch.core import deployment as dep
from repro_torch.core.wrapper import StageTimes

# arbitrary stage costs (us) at three batch sizes: one host-bound point,
# one balanced, one card-bound
STAGES = [dict(batch=256, queue_us=3.0, encode_us=5_900.0, dispatch_us=510.0,
               kernel_us=1_400.0, collect_us=350.0),
          dict(batch=1024, queue_us=2.0, encode_us=21_000.0,
               dispatch_us=640.0, kernel_us=2_100.0, collect_us=420.0),
          dict(batch=4096, queue_us=4.0, encode_us=83_000.0,
               dispatch_us=900.0, kernel_us=95_000.0, collect_us=700.0)]

CONFIGS = ([dep.Config(1, 1, 1, e) for e in (1, 2, 4, 3)]
           + [dep.Config(c, c, c, 1) for c in (1, 2, 4)]
           + [dep.Config(w, w, 1, 4) for w in (1, 2, 4, 8)]
           + [dep.Config(p, 1, 1, 4) for p in (1, 2, 8, 16, 32)]
           + [dep.Config(p, w, k, e) for p in (1, 2, 4) for w in (1, 2, 4)
              for k in (1, 2, 4) for e in (1, 2, 4)
              if w >= k and p >= w and k * e <= 4])
BATCHES = [100, 256, 700, 1024, 4096, 10_000]


def _j(cfg):
    return j_dep.Config(cfg.p, cfg.w, cfg.k, cfg.e)


def _perf_tuple(p):
    c = p.config
    return (c.p, c.w, c.k, c.e, p.batch, p.throughput_qps, p.latency_us)


def test_constants_are_the_papers():
    assert dep.FREQ_DERATE_PER_ENGINE == j_dep.FREQ_DERATE_PER_ENGINE
    assert dep.FREQ_DERATE_PER_KERNEL == j_dep.FREQ_DERATE_PER_KERNEL
    assert dep.WORKER_SATURATION == j_dep.WORKER_SATURATION
    assert dep.XRT_DISPATCH_US == j_dep.XRT_DISPATCH_US
    assert dataclasses.asdict(StageTimes(**STAGES[0])) == \
        dataclasses.asdict(JStageTimes(**STAGES[0]))


@pytest.mark.parametrize("batch", BATCHES)
def test_interp_and_evaluate_equal(batch):
    st = [StageTimes(**s) for s in STAGES]
    j_st = [JStageTimes(**s) for s in STAGES]
    assert dep._interp_stage(st, batch) == j_dep._interp_stage(j_st, batch)
    for c in CONFIGS:
        assert _perf_tuple(dep.evaluate(c, st, batch)) == \
            _perf_tuple(j_dep.evaluate(_j(c), j_st, batch))
    assert dep.Config(16, 4, 2, 1).label() == \
        j_dep.Config(16, 4, 2, 1).label()


def test_sweep_and_pareto_equal():
    st = [StageTimes(**s) for s in STAGES]
    j_st = [JStageTimes(**s) for s in STAGES]
    perfs = dep.sweep(CONFIGS, st, BATCHES)
    j_perfs = j_dep.sweep([_j(c) for c in CONFIGS], j_st, BATCHES)
    assert [_perf_tuple(p) for p in perfs] == \
        [_perf_tuple(p) for p in j_perfs]
    front = dep.pareto(perfs)
    assert [_perf_tuple(p) for p in front] == \
        [_perf_tuple(p) for p in j_dep.pareto(j_perfs)]
    # a front: throughput falls and latency falls along it
    assert all(a.throughput_qps >= b.throughput_qps
               and a.latency_us > b.latency_us
               for a, b in zip(front, front[1:]))


@pytest.mark.parametrize("table", ["table2", "table3"])
def test_tables_equal_row_for_row(table):
    rows = getattr(cost, table)()
    j_rows = getattr(j_cost, table)()
    assert [dataclasses.asdict(r) for r in rows] == \
        [dataclasses.asdict(r) for r in j_rows]
    assert [r.total_usd for r in rows] == [r.total_usd for r in j_rows]


def test_prices_and_helpers_equal():
    assert cost.PAPER_TABLE2_TOTALS == j_cost.PAPER_TABLE2_TOTALS
    for name in ("AWS_C5_12XLARGE_USD_H", "AWS_F1_2XLARGE_USD_H",
                 "AZURE_F48SV2_USD_H", "AZURE_NP10S_USD_H",
                 "HOURS_PER_YEAR"):
        assert getattr(cost, name) == getattr(j_cost, name)
    for v in (8, 24, 48, 96):
        assert cost.aws_host_usd_per_hour(v) == j_cost.aws_host_usd_per_hour(v)
    assert cost.aws_accel_usd_per_hour() == j_cost.aws_accel_usd_per_hour()
    assert cost.usd_per_hour(1.5, 12.29, 2.5) == \
        j_cost.usd_per_hour(1.5, 12.29, 2.5)
    for qps in (0.0, 1.0, 35_000.0, 1e7):
        assert cost.usd_per_1k_queries(12.29, qps) == \
            j_cost.usd_per_1k_queries(12.29, qps)


def test_table2_reproduces_paper_totals():
    for d in cost.table2():
        assert d.total_usd == pytest.approx(cost.PAPER_TABLE2_TOTALS[d.name],
                                            rel=0.03), d.name


# arbitrary rates, given to both functions
RATES = [(250_000.0, 40_000_000.0), (35_000.0, 10_800_000.0),
         (2_500_000.0, 1_000_000.0)]


@pytest.mark.parametrize("host_qps,accel_qps", RATES)
@pytest.mark.parametrize("vcpus_per_8", [112, 192, 8])
def test_h100_balance_is_tpu_balance(host_qps, accel_qps, vcpus_per_8):
    """The same function: only the vCPU count moved to a per-GPU field."""
    p = cost.H100CostParams(host_qps_per_vcpu=host_qps,
                            accel_qps_per_chip=accel_qps,
                            gpu_usd_per_hour=3.7,
                            host_vcpus_per_gpu=vcpus_per_8 / 8)
    jp = j_cost.TPUCostParams(v5e_usd_per_chip_hour=3.7,
                              host_vcpus_per_8chips=vcpus_per_8,
                              host_qps_per_vcpu=host_qps,
                              accel_qps_per_chip=accel_qps)
    for target in (2e8, 2e9, 2e10):
        assert cost.h100_balance(p, target) == j_cost.tpu_balance(jp, target)


def test_h100_params_need_measured_rates():
    with pytest.raises(TypeError):
        cost.H100CostParams()
    p = cost.H100CostParams(host_qps_per_vcpu=1.0, accel_qps_per_chip=1.0)
    assert p.host_vcpus_per_gpu == 24
    assert p.gpu_usd_per_hour == pytest.approx(98.32 / 8)
    assert p.cpu_only_usd_per_48vcpu_hour == cost.AWS_C5_12XLARGE_USD_H


def test_h100_balance_imbalance_phenomenon():
    p = cost.H100CostParams(host_qps_per_vcpu=40_000.0,
                            accel_qps_per_chip=10_000_000.0)
    r = cost.h100_balance(p, target_qps=2e9)
    # host feeding dominates: the card is under-utilised
    assert r["vcpus_needed"] / p.host_vcpus_per_gpu > r["chips_needed"]
    assert r["accel_utilisation"] < 0.2
    # a better host:card ratio fixes it
    p2 = dataclasses.replace(p, host_qps_per_vcpu=400_000.0)
    r2 = cost.h100_balance(p2, target_qps=2e9)
    assert r2["accel_utilisation"] > r["accel_utilisation"] * 5


def test_h100_balance_monotone_in_load():
    p = cost.H100CostParams(host_qps_per_vcpu=40_000.0,
                            accel_qps_per_chip=10_000_000.0)
    costs = [cost.h100_balance(p, q)["accel_cost_usd_year"]
             for q in (1e8, 1e9, 1e10)]
    assert costs[0] < costs[1] < costs[2]
