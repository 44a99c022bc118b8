"""Paper Tables 2-3 from the port: deployment cost estimates (reproduced
from the paper's unit prices, Table 2 held within 3% of its totals) and the
same CPU:accelerator balance analysis for an H100, fed from rates measured
on this run's device; the counterpart of ``benchmarks/table2_3_cost.py``.

The H100 balance (``h100_balance`` rows, the reference's ``tpu_balance``)
takes the host's encode rate (one worker, B = 1,024) and the device's
rule-match rate (one ``ErbiumEngine.match`` call at B = 4,096, ending in
the card's synchronisation). On the CPU the "device" rate is the plain
version's on the CPU: each row says which device its rates came from.

    PYTHONPATH=src python3 benchmarks/torch_table2_3_cost.py [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.core.cost_model import (PAPER_TABLE2_TOTALS, H100CostParams,
                                         h100_balance, table2, table3)
from repro_torch.core.wrapper import measure_stage_times
from torch_common import Bench, batch_maker, cli

BALANCE_QPS = (2e8, 2e9, 2e10)
HOST_BATCH, DEVICE_BATCH = 1024, 4096
TABLE2_TOL = 0.03


def measured_params(bench: Bench) -> H100CostParams:
    """Host encode rate a vCPU and device match rate, measured here."""
    eng = bench.engine(2)
    st, = measure_stage_times(eng, batch_maker(bench.system(2).queries),
                              (HOST_BATCH,), repeats=3)
    enc = bench.system(2).encoded
    q = torch.as_tensor(enc[:DEVICE_BATCH], dtype=torch.int32,
                        device=bench.device)
    us = bench.time_us(eng.match, q, repeats=10)
    return H100CostParams(host_qps_per_vcpu=HOST_BATCH / (st.encode_us * 1e-6),
                          accel_qps_per_chip=len(q) / (us * 1e-6))


def _slug(name: str) -> str:
    return name.replace(" ", "_").replace("/", "-")


def run(bench: Bench = None, *, params: H100CostParams = None):
    """Returns ``dict(ok, worst, params, balance)``; ``params`` defaults to
    :func:`measured_params`."""
    bench = bench or Bench.on()
    ok, worst = True, 0.0
    for d in table2():
        exp = PAPER_TABLE2_TOTALS.get(d.name)
        dev = abs(d.total_usd - exp) / exp if exp else 0.0
        ok &= dev < TABLE2_TOL
        worst = max(worst, dev)
        bench.emit(f"table2/{_slug(d.name)}", 0.0,
                   f"total=${d.total_usd / 1e6:.2f}M;"
                   f"paper=${(exp or 0) / 1e6:.2f}M;dev={dev:.1%}",
                   total_usd=d.total_usd, paper_usd=exp)
    bench.emit("table2/validated_against_paper", 0.0, f"ok={ok}", ok=ok)
    for d in table3():
        bench.emit(f"table3/{_slug(d.name)}", 0.0,
                   f"total=${d.total_usd / 1e6:.2f}M", total_usd=d.total_usd)

    params = measured_params(bench) if params is None else params
    balance = {}
    for qps in BALANCE_QPS:
        balance[f"{qps:.0e}"] = r = h100_balance(params, qps)
        bench.emit(f"h100_balance/qps{qps:.0e}", 0.0,
                   f"chips={r['chips_bought']:.1f};"
                   f"util={r['accel_utilisation']:.2f};"
                   f"cost_ratio_vs_cpu={r['cost_ratio_accel_vs_cpu']:.2f};"
                   f"rates_from={bench.device_name}",
                   host_qps_per_vcpu=params.host_qps_per_vcpu,
                   accel_qps_per_chip=params.accel_qps_per_chip, **r)
    return dict(ok=ok, worst=worst, params=params, balance=balance)


if __name__ == "__main__":
    run(cli(__doc__)[0])
