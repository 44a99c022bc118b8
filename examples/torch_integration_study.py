"""The paper's integration study from the PyTorch port, as one report:
stand-alone throughput (Fig 4), stage-overhead decomposition (Fig 6),
parallel-configuration series (Figs 7-10), Pareto front (Fig 11), the
CPU-vs-accelerator crossover (Fig 12) and the cost tables (Tables 2-3);
the port's copy of examples/integration_study.py, through the
``benchmarks/torch_*.py`` harnesses on one shared ``Bench``.

Runs on the card unless ``--device cpu`` is given (no card: an error,
never a fall back): on the card at 160,000 rules through the CUDA
rule-match kernel, on the CPU at the reference's 4,096 rules through its
plain version. No LM stage runs here.

Run:  PYTHONPATH=src python examples/torch_integration_study.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))

import torch_fig4_throughput as fig4  # noqa: E402
import torch_fig6_overheads as fig6  # noqa: E402
import torch_fig7_10_parallel as fig7_10  # noqa: E402
import torch_fig11_pareto as fig11  # noqa: E402
import torch_fig12_cpu_accel as fig12  # noqa: E402
import torch_table2_3_cost as table2_3  # noqa: E402
from torch_common import Bench  # noqa: E402


def main(device="cuda"):
    """Runs every section on one bench and returns it."""
    bench = Bench.on(device)
    print(f"# device: {bench.device_name}, {bench.n_rules} rules")
    print("name,us_per_call,derived")
    print("# --- Fig 4: stand-alone throughput vs batch (v1 vs v2) ---")
    fig4.run(bench)
    print("# --- Fig 6: stage overhead decomposition ---")
    fig6.run(bench)
    print("# --- Figs 7-10: parallel configuration series ---")
    st = fig7_10.measure(bench)
    fig7_10.run(bench, stage_times=st)
    print("# --- Fig 11: Pareto front ---")
    fig11.run(bench, stage_times=st)
    print("# --- Fig 12: CPU vs accelerator crossover ---")
    fig12.run(bench)
    print("# --- Tables 2-3: deployment cost ---")
    table2_3.run(bench)
    return bench


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
