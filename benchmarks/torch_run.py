"""Every paper table and figure from the port, one suite after another; the
counterpart of ``benchmarks/run.py``. Prints ``name,us_per_call,derived``
CSV rows.

    PYTHONPATH=src python3 benchmarks/torch_run.py [--only fig4,table2,...]
        [--device {cuda,cpu}] [--json [PATH]]

``--device`` defaults to the card (no card: an error); ``--device cpu``
runs the kernels' plain versions at the reference's CPU sizes (4,096 rules,
the reduced route scorer). ``--json`` writes BENCH_endtoend.json's schema
(``suites``, ``failed``, ``results`` and the suites' ``cache``,
``capacity`` and ``trace`` sections) to PATH, by default
``build/torch_bench.json``: the committed baseline is never overwritten.
A suite that raises is named on stderr and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_fig4_throughput as fig4  # noqa: E402
import torch_fig6_overheads as fig6  # noqa: E402
import torch_fig7_10_parallel as fig7_10  # noqa: E402
import torch_fig11_pareto as fig11  # noqa: E402
import torch_fig12_cpu_accel as fig12  # noqa: E402
import torch_fig13_endtoend as fig13  # noqa: E402
import torch_fig14_capacity as fig14  # noqa: E402
import torch_fig15_trace as fig15  # noqa: E402
import torch_roofline_table as roofline  # noqa: E402
import torch_serve_sim as serve_sim  # noqa: E402
import torch_table2_3_cost as table2_3  # noqa: E402
from repro_torch.core.cost_model import table2, table3  # noqa: E402
from torch_common import BUILD, Bench  # noqa: E402

SUITES = {
    "fig4": fig4.run, "fig6": fig6.run, "fig7_10": fig7_10.run,
    "fig11": fig11.run, "fig12": fig12.run, "fig13": fig13.run,
    "fig14": fig14.run, "fig15": fig15.run, "table2": table2_3.run,
    "roofline": roofline.run,
}
JSON_DEFAULT = BUILD / "torch_bench.json"


def reference_rows(suite: str) -> list:
    """The row names the reference's suite emits (``h100_balance`` for its
    ``tpu_balance``); a name ending in ``*`` stands for one or more rows
    with that prefix (their names follow the measured data)."""
    if suite == "fig4":
        return [f"fig4/v{v}_e{e}_b{b}" for v in fig4.VERSIONS
                for e in fig4.ENGINES for b in fig4.BATCHES] \
            + ["fig4/v2_vs_v1_saturated"]
    if suite == "fig6":
        return [f"fig6/b{b}" for b in fig6.BATCHES] \
            + ["fig6/encoder_dominates_at_large_batch"]
    if suite == "fig7_10":
        return [f"{name}/{c.label().replace(' ', '')}"
                for name, cfgs in fig7_10.SERIES.items() for c in cfgs] \
            + ["fig7/4engines_speedup", "fig10/worker_saturation"]
    if suite == "fig11":
        return ["fig11/front_*", "fig11/best_under_throughput_floor"]
    if suite == "fig12":
        return ["fig12/uq_mct*", "fig12/speedup_above_400q"]
    if suite == "fig13":
        return [f"fig13_load_{f:g}x" for f in fig13.LOAD_FRACTIONS] \
            + ["fig13_pipeline_overlap"] \
            + [f"fig13_replicas_{r}" for r in serve_sim.REPLICA_COUNTS] \
            + [f"fig13_cache_a{a:g}_{t}" for a in fig13.CACHE_ALPHAS
               for t in ("off", "on")]
    if suite == "fig14":
        return [f"fig14_{p}_{k}" for p in serve_sim.CAPACITY_PHASES
                for k in ("static", "controlled")]
    if suite == "fig15":
        return [f"fig15_{sc['profile']}" for sc in fig15.SCENARIOS] \
            + ["fig15_trace_overhead", "fig15_chrome_export"]
    if suite == "table2":
        def slug(d):
            return d.name.replace(" ", "_").replace("/", "-")
        return [f"table2/{slug(d)}" for d in table2()] \
            + ["table2/validated_against_paper"] \
            + [f"table3/{slug(d)}" for d in table3()] \
            + [f"h100_balance/qps{q:.0e}" for q in table2_3.BALANCE_QPS]
    if suite == "roofline":
        return ["roofline/*"]
    raise ValueError(f"unknown suite {suite!r}")


def missing_rows(results: list, names: list) -> list:
    """The names (or ``prefix*`` patterns) that no row of ``results``
    matches."""
    got = {r["name"] for r in results}
    return [n for n in names
            if not (any(g.startswith(n[:-1]) for g in got)
                    if n.endswith("*") else n in got)]


def write_json(path, bench: Bench, suites, failed) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"suites": sorted(suites), "failed": failed,
         "device": bench.device_name, "results": bench.results,
         **bench.sections}, indent=2, default=str))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated subset, e.g. fig4,table2")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", nargs="?", const=str(JSON_DEFAULT),
                    default=None, metavar="PATH",
                    help=f"also write the rows as JSON (default PATH: "
                         f"{JSON_DEFAULT.relative_to(BUILD.parent)})")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(SUITES)
    unknown = only - set(SUITES)
    if unknown:
        ap.error(f"unknown suites {sorted(unknown)}; known: "
                 f"{', '.join(SUITES)}")
    bench = Bench.on(args.device)
    print("name,us_per_call,derived")
    failed = []
    for name, fn in SUITES.items():
        if name not in only:
            continue
        try:
            fn(bench)
        except Exception:           # report the suite, run the others
            failed.append(name)
            traceback.print_exc()
    if args.json:
        path = write_json(args.json, bench, only, failed)
        print(f"wrote {len(bench.results)} rows to {path}", file=sys.stderr)
    if failed:
        print(f"FAILED suites: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
