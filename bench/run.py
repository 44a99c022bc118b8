"""Run one benchmark cell once on the card and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic and metrics are read from
``BENCHMARK.json`` and the files under ``bench/`` named there. The run makes
its inputs and weights from ``--seed``, sets up and warms up (timed as
``setup_s``), measures for ``--seconds``, then checks what the timed path
produced against the plain reference in ``bench/reference/``. With
``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from the harness's spans, the
program's counters and a profiled sub-window of the window. The last line
of standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.

There is no fall back: without a CUDA card, or with fewer cards than the
cell asks for, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench.harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    core.prepare_environment()
    import torch
    chips = core.resolve(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = core.run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = core.loaded_forbidden()
    if bad:
        print(f"no result: modules loaded that the port must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
