"""The controls of ``correct``, on the card at each cell's own size.

MCT cells: the control is the plain reference put in the program's place,
breaking the one guarantee the configuration states (exact int32 answers,
the best precision weight): the reference without v2's dynamic precision
weights. The route scorer's cell: each of its reference module's
``CONTROLS``, the program's weight matrices of those groups rounded
through float8 e4m3, the precision below the configuration's bf16, for a
short window at the cell's own load. Each must fail the limit that sound
runs of the program pass. Run on the card:

    python -m pytest -m gpu bench/tests/test_bench_control.py -s

It prints the control's count of wrong answers, or its ``lm_logits_err``
beside the configuration's limit, a seed (PERF.md).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from bench.harness import core, inputs
from bench.reference import mct as ref_mct

SEEDS = [int(s) for s in os.environ.get(
    "BENCH_CONTROL_SEEDS", "3000000011,3000000012,3000000013").split(",")]
# the route scorer's control window: long enough to mark and score as many
# routes as a run of the cell compares (the traffic's capture_max)
LM_CONTROL_S = 20.0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' "
                    "own sizes")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["mct-search", "mct-encoded"])
def test_mct_control_fails(cell):
    dev = _cuda()
    core.prepare_environment()
    res = core.resolve(cell)
    cfg, tr = res["config"], res["traffic"]
    rules = inputs.rule_set(cfg)
    dense = inputs.dense_rules(cfg, rules)
    control = ref_mct.dense_rules(rules, dynamic_weights=False)
    n = int(tr["check_queries"])
    for seed in SEEDS:
        pool = inputs.query_pool(rules, n, seed)
        values = ref_mct.query_values(rules, pool)
        wrong = ref_mct.judge(dense, values,
                              *ref_mct.answers(control, values, dev),
                              device=dev)
        print(json.dumps({"cell": cell, "seed": seed, "control_wrong":
                          wrong, "of": n, "limit": 0}))
        assert wrong > 0


# one run of the route scorer's cell with a control, in a process of its
# own: a second run in one process ran out of card memory, the first run's
# weights still held (a run freezes the collector after its set-up)
LM_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from bench.harness import core
out = core.run("falcon-h1-route", {seed}, {seconds}, False,
               traffic_overrides={{"control": {control!r}}})
print(json.dumps(out["checks"]))
"""


@pytest.mark.gpu
@pytest.mark.parametrize("control", ["fp8", "mlp_fp8"])
def test_lm_route_control_fails(control):
    _cuda()
    for seed in SEEDS:
        proc = subprocess.run(
            [sys.executable, "-c", LM_RUN.format(
                root=str(core.ROOT), seed=seed, seconds=LM_CONTROL_S,
                control=control)],
            cwd=core.ROOT, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        c = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"cell": "falcon-h1-route", "control": control,
                          "seed": seed, "checks": c}))
        assert c["lm_logits_err"]["value"] > c["lm_logits_err"]["limit"]
