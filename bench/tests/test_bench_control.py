"""The controls of ``correct``, on the card at each cell's own size.

The control is the plain reference put in the program's place, breaking
the one guarantee the configuration states (exact int32 answers, the best
precision weight): the reference without v2's dynamic precision weights.
It must fail the limit that sound runs of the program pass. Run on the
card:

    python -m pytest -m gpu bench/tests/test_bench_control.py -s

It prints the control's count of wrong answers a seed (PERF.md).
"""
import json
import os

import pytest
import torch

from bench.harness import core, inputs
from bench.reference import mct as ref_mct

SEEDS = [int(s) for s in os.environ.get(
    "BENCH_CONTROL_SEEDS", "3000000011,3000000012,3000000013").split(",")]


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
