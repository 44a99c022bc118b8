"""BENCHMARK.json against the benchmark's contract, every name resolving to
its files, and a tiny CPU dry run of each traffic driver that loads no
module of JAX or the JAX package."""
import json
import re
import subprocess
import sys
from pathlib import Path

from bench.harness import core

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert all(TEXT.match(w) for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # the full check with 24 cells fits its time
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert TEXT.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and TEXT.match(w["why"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


def test_every_cell_resolves_and_reports_what_its_metrics_move():
    configs = {c["name"] for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        res = core.resolve(w["name"], SPEC)
        used.add(w["config"])
        e2e = {m["name"] for m in res["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert res["per_layer"]
        core.load_driver(res["traffic"]["driver"])
        for m in SPEC["per_layer"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                assert m["moves"] in e2e, (w["name"], m["name"])
    assert used == configs
    for m in SPEC["per_layer"]:
        assert callable(core.load_reader(m["name"]).read)
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in SPEC["workloads"]}


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "mct-search",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


DRY = """
import sys, json
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from bench.tests import test_bench_faults as f
for cell in ("mct-search", "mct-encoded"):
    out = f._run(cell, seed=2**31 + 5)
    assert out["correct"], (cell, out["checks"])
print(json.dumps(sorted(sys.modules)))
"""


def test_dry_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", DRY.format(root=str(ROOT))],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops
