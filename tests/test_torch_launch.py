"""The port's launch tooling (``repro_torch.launch``): the dry run as its own
process on small meshes, the cost analysis on known collectives and
products, the roofline, and the analytic model FLOPs against the JAX
package's.

The dry-run cases are the counterparts of ``test_dryrun_small.py``'s:
reduced gemma3-1b ``decode_32k`` on a 2x2 and a 2x2x2 fake fleet. The cost
analysis runs under PyTorch's ``fake`` backend and fake tensors in this
process, its group destroyed after each case.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.configs.base import all_cells, get_config
from repro_torch.launch import cost_analysis, roofline
from repro_torch.launch.dryrun import model_flops_for
from repro_torch.launch.mesh import init_distributed, make_mesh

REPO = Path(__file__).resolve().parents[1]


def _j_model_flops_for():
    """The reference's ``model_flops_for``; its dry-run module sets
    XLA_FLAGS when imported, which the import restores."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops_for as f
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return f


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory):
    """Both small-fleet dry runs, started together as processes of their
    own."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    runs = {}
    for mesh, shape in (("single", "2x2"), ("multi", "2x2x2")):
        runs[mesh] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "gemma3-1b", "--shape", "decode_32k", "--reduced", "--mesh",
             mesh, "--mesh-shape", shape, "--out", str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            preexec_fn=lambda: os.nice(10))  # below the suite's timing tests
    logs = {m: p.communicate(timeout=600)[0] for m, p in runs.items()}
    return {m: (runs[m].returncode, logs[m],
                out / f"gemma3-1b__decode_32k__{m}.json") for m in runs}


@pytest.mark.parametrize("mesh,n", [("single", 4), ("multi", 8)])
def test_dryrun_cell_small_mesh(dryrun_records, mesh, n):
    rc, log, path = dryrun_records[mesh]
    assert rc == 0, log[-3000:]
    rec = json.loads(path.read_text())
    assert rec["ok"]
    assert rec["n_devices"] == n
    assert rec["cost"]["num_partitions"] == n
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert rec["model_flops"] > 0
    assert rec["memory"]["cpu"]["Total"] > 0
    assert roofline.from_record(rec).step_s > 0


@pytest.fixture
def fake_mesh():
    init_distributed("fake", world_size=4)
    try:
        yield make_mesh((2, 2), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_cost_of_sharded_matmul(fake_mesh):
    """(m, k) split over data times (k, n) split over model: each rank
    multiplies its (m/2, k) by its (k, n/2), 2*m*n*k / 4 FLOPs, and no
    collective."""
    m, k, n = 64, 32, 48
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = distribute_tensor(torch.empty(m, k), fake_mesh,
                              [Shard(0), Replicate()])
        b = distribute_tensor(torch.empty(k, n), fake_mesh,
                              [Replicate(), Shard(1)])
        _, cost = cost_analysis.analyze(torch.matmul, a, b)
    assert cost["flops"] == 2 * m * n * k / 4
    assert cost["collective_counts"] == {}
    assert cost["num_partitions"] == 4


def test_cost_of_fsdp_gather(fake_mesh):
    """An FSDP weight (split over data) gathered whole: one all-gather over
    the 2-wide data axis, moving half the gathered bytes on the wire."""
    d, f = 64, 32
    with FakeTensorMode(allow_non_fake_inputs=True):
        w = distribute_tensor(torch.empty(d, f), fake_mesh,
                              [Shard(0), Replicate()])
        _, cost = cost_analysis.analyze(
            lambda t: t.redistribute(fake_mesh, [Replicate(), Replicate()]),
            w)
    assert cost["collective_counts"] == {"all-gather": 1}
    assert cost["collective_bytes"] == {"all-gather": d * f * 4}
    assert cost["collective_wire_bytes"] == d * f * 4 * (2 - 1) / 2


def test_roofline_from_record_and_table():
    rec = {"ok": True, "arch": "llama3.2-3b", "shape": "train_4k",
           "mesh": "16x16", "n_devices": 256, "model_flops": 2.0e18,
           "cost": {"flops": 1.0e16, "bytes": 2.0e12,
                    "collective_wire_bytes": 5.0e10}}
    r = roofline.from_record(rec)
    assert r.compute_s == pytest.approx(1.0e16 / 989e12)
    assert r.memory_s == pytest.approx(2.0e12 / 3.35e12)
    assert r.collective_s == pytest.approx(1.0)
    assert r.dominant == "compute"
    assert r.step_s == r.compute_s
    assert r.usefulness == pytest.approx(2.0e18 / (1.0e16 * 256))
    assert r.mfu_bound == pytest.approx(2.0e18 / (r.step_s * 989e12 * 256))
    assert roofline.from_record({"ok": False}) is None
    table = roofline.table_markdown([r])
    assert table.count("\n") == 3
    assert "| llama3.2-3b | train_4k | 16x16 |" in table
    assert "**compute**" in table


def test_load_all_filters_variants(tmp_path):
    base = {"ok": True, "arch": "a", "shape": "s", "mesh": "16x16",
            "n_devices": 256, "model_flops": 1.0,
            "cost": {"flops": 1.0, "bytes": 1.0,
                     "collective_wire_bytes": 0.0}}
    (tmp_path / "a.json").write_text(json.dumps(base))
    (tmp_path / "b.json").write_text(json.dumps(dict(base, variant="ws")))
    (tmp_path / "c.json").write_text(json.dumps({"ok": False}))
    assert len(roofline.load_all(tmp_path)) == 1
    assert len(roofline.load_all(tmp_path, variant=None)) == 2
    assert len(roofline.load_all(tmp_path, variant="ws")) == 1


@pytest.mark.parametrize("arch", sorted({a for a, _ in all_cells()}))
def test_model_flops_match_reference(arch):
    from repro.configs.base import get_config as j_get_config
    j_flops = _j_model_flops_for()
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    for cell in cfg.shape_cells():
        assert model_flops_for(cfg, cell) == j_flops(j_cfg, cell)
