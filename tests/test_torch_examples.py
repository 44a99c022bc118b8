"""The port's examples (``examples/torch_*.py``) on the CPU: each ``main``
runs with ``device="cpu"`` (the kernels' plain versions, the reduced
models), and the quickstart's model loss equals the JAX package's on the
same parameters (carried across by ``convert.params_from_numpy``) and the
same batch, in float32 within 1e-5."""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "examples", ROOT / "benchmarks"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch_async_serving  # noqa: E402
import torch_common  # noqa: E402
import torch_integration_study  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_search_engine  # noqa: E402
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models.registry import build_model as j_build_model  # noqa: E402
from repro.models.registry import make_inputs as j_make_inputs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

LOSS_TOL = 1e-5


def _f32(cfg):
    return dataclasses.replace(cfg.reduced(), dtype="float32",
                               param_dtype="float32")


def test_quickstart_main_cpu(capsys):
    loss = torch_quickstart.main("cpu")
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert "matched" in out and "hot-reload" in out and "(reduced)" in out


def test_quickstart_loss_equals_the_references():
    arch = torch_quickstart.ARCH
    j_cfg, cfg = _f32(j_get_config(arch)), _f32(get_config(arch))
    j_model = j_build_model(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    j_batch = j_make_inputs(j_cfg, 2, 32, rng=np.random.default_rng(0))
    want = float(j_model.loss(j_params, j_batch))
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  j_params)
    got = torch_quickstart.lm_loss(
        "cpu", cfg=cfg, params=params_from_numpy(tree, cfg, device="cpu"))
    assert abs(got - want) <= LOSS_TOL, (got, want)


def test_serve_search_engine_main_cpu():
    results, outs = torch_serve_search_engine.main("cpu")
    assert results and all(len(r.decisions) == len(r.weights)
                           for r in results)
    assert len(outs) == 12
    assert all(len(o.tokens) == 4 for o in outs)


def test_async_serving_main_cpu(capsys):
    torch_async_serving.main("cpu", smoke=True)
    out = capsys.readouterr().out
    assert "open-loop sweep" in out and "replica(s)" in out
    assert out.rstrip().endswith("done.")


def test_integration_study_main_cpu(monkeypatch):
    monkeypatch.setitem(torch_common.SIZES, "cpu", (512, 512))
    bench = torch_integration_study.main("cpu")
    assert (bench.n_rules, bench.n_queries) == (512, 512)
    prefixes = {r["name"].split("/")[0] for r in bench.results}
    assert {"fig4", "fig6", "fig7_engines", "fig11", "fig12", "table2",
            "table3", "h100_balance"} <= prefixes
    assert all(r["device"] == "cpu" for r in bench.results)
