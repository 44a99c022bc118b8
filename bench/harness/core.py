"""One run of one cell: resolve it by name, set it up, measure, check, print.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- the configuration ``bench/configs/<config>.json``, the deployment's
  sizes and the guarantees it states;
- the traffic mix ``bench/traffic/<traffic>.json``, whose ``driver`` names
  one of the general generators in ``bench/harness/drivers/`` and whose
  other keys are that generator's parameters;
- each per-layer metric ``bench/metrics/<name>.py``, a reader with
  ``read(run) -> float | None`` over the traced run (``TracedRun``).

A driver is a class ``Driver(cell, config, traffic, seed, device, trace)``
with ``setup()``, ``window(seconds, profile_at)`` (runs the load, profiles
from ``profile_at`` seconds into it when that is not None, returns the
``TracedRun`` data), ``end_to_end(run)`` (name -> value), ``check(run)``
(name -> (value, limit, ok)), ``host_spans(run)``, ``GAP_PRIORITY``,
``release()`` and, where its readers need more than the window gave, a
``trace_data(run)`` that adds it after the memory peak is read.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# where the traced run's profiled sub-window starts, as a share of the
# window: past the window's first seconds, where the load settles
PROFILE_AT = 0.3


def prepare_environment() -> None:
    """Caches inside the checkout at fixed paths; no library may load JAX
    on the program's behalf; the program's sources on the path."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_config(name: str) -> dict:
    return _load_json("configs", name)


def _load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"{kind} {name!r}: no {path}")
    return json.loads(path.read_text())


def resolve(workload: str, spec: Optional[dict] = None) -> dict:
    """The cell ``workload`` with its configuration, traffic and metrics."""
    spec = spec or load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]

    def applies(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if applies(m)
             and m["moves"] in e2e_names]
    return {"cell": cell,
            "config": _load_json("configs", cell["config"]),
            "traffic": _load_json("traffic", cell["traffic"]),
            "end_to_end": e2e, "per_layer": layer}


def load_reader(name: str):
    """The per-layer metric ``name``'s reader module."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return importlib.import_module(f"bench.harness.drivers.{name}").Driver


@dataclass
class TracedRun:
    """What one run hands the per-layer readers: the window's bounds on the
    host clock, the driver's records (``data``) and, with ``--trace 1``,
    the profiled sub-window's ``DeviceTrace``."""
    t0: float
    t1: float
    data: Dict[str, object] = field(default_factory=dict)
    device: Optional[object] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_info(device) -> dict:
    import torch
    info = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "count": 1}
    if device.type == "cuda":
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits", "-i",
                 str(device.index or 0)],
                capture_output=True, text=True, timeout=20)
            info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
        except (OSError, ValueError, IndexError,
                subprocess.TimeoutExpired) as e:
            print(f"nvidia-smi: power limit not read ({e})", file=sys.stderr)
    else:
        info["memory_peak_bytes"] = 0
    return info


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", config_overrides: Optional[dict] = None,
        traffic_overrides: Optional[dict] = None) -> dict:
    """One run of the cell; returns the result line's object. ``device``,
    ``config_overrides`` and ``traffic_overrides`` exist for the CPU tests
    (tiny sizes); ``bench/run.py`` passes none of them."""
    import torch
    prepare_environment()
    res = resolve(workload)
    config = {**res["config"], **(config_overrides or {})}
    traffic = {**res["traffic"], **(traffic_overrides or {})}
    dev = torch.device(device)
    Driver = load_driver(traffic["driver"])
    t_setup = time.perf_counter()
    drv = Driver(res["cell"], config, traffic, seed, dev, trace)
    drv.setup()
    setup_s = time.perf_counter() - t_setup
    # the inputs built in set-up live to the end: keep the collector from
    # walking them again and again inside the window
    gc.freeze()

    tr = drv.window(seconds, PROFILE_AT * seconds if trace else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    device_info = card_info(dev)
    bad = loaded_forbidden()
    if bad:
        raise SystemExit(f"modules loaded that the port must not load: {bad}")

    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        if hasattr(drv, "trace_data"):
            drv.trace_data(tr)
        for m in res["per_layer"]:
            v = load_reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr.device is not None:
            device_info["busy_s"] = tr.device.busy_s()
            device_info["window_s"] = tr.device.window_s
            breakdown = {
                "device_ops": tr.device.top_ops(),
                "idle_gaps": tr.device.idle_by_label(
                    drv.host_spans(tr), drv.GAP_PRIORITY)}
    else:
        values = drv.end_to_end(tr)
        values["setup_s"] = setup_s
        for m in res["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}

    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(tr)
    correct = all(ok for _, _, ok in checks.values())
    out = {"correct": correct, "attempted": int(tr.data["attempted"]),
           "failed": int(tr.data["failed"]), "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim, _) in checks.items()}
    return out
