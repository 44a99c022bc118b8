"""Quickstart, from the PyTorch port: the ERBIUM rule engine in five steps
and one loss of a model from the registry; the port's copy of
examples/quickstart.py.

Runs on the card unless ``--device cpu`` is given (no card: an error,
never a fall back). On the card the engine runs the CUDA rule-match kernel
and the model is gemma3-1b at full width (bf16); on the CPU the engine runs
the kernel's plain version and the model is gemma3-1b reduced.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import (ErbiumEngine, compile_rules, generate_queries,
                              generate_rules)
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model, make_inputs

ARCH = "gemma3-1b"


def lm_loss(device="cuda", *, cfg=None, params=None) -> float:
    """One next-token loss on a (2, 32) batch from ``default_rng(0)``:
    ``cfg`` defaults to the arch at full width on the card and reduced on
    the CPU, ``params`` to the model's initialisation from seed 0."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config(ARCH)
        cfg = cfg.reduced() if dev.type == "cpu" else cfg
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    batch = make_inputs(cfg, 2, 32, rng=np.random.default_rng(0), device=dev)
    with torch.no_grad():
        return float(model.loss(params, batch))


def main(device="cuda"):
    dev = resolve_device(device)
    # 1. offline: rules -> compiled dense interval table (the "NFA")
    ruleset = generate_rules(2_000, version=2, seed=0)
    table = compile_rules(ruleset)
    print(f"compiled {table.n_rules} rules x {table.n_cols} criteria "
          f"({table.memory_bytes() / 1e6:.1f} MB table, "
          f"{table.n_partitions} airport partitions)")

    # 2. online: the engine (the CUDA kernel on the card), two lanes
    engine = ErbiumEngine(table, device=dev, n_engines=2)

    # 3. queries from the Domain-Explorer side
    queries = generate_queries(ruleset, 1_000, seed=1)
    decisions, weights, _ = (x.cpu().numpy()
                             for x in engine.match_queries(queries))
    print(f"matched {np.mean(weights >= 0):.0%} of {len(queries)} MCT "
          f"queries on {dev}; median MCT = "
          f"{np.median(decisions[decisions >= 0]):.0f} min")

    # 4. hot rule update (the paper's 500 us NFA reload)
    us = engine.reload(generate_rules(2_000, version=2, seed=99))
    print(f"rule hot-reload (device table swap): {us:.0f} us")

    # 5. the LM side of the framework: one of the 10 assigned archs
    size = "reduced" if dev.type == "cpu" else "full width"
    loss = lm_loss(dev)
    print(f"{ARCH} ({size}) loss = {loss:.3f}")
    return loss


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
