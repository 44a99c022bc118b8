"""State carried across from the JAX package.

``table_from_numpy`` builds the port's ``CompiledRuleTable`` from the JAX
package's table given as plain data — ``dataclasses.asdict(table)``, with
numpy arrays and column dicts — so the port can match on exactly the table
the reference compiled. ``params_from_numpy`` does the same for a model's
parameters. Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compiler import Column, CompiledRuleTable
from repro_torch.device import resolve_device
from repro_torch.models.common import dtype_of
from repro_torch.models.transformer import attn_runs, check_supported

_INT32_ARRAYS = ("mins", "maxs", "weights", "decisions", "rule_ids",
                 "part_of_rule", "part_order", "part_offsets", "wildcard_rows")


def table_from_numpy(d: Dict[str, Any]) -> CompiledRuleTable:
    cols = []
    for c in d["columns"]:
        c = dict(c)
        if c.get("cross_fields") is not None:
            c["cross_fields"] = tuple(c["cross_fields"])
        cols.append(Column(**c))
    arrays = {k: np.asarray(d[k], np.int32) for k in _INT32_ARRAYS}
    dicts = {name: {int(k): int(v) for k, v in m.items()}
             for name, m in d["dictionaries"].items()}
    return CompiledRuleTable(
        columns=cols, dictionaries=dicts, version=int(d["version"]),
        default_decision=int(d["default_decision"]),
        partition_col=int(d["partition_col"]),
        n_partitions=int(d["n_partitions"]), **arrays)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cuda") -> Dict[str, Any]:
    """The port's parameters from the JAX package's parameter pytree, given
    as float32 numpy arrays (``np.asarray(x, np.float32)`` on each leaf;
    bf16 to fp32 is exact), cast to ``cfg.param_dtype`` on ``device``.

    The weight layout is the reference's: a projection is ``(d_in, d_out)``
    and applied as ``x @ w``; the embedding is ``(vocab, d_model)``. The
    reference stacks each run of ``attn_runs`` along a leading axis of
    length n; the port holds each run as a list of n per-layer dicts, in
    layer order.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)

    def put(a):
        return torch.tensor(np.asarray(a, np.float32)).to(dev, dt)

    def layer(run: Dict[str, Any], i: int) -> Dict[str, Any]:
        return {k: layer(v, i) if isinstance(v, dict) else put(v[i])
                for k, v in run.items()}

    runs = attn_runs(cfg)
    if len(tree["blocks"]) != len(runs):
        raise ValueError(f"{len(tree['blocks'])} stacked runs, the config "
                         f"has {len(runs)}")
    out = {k: put(tree[k]) for k in ("embed", "unembed") if k in tree}
    out["norm_f"] = {k: put(v) for k, v in tree["norm_f"].items()}
    out["blocks"] = [[layer(run, i) for i in range(n)]
                     for run, (n, _, _) in zip(tree["blocks"], runs)]
    return out
