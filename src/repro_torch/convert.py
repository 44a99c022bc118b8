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
from repro_torch.models.transformer import (attn_runs, vlm_segments,
                                            xlstm_segments)

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


# leaves the reference keeps in float32 whatever ``param_dtype`` is, by
# (owning dict, name)
_FLOAT32_LEAVES = frozenset({
    ("mamba", "dt_bias"), ("mamba", "a_log"), ("mamba", "d_skip"),
    ("m", "w_ig"), ("m", "w_fg"), ("m", "b_fg"), ("m", "b_ig"),
    ("s", "b"), ("moe", "router"), ("cross", "gate")})


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, *,
                      device="cuda") -> Dict[str, Any]:
    """The port's parameters from the JAX package's parameter pytree, given
    as float32 numpy arrays (``np.asarray(x, np.float32)`` on each leaf;
    bf16 to fp32 is exact), cast to ``cfg.param_dtype`` on ``device``
    except the leaves the reference keeps in float32 (Mamba's ``dt_bias``,
    ``a_log``, ``d_skip``; the mLSTM gates; the sLSTM bias; the MoE router;
    the cross-attention gate).

    The weight layout is the reference's: a projection is ``(d_in, d_out)``
    and applied as ``x @ w``; the embedding is ``(vocab, d_model)``; MoE
    experts stay stacked ``(E, d_in, d_out)``. The reference stacks layers
    along leading axes; the port unstacks them into lists of per-layer
    dicts, in layer order:

    - ``blocks`` of uniform archs: one list per run of ``attn_runs``, from
      the run's leaves of shape (n, ...) (hybrid runs carry ``mamba``);
    - vlm ``blocks``: one list per segment, from (n_seg, inner, ...);
      ``cross``: one dict per segment, from (n_seg, ...);
    - ssm ``mblocks``: one list per segment, from (n_seg, per - 1, ...);
      ``sblocks``: one dict per segment, from (n_seg, ...).
    """
    dev = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)

    def layer(sub: Dict[str, Any], idx: tuple, owner: str) -> Dict[str, Any]:
        out = {}
        for k, v in sub.items():
            if isinstance(v, dict):
                out[k] = layer(v, idx, k)
            else:
                keep = (owner, k) in _FLOAT32_LEAVES
                out[k] = torch.tensor(np.asarray(v, np.float32)[idx]).to(
                    dev, torch.float32 if keep else dt)
        return out

    def lead(sub: Dict[str, Any]) -> tuple:
        """The shape of a stacked tree's first leaf (its leading axes are
        the stacking axes)."""
        v = sub
        while isinstance(v, dict):
            v = next(iter(v.values()))
        return np.shape(v)

    out = layer({k: tree[k] for k in ("embed", "unembed") if k in tree},
                (), "")
    out["norm_f"] = layer(tree["norm_f"], (), "norm_f")
    if cfg.family == "ssm":
        n_seg, per = xlstm_segments(cfg)
        if lead(tree["mblocks"])[:2] != (n_seg, per - 1):
            raise ValueError(f"mblocks stacked {lead(tree['mblocks'])[:2]}, "
                             f"the config has ({n_seg}, {per - 1})")
        out["mblocks"] = [[layer(tree["mblocks"], (s, i), "mblock")
                           for i in range(per - 1)] for s in range(n_seg)]
        out["sblocks"] = [layer(tree["sblocks"], (s,), "sblock")
                          for s in range(n_seg)]
        return out
    if cfg.cross_attn_every:
        n_seg, inner = vlm_segments(cfg), cfg.cross_attn_every
        if lead(tree["blocks"])[:2] != (n_seg, inner):
            raise ValueError(f"blocks stacked {lead(tree['blocks'])[:2]}, "
                             f"the config has ({n_seg}, {inner})")
        out["blocks"] = [[layer(tree["blocks"], (s, i), "block")
                          for i in range(inner)] for s in range(n_seg)]
        out["cross"] = [layer(tree["cross"], (s,), "cross")
                        for s in range(n_seg)]
        return out
    runs = attn_runs(cfg)
    if len(tree["blocks"]) != len(runs):
        raise ValueError(f"{len(tree['blocks'])} stacked runs, the config "
                         f"has {len(runs)}")
    out["blocks"] = [[layer(run, (i,), "block") for i in range(n)]
                     for run, (n, _, _) in zip(tree["blocks"], runs)]
    return out
