"""State carried across from the JAX package.

``table_from_numpy`` builds the port's ``CompiledRuleTable`` from the JAX
package's table given as plain data — ``dataclasses.asdict(table)``, with
numpy arrays and column dicts — so the port can match on exactly the table
the reference compiled. Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.core.compiler import Column, CompiledRuleTable

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
