"""Port copy of ``repro.core.encoder``: host-side numpy, returning the
(B, C) int32 kernel input. Kept as a copy because importing ``repro``
loads JAX.

Query encoder — the paper's *Encoder* module (§4.1).

Adapts software data representations (raw ids, code-share fields) to the
dense dictionary-encoded form the accelerator consumes. Cross-matching
criteria (v2 §3.2.3/3.2.4) are resolved HERE: the marketing vs operating
carrier / flight-number is selected by the code-share indicator, so the
kernel stays a generic conjunction engine.

Vectorised (numpy) — in the deployed system this runs on the host,
pipelined with the previous batch's kernel execution.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.compiler import OOV_CODE, CompiledRuleTable
from repro_torch.core.rules import WILDCARD


def queries_to_arrays(queries: Sequence[Dict[str, int]]) -> Dict[str, np.ndarray]:
    """AoS -> SoA: list of query dicts to arrays per field."""
    if not queries:
        return {}
    keys = set()
    for q in queries:
        keys.update(q.keys())
    return {k: np.asarray([q.get(k, 0) for q in queries], np.int64)
            for k in sorted(keys)}


def encode(table: CompiledRuleTable, fields: Dict[str, np.ndarray]
           ) -> np.ndarray:
    """Encode raw query fields into the (B, C) int32 kernel input."""
    n = len(next(iter(fields.values())))
    out = np.zeros((n, table.n_cols), np.int32)
    for j, col in enumerate(table.columns):
        if col.cross_fields is not None:
            # cross-matching (v2): select the query field by the code-share
            # indicator; the kernel stays a generic conjunction engine.
            primary, fallback, cs_f = col.cross_fields
            cs = fields[cs_f].astype(bool)
            raw = np.where(cs, fields[primary], fields[fallback]) \
                .astype(np.int64)
        else:
            src = col.source
            raw = fields[src].astype(np.int64)
        if col.kind == "cat":
            d = table.dictionaries[col.source]
            lut_keys = np.fromiter(d.keys(), np.int64, len(d))
            lut_vals = np.fromiter(d.values(), np.int64, len(d))
            codes = np.full(raw.shape, int(OOV_CODE), np.int64)
            if len(d):
                sort = np.argsort(lut_keys)
                pos = np.searchsorted(lut_keys[sort], raw)
                pos = np.clip(pos, 0, len(d) - 1)
                hit = lut_keys[sort][pos] == raw
                codes = np.where(hit, lut_vals[sort][pos], codes)
            out[:, j] = codes.astype(np.int32)
        else:  # range / range_lo / range_hi: raw numeric value
            out[:, j] = raw.astype(np.int32)
    return out


def encode_queries(table: CompiledRuleTable,
                   queries: Sequence[Dict[str, int]]) -> np.ndarray:
    return encode(table, queries_to_arrays(queries))
