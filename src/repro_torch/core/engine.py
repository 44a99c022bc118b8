"""ERBIUM engine (online side): Host-Executor + accelerator-kernel analog.

Port of ``repro.core.engine``. ``ErbiumEngine`` owns the device-resident rule
table and exposes batched matching; ``n_engines`` reproduces the paper's 'NFA
evaluation engines per kernel' axis (parallel lanes over a batch).

Rule hot-reload (the paper's 500 µs NFA update) swaps the device table
buffers without touching the compiled matcher.

CPU baselines (paper §5.2): ``cpu_match_numpy`` — the optimised vectorised
implementation standing in for the refactored C++ MCT v2 module; and
``cpu_match_python`` — a per-query scalar loop (the pre-optimisation shape).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.compiler import CompiledRuleTable, compile_rules
from repro_torch.core.encoder import encode, queries_to_arrays
from repro_torch.core.rules import RuleSet
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import ops


class ErbiumEngine:
    def __init__(self, table: CompiledRuleTable, *, device="cuda",
                 n_engines: int = 1, tile_r: int = 512,
                 backend: str = "kernel", partitioned: bool = False):
        self.device = resolve_device(device)
        self.table = table
        self.n_engines = n_engines
        self.tile_r = tile_r     # the device table's padding
        self.backend = backend
        self.partitioned = partitioned
        self.dt = ops.device_table(table, tile_r=tile_r,
                                   partitioned=partitioned,
                                   device=self.device)
        self.reload_us: Optional[float] = None

    # -- online path ---------------------------------------------------------
    def encode(self, fields: Dict[str, np.ndarray]) -> np.ndarray:
        return encode(self.table, fields)

    def match(self, encoded) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
        """(decision, weight, rule_id), each (B,) int32 on the engine's
        device. ``encoded`` is a (B, C) numpy array or tensor."""
        q = torch.as_tensor(encoded, dtype=torch.int32, device=self.device)
        if self.partitioned:
            return ops.match_rules_partitioned(q, self.dt)
        return ops.match_rules(q, self.dt, backend=self.backend,
                               n_engines=self.n_engines)

    def encode_queries_host(self, queries: Sequence[Dict[str, int]]
                            ) -> np.ndarray:
        """Host-side half of the online path: raw query dicts -> dense
        (B, C) int32 kernel input. Pure numpy."""
        return self.encode(queries_to_arrays(list(queries)))

    def match_queries(self, queries: Sequence[Dict[str, int]]):
        return self.match(self.encode_queries_host(queries))

    # -- rule update (hot reload) --------------------------------------------
    def reload(self, ruleset: RuleSet) -> float:
        """Swap in a new rule set; returns device-swap time in µs (the
        analog of the paper's 500 µs NFA reload; compilation is offline)."""
        table = compile_rules(ruleset)
        synchronize(self.device)
        t0 = time.perf_counter()
        dt = ops.device_table(table, tile_r=self.tile_r,
                              partitioned=self.partitioned,
                              device=self.device)
        synchronize(self.device)
        us = (time.perf_counter() - t0) * 1e6
        self.table, self.dt, self.reload_us = table, dt, us
        return us


# ---------------------------------------------------------------------------
# CPU baselines (copied from the reference; numpy only)
# ---------------------------------------------------------------------------


def cpu_match_numpy(table: CompiledRuleTable, encoded: np.ndarray,
                    block: int = 4096):
    """Optimised vectorised CPU implementation (the refactored-C++ stand-in).
    Uses the same partition pruning available to the software module."""
    B = encoded.shape[0]
    dec = np.full((B,), -1, np.int32)
    wgt = np.full((B,), -1, np.int32)
    rid = np.full((B,), -1, np.int32)
    mins, maxs, w = table.mins, table.maxs, table.weights
    for s in range(0, B, block):
        q = encoded[s:s + block]
        ok = (q[:, None, :] >= mins[None]) & (q[:, None, :] <= maxs[None])
        m = ok.all(-1)
        score = np.where(m, w[None, :], -1)
        best = score.max(1)
        idx = score.argmax(1)
        good = best >= 0
        dec[s:s + block] = np.where(good, table.decisions[idx], -1)
        wgt[s:s + block] = best
        rid[s:s + block] = np.where(good, table.rule_ids[idx], -1)
    return dec, wgt, rid


def cpu_match_python(table: CompiledRuleTable, encoded: np.ndarray,
                     limit: Optional[int] = None):
    """Naive per-query scalar loop (pre-optimisation baseline)."""
    B = encoded.shape[0] if limit is None else min(limit, encoded.shape[0])
    mins, maxs, w = table.mins, table.maxs, table.weights
    out = np.full((B, 3), -1, np.int64)
    for i in range(B):
        q = encoded[i]
        best_w, best_r = -1, -1
        for r in range(mins.shape[0]):
            okr = True
            for c in range(mins.shape[1]):
                v = q[c]
                if v < mins[r, c] or v > maxs[r, c]:
                    okr = False
                    break
            if okr and w[r] > best_w:
                best_w, best_r = int(w[r]), r
        if best_r >= 0:
            out[i] = (table.decisions[best_r], best_w,
                      table.rule_ids[best_r])
    return out[:, 0], out[:, 1], out[:, 2]
