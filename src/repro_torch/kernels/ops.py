"""Wrappers around the rule-match kernel: the padded and packed table, batch
sorting, engine-lane splitting, and the partitioned (NFA-prefix-pruning
analog) mode.

Port of ``repro.kernels.ops``. ``match_rules`` is the public op.
``partitioned=True`` buckets queries by the partition criterion (airport) —
the dense analog of the NFA's first-level fanout — and matches each query
only against its partition's rule block plus the wildcard block.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels.rule_match import (criterion_order, pack,
                                            rule_match_packed)

_BIG = 2 ** 30
MAX_GATHER_BYTES = 1 << 30   # bounds gathered by one partitioned-match chunk


def _pad_to(x, m, axis, value):
    pad = (-x.shape[axis]) % m
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


class DeviceRuleTable(NamedTuple):
    """Device-resident compiled rule table (criterion-major layouts), and
    the kernel's packed form of it (``rule_match.pack``)."""
    mins_t: torch.Tensor     # (C, Rp) int32
    maxs_t: torch.Tensor     # (C, Rp)
    weights: torch.Tensor    # (1, Rp) (-1 padding)
    decisions: torch.Tensor  # (Rp,)
    rule_ids: torch.Tensor   # (Rp,)
    n_rules: int
    crit_order: torch.Tensor  # (C,) int32: the kernel's criterion order
    bounds: torch.Tensor      # (C, Rp', 2) (base, span), rows in crit_order
    weights_k: torch.Tensor   # (Rp',) -1 where a rule can never match
    lead_col: int             # crit_order[0]: the batch's sort key
    # partitioned-mode blocks (optional)
    part_mins: Optional[torch.Tensor] = None   # (NP, Pmax, C)
    part_maxs: Optional[torch.Tensor] = None
    part_w: Optional[torch.Tensor] = None      # (NP, Pmax)
    part_rows: Optional[torch.Tensor] = None   # (NP, Pmax) row in dense table
    partition_col: int = 0


def device_table(table, tile_r: int = 512, partitioned: bool = False,
                 max_block: Optional[int] = None, *,
                 device="cuda") -> DeviceRuleTable:
    """Upload a CompiledRuleTable; optionally build partition blocks.

    Padding rules never match (min 1 > max 0) and carry weight -1, decision
    0 and rule id -1. The kernel's criterion order is estimated from the
    unpadded table and the packed table built here, once per upload. The
    partition blocks are gathered on the device, in place, so the host never
    holds the (NP, Pmax, C) copies.
    """
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    mins, maxs, w = put(table.mins), put(table.maxs), put(table.weights)
    mins_t = _pad_to(mins.T.contiguous(), tile_r, 1, 1)
    maxs_t = _pad_to(maxs.T.contiguous(), tile_r, 1, 0)   # min>max: never matches
    wp = _pad_to(w[None, :], tile_r, 1, -1)
    dec = _pad_to(put(table.decisions), tile_r, 0, 0)
    rid = _pad_to(put(table.rule_ids), tile_r, 0, -1)
    n = table.n_rules
    crit = criterion_order(mins_t[:, :n], maxs_t[:, :n])
    bounds, weights_k = pack(mins_t, maxs_t, wp, crit)

    kw = {}
    if partitioned:
        NP = table.n_partitions
        counts = np.diff(table.part_offsets)
        wc = table.wildcard_rows
        pmax = int(counts.max() if len(counts) else 0) + len(wc)
        if max_block:
            pmax = min(pmax, max_block)
        pmax = max(pmax, 1)
        rows = np.full((NP, pmax), -1, np.int64)
        for p in range(NP):
            own = table.part_order[table.part_offsets[p]:
                                   table.part_offsets[p + 1]]
            blk = np.concatenate([own, wc])[:pmax]
            rows[p, :len(blk)] = blk
        invalid = torch.as_tensor(rows < 0, device=dev)
        safe = torch.as_tensor(np.where(rows >= 0, rows, 0), device=dev)
        pm = mins[safe].masked_fill_(invalid[..., None], 1)
        px = maxs[safe].masked_fill_(invalid[..., None], 0)
        pw = w[safe].masked_fill_(invalid, -1)
        kw = dict(part_mins=pm, part_maxs=px, part_w=pw,
                  part_rows=safe.to(torch.int32),
                  partition_col=table.partition_col)

    return DeviceRuleTable(mins_t=mins_t, maxs_t=maxs_t, weights=wp,
                           decisions=dec, rule_ids=rid,
                           n_rules=table.n_rules, crit_order=crit,
                           bounds=bounds, weights_k=weights_k,
                           lead_col=int(crit[0]), **kw)


def _lookup(dt: DeviceRuleTable, w, idx):
    safe = idx.clamp_min(0).long()
    dec = torch.where(idx >= 0, dt.decisions[safe], -1)
    rid = torch.where(idx >= 0, dt.rule_ids[safe], -1)
    return dec, w, rid


def match_rules(queries, dt: DeviceRuleTable, *, backend: str = "kernel",
                n_engines: int = 1, tracer=None):
    """queries: (B, C) int32 on the table's device. Returns (decision, weight,
    rule_id), (B,) int32 each.

    ``backend="kernel"`` runs the rule-match kernel on the packed table
    (its plain version for CPU tensors), one launch per lane, ``"ref"`` the
    plain version on the whole batch. n_engines splits the batch into that
    many kernel lanes (the paper's 'NFA evaluation engines per kernel'
    axis); the outputs do not depend on it. The kernel takes any batch size
    and tiles the rules itself, so nothing is padded here.

    With a ``Tracer`` (``tracer``), the calling thread's laps (opened by the
    caller with ``Tracer.lap_start``) go on with ``lane.sort`` and
    ``lane.launch`` from each lane's ``rule_match_packed`` (for ``"ref"``,
    one ``lane.launch`` over the plain version); the caller's next lap
    takes the concatenation and the lookup.
    """
    if backend not in ("kernel", "ref"):
        raise ValueError(f"backend must be 'kernel' or 'ref', not {backend!r}")
    if backend == "ref":
        w, idx = ref_mod.rule_match_ref(queries, dt.mins_t.T, dt.maxs_t.T,
                                        dt.weights[0])
        if tracer is not None:
            tracer.lap("lane.launch")
    else:
        outs = [match_lane(lane, dt, tracer=tracer)
                for lane in queries.tensor_split(n_engines)]
        w = torch.cat([bw for bw, _ in outs])
        idx = torch.cat([bi for _, bi in outs])
    return _lookup(dt, w, idx)


def match_lane(lane, dt: DeviceRuleTable, *, tracer=None):
    """One engine lane on the packed table: the kernel takes the lane's
    queries sorted by their code in the leading criterion, so that a warp's
    queries pass or fail it together, and writes the results back in the
    lane's order. lane: (B, C) int32. Returns (best_w (B,), best_i (B,))."""
    return rule_match_packed(lane, dt.bounds, dt.weights_k, dt.crit_order,
                             sort_col=dt.lead_col, tracer=tracer)


def match_rules_partitioned(queries, dt: DeviceRuleTable):
    """Partition-pruned matching (NFA first-level fanout analog).

    Each query gathers its airport-partition rule block (padded, wildcard
    rules appended) and matches only against it: per-query work drops from
    R to Pmax. queries: (B, C) int32. The reference gathers (B, Pmax, C) at
    once, which at 160k rules and B = 4096 is about 41 GB; here the batch is
    walked in chunks whose gathered bounds stay under ``MAX_GATHER_BYTES``.
    """
    B, C = queries.shape
    NP, pmax = dt.part_w.shape
    chunk = max(1, MAX_GATHER_BYTES // (2 * pmax * C * 4))
    outs = []
    for s in range(0, B, chunk):
        q = queries[s:s + chunk]
        pid = q[:, dt.partition_col].clamp(0, NP - 1).long()
        mn = dt.part_mins[pid]                               # (b, Pmax, C)
        mx = dt.part_maxs[pid]
        w = dt.part_w[pid]                                   # (b, Pmax)
        rows = dt.part_rows[pid]
        ok = ((q[:, None, :] >= mn) & (q[:, None, :] <= mx)).all(dim=-1)
        score = torch.where(ok, w, -1)
        best = score.max(dim=1).values
        # lowest dense-table row among ties (matches dense-engine tie-break)
        row = torch.where(score == best[:, None], rows, _BIG).min(dim=1).values
        good = best >= 0
        outs.append(_lookup(dt, torch.where(good, best, -1),
                            torch.where(good, row, -1)))
    return tuple(torch.cat(parts) for parts in zip(*outs))
