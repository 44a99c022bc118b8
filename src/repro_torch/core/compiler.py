"""Port copy of ``repro.core.compiler``: the same dense interval table,
byte for byte. Kept as a copy because importing ``repro`` loads JAX.

Offline rule compiler — the accelerator analog of ERBIUM's NFA Optimiser /
Constraint Generator / NFA Parser (Fig. 2 of the paper).

Lowers a RuleSet to a dense interval table executed by the rule-match kernel:

- *Criteria ordering* (NFA Optimiser): columns ordered by estimated
  selectivity; the most selective high-cardinality criterion (airport) is
  chosen as the partition key (the analog of the NFA's first-level fanout).
- *Criteria merging* (v2, §3.2.1): each range criterion expands to two
  columns (value >= lo, value <= hi) — more "NFA steps", exactly like the
  standard's pair-of-values -> two-criteria change.
- *Dynamic range precision weights via overlap elimination* (v2, §3.2.2):
  overlapping flight-number ranges are split offline into disjoint
  sub-rules so the online reduction stays a plain max; weights use the
  ORIGINAL range size.
- *Cross-matching criteria* (v2, §3.2.3/3.2.4): resolved at encode time via
  the schema's cross_fields — the kernel stays a generic conjunction engine.
- *Dictionary building*: categorical raw values -> dense codes (frequency
  sorted); OOV raw values map to a sentinel that only matches wildcards.

The hardware engine never changes across rule-standard versions — all v1/v2
semantics live here, in software. (The paper's central maintainability
lesson.)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.rules import (RANGE_MAX, WILDCARD, Criterion, Rule, RuleSet)

INT_MAX = np.iinfo(np.int32).max - 1
OOV_CODE = np.int32(INT_MAX - 1)


@dataclass
class Column:
    name: str               # criterion name
    source: str             # source criterion
    kind: str               # "cat" | "range_lo" | "range_hi" | "range"
    weight: int
    cross_fields: Optional[Tuple[str, str, str]] = None


@dataclass
class CompiledRuleTable:
    columns: List[Column]
    mins: np.ndarray        # (R, C) int32
    maxs: np.ndarray        # (R, C) int32
    weights: np.ndarray     # (R,) int32
    decisions: np.ndarray   # (R,) int32
    rule_ids: np.ndarray    # (R,) int32 (source rule id, post-splitting)
    dictionaries: Dict[str, Dict[int, int]]
    version: int
    default_decision: int
    # partition table (NFA first-level fanout analog)
    partition_col: int
    n_partitions: int
    part_of_rule: np.ndarray       # (R,) partition id; -1 == wildcard
    part_order: np.ndarray         # (R,) rule indices sorted by partition
    part_offsets: np.ndarray       # (NP+1,)
    wildcard_rows: np.ndarray      # indices of wildcard-partition rules

    @property
    def n_rules(self) -> int:
        return int(self.mins.shape[0])

    @property
    def n_cols(self) -> int:
        return int(self.mins.shape[1])

    def memory_bytes(self) -> int:
        return sum(a.nbytes for a in
                   (self.mins, self.maxs, self.weights, self.decisions,
                    self.rule_ids, self.part_of_rule, self.part_order,
                    self.part_offsets))


def _selectivity(c: Criterion) -> float:
    if c.kind == "cat":
        return 1.0 / max(c.cardinality, 1)
    return 0.05


def _build_columns(schema: Sequence[Criterion], version: int) -> List[Column]:
    crits = sorted(schema, key=_selectivity)  # most selective first
    cols: List[Column] = []
    for c in crits:
        if c.kind == "cat":
            cols.append(Column(c.name, c.name, "cat", c.weight,
                               c.cross_fields))
        elif version >= 2:
            # criteria merging: one range -> two independent criteria
            cols.append(Column(c.name + ".lo", c.name, "range_lo", c.weight,
                               c.cross_fields))
            cols.append(Column(c.name + ".hi", c.name, "range_hi", 0,
                               c.cross_fields))
        else:
            cols.append(Column(c.name, c.name, "range", c.weight,
                               c.cross_fields))
    return cols


def _split_overlaps(ruleset: RuleSet, crit_name: str = "arr_flightno"
                    ) -> List[Rule]:
    """Offline overlap elimination (§3.2.2) on one flight-number criterion.

    Within groups of rules sharing all other bound values, overlapping
    ranges are split at each other's boundaries; atomic sub-ranges covered
    by several rules keep only the most precise one. Weights are computed
    from the ORIGINAL range size (v2 dynamic weight)."""
    if ruleset.version < 2:
        return list(ruleset.rules)
    groups: Dict[tuple, List[Rule]] = {}
    out: List[Rule] = []
    for r in ruleset.rules:
        v = r.values.get(crit_name, WILDCARD)
        if v == WILDCARD:
            out.append(r)
            continue
        key = tuple(sorted((k, vv if not isinstance(vv, tuple) else vv)
                           for k, vv in r.values.items() if k != crit_name))
        groups.setdefault(key, []).append(r)

    n_extra = 0
    for key, rs in groups.items():
        if len(rs) == 1:
            out.extend(rs)
            continue
        # check pairwise overlap
        ivs = [r.values[crit_name] for r in rs]
        bounds = sorted({b for lo, hi in ivs for b in (lo, hi + 1)})
        atoms = list(zip(bounds[:-1], bounds[1:]))
        overlap = any(
            sum(1 for lo, hi in ivs if lo <= a and a2 - 1 <= hi) > 1
            for a, a2 in atoms)
        if not overlap:
            out.extend(rs)
            continue
        # split: each atomic interval keeps the most precise covering rule
        for a_lo, a_hi in atoms:
            cover = [r for r in rs
                     if r.values[crit_name][0] <= a_lo
                     and a_hi - 1 <= r.values[crit_name][1]]
            if not cover:
                continue
            best = max(cover, key=lambda r: r.weight(ruleset.schema, 2))
            nv = dict(best.values)
            nv[crit_name] = (a_lo, a_hi - 1)
            sub = Rule(values=nv, decision=best.decision,
                       rule_id=best.rule_id)
            # keep ORIGINAL-range weight: stash it
            sub._orig_weight = best.weight(ruleset.schema, 2)  # type: ignore
            out.append(sub)
            n_extra += 1
        n_extra -= len(rs)
    return out


def compile_rules(ruleset: RuleSet) -> CompiledRuleTable:
    schema = ruleset.schema
    version = ruleset.version
    cols = _build_columns(schema, version)
    rules = _split_overlaps(ruleset) if version >= 2 else list(ruleset.rules)
    R, C = len(rules), len(cols)

    # dictionaries: frequency-sorted dense codes per cat criterion
    dicts: Dict[str, Dict[int, int]] = {}
    for c in schema:
        if c.kind != "cat":
            continue
        vals = [r.values.get(c.name, WILDCARD) for r in rules]
        uniq, cnt = np.unique([v for v in vals if v != WILDCARD],
                              return_counts=True)
        order = uniq[np.argsort(-cnt)]
        dicts[c.name] = {int(v): i for i, v in enumerate(order)}

    mins = np.zeros((R, C), np.int32)
    maxs = np.full((R, C), INT_MAX, np.int32)
    weights = np.zeros((R,), np.int32)
    decisions = np.zeros((R,), np.int32)
    rule_ids = np.zeros((R,), np.int32)

    for i, r in enumerate(rules):
        w = getattr(r, "_orig_weight", None)
        weights[i] = w if w is not None else r.weight(schema, version)
        decisions[i] = r.decision
        rule_ids[i] = r.rule_id
        for j, col in enumerate(cols):
            v = r.values.get(col.source, WILDCARD)
            if v == WILDCARD:
                continue
            if col.kind == "cat":
                code = dicts[col.source].get(int(v))
                if code is None:
                    code = int(OOV_CODE)
                mins[i, j] = maxs[i, j] = code
            elif col.kind == "range":
                mins[i, j], maxs[i, j] = int(v[0]), int(v[1])
            elif col.kind == "range_lo":
                mins[i, j] = int(v[0])
            else:  # range_hi
                maxs[i, j] = int(v[1])

    # partition table on the most selective high-cardinality cat criterion
    part_col = next(j for j, col in enumerate(cols)
                    if col.source == "airport")
    np_parts = len(dicts["airport"])
    part = np.where(mins[:, part_col] == maxs[:, part_col],
                    mins[:, part_col], -1).astype(np.int32)
    part[part == int(OOV_CODE)] = -1
    order = np.argsort(np.where(part < 0, np_parts, part),
                       kind="stable").astype(np.int32)
    sorted_part = np.where(part[order] < 0, np_parts, part[order])
    offsets = np.searchsorted(sorted_part, np.arange(np_parts + 1)
                              ).astype(np.int32)
    wildcard_rows = order[offsets[np_parts]:].astype(np.int32)

    return CompiledRuleTable(
        columns=cols, mins=mins, maxs=maxs, weights=weights,
        decisions=decisions, rule_ids=rule_ids, dictionaries=dicts,
        version=version, default_decision=ruleset.default_decision,
        partition_col=part_col, n_partitions=np_parts, part_of_rule=part,
        part_order=order, part_offsets=offsets, wildcard_rows=wildcard_rows)
