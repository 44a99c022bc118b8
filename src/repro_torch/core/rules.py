"""Port copy of ``repro.core.rules``, unchanged in behaviour: the same
numpy ``default_rng`` seeds give the same rules and queries. The port keeps
its own copy because importing anything under ``repro`` loads JAX.

MCT rule model: criteria schema (v1/v2), rules, queries, generators.

Mirrors the paper's structure (§2.3, §3.2): rules are conjunctions of
criteria over airports/terminals/regions/carriers/flight-number ranges/time
frames, standardised by IATA. v1 rules are independent predicates with ranges
as a pair-of-values criterion; v2 adds criteria merging (ranges expand to two
criteria), dynamic precision weights for ranges, cross-matching
marketing/operating carriers via the code-share indicator, and code-share
flight-number ranges.

The *actual* rules have 34 raw criteria consolidating to 26 (v2) / 22 (v1);
our synthetic schema reproduces those counts and realistic cardinalities.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WILDCARD = -1
RANGE_MAX = 2 ** 30


@dataclass(frozen=True)
class Criterion:
    name: str
    kind: str                 # "cat" | "range"
    cardinality: int = 0      # cat: dictionary size
    domain: Tuple[int, int] = (0, 9_999)  # range: value domain
    weight: int = 1           # intrinsic precision weight
    # cross-matching (v2): this criterion's query value is selected between
    # two query fields by the code-share indicator field:
    # (field used when code-share, field used when not, cs_flag field)
    cross_fields: Optional[Tuple[str, str, str]] = None


def schema_v1() -> List[Criterion]:
    """22 consolidated criteria; ranges are native pair-of-values."""
    cats = [
        Criterion("airport", "cat", 500, weight=64),
        Criterion("arr_terminal", "cat", 12, weight=16),
        Criterion("dep_terminal", "cat", 12, weight=16),
        Criterion("arr_region", "cat", 8, weight=8),
        Criterion("dep_region", "cat", 8, weight=8),
        Criterion("arr_country", "cat", 240, weight=24),
        Criterion("dep_country", "cat", 240, weight=24),
        Criterion("arr_carrier", "cat", 900, weight=32),
        Criterion("dep_carrier", "cat", 900, weight=32),
        Criterion("arr_flight_kind", "cat", 4, weight=4),
        Criterion("dep_flight_kind", "cat", 4, weight=4),
        Criterion("arr_aircraft", "cat", 50, weight=8),
        Criterion("dep_aircraft", "cat", 50, weight=8),
        Criterion("prev_airport", "cat", 500, weight=12),
        Criterion("next_airport", "cat", 500, weight=12),
        Criterion("arr_state", "cat", 60, weight=6),
        Criterion("dep_state", "cat", 60, weight=6),
        Criterion("weekday", "cat", 8, weight=4),
        Criterion("season", "cat", 4, weight=4),
    ]
    ranges = [
        Criterion("arr_flightno", "range", domain=(0, 9_999), weight=48),
        Criterion("dep_flightno", "range", domain=(0, 9_999), weight=48),
        Criterion("date", "range", domain=(0, 730), weight=16),
    ]
    return cats + ranges  # 19 + 3 = 22


def schema_v2() -> List[Criterion]:
    """26 consolidated criteria: v1 + code-share carrier/flight-no handling.

    Carrier criteria become cross-matching (marketing vs operating selected
    by the code-share indicator at encode time), and code-share flight-number
    range criteria are added (§3.2.3/3.2.4).
    """
    base = schema_v1()
    out = []
    for c in base:
        if c.name in ("arr_carrier", "dep_carrier"):
            side = c.name.split("_")[0]
            out.append(dataclasses.replace(
                c, name=f"{side}_mkt_carrier",
                cross_fields=(f"{side}_mkt_carrier", f"{side}_mkt_carrier",
                              f"{side}_cs")))
            out.append(dataclasses.replace(
                c, name=f"{side}_op_carrier", weight=28,
                cross_fields=(f"{side}_op_carrier", f"{side}_mkt_carrier",
                              f"{side}_cs")))
        else:
            out.append(c)
    for side in ("arr", "dep"):
        out.append(Criterion(
            f"{side}_cs_flightno", "range", domain=(0, 9_999), weight=40,
            cross_fields=(f"{side}_cs_flightno", f"{side}_flightno",
                          f"{side}_cs")))
    return out  # 22 + 2 + 2 = 26


@dataclass
class Rule:
    """values[name]: cat -> int or WILDCARD; range -> (lo, hi) or WILDCARD."""
    values: Dict[str, object]
    decision: int             # MCT minutes
    rule_id: int = 0

    def weight(self, schema: Sequence[Criterion], version: int = 1) -> int:
        """Precision weight: sum of intrinsic weights of bound criteria;
        v2 adds a dynamic penalty for wide ranges (§3.2.2)."""
        w = 0
        for c in schema:
            v = self.values.get(c.name, WILDCARD)
            if v == WILDCARD:
                continue
            if c.kind == "range":
                lo, hi = v
                w += c.weight
                if version >= 2:
                    size = max(hi - lo, 0) + 1
                    w -= min(int(np.ceil(np.log2(size + 1))), c.weight // 2)
            else:
                w += c.weight
        return w


@dataclass
class RuleSet:
    schema: List[Criterion]
    rules: List[Rule]
    version: int = 1
    default_decision: int = 999


# ---------------------------------------------------------------------------
# Synthetic generators (production-like statistics)
# ---------------------------------------------------------------------------


def _zipf_choice(rng, n, size, a=1.3):
    """Zipf-skewed categorical values in [0, n)."""
    ranks = rng.zipf(a, size=size)
    return np.minimum(ranks - 1, n - 1).astype(np.int64)


def generate_rules(n_rules: int, version: int = 1, seed: int = 0,
                   wildcard_p: float = 0.55, overlap_p: float = 0.002
                   ) -> RuleSet:
    """Synthetic IATA-like rule set. Airlines contribute per-airport rule
    lists; most criteria are wildcards in most rules; flight-number ranges
    overlap rarely (paper: zero to a few hundred overlaps in 160k rules)."""
    rng = np.random.default_rng(seed)
    schema = schema_v2() if version >= 2 else schema_v1()
    by_name = {c.name: c for c in schema}
    rules = []
    airports = _zipf_choice(rng, by_name["airport"].cardinality, n_rules)
    for i in range(n_rules):
        vals: Dict[str, object] = {}
        vals["airport"] = int(airports[i])
        for c in schema:
            if c.name == "airport":
                continue
            if rng.random() < wildcard_p:
                vals[c.name] = WILDCARD
            elif c.kind == "cat":
                vals[c.name] = int(_zipf_choice(rng, c.cardinality, 1)[0])
            else:
                lo = int(rng.integers(c.domain[0], c.domain[1]))
                width = int(rng.integers(1, max((c.domain[1] - lo) // 4, 2)))
                if rng.random() < overlap_p * 50:
                    width = max(width // 8, 1)
                vals[c.name] = (lo, min(lo + width, c.domain[1]))
        decision = int(rng.choice([20, 25, 30, 35, 40, 45, 60, 75, 90, 120]))
        rules.append(Rule(values=vals, decision=decision, rule_id=i))
    return RuleSet(schema=schema, rules=rules, version=version)


def generate_queries(ruleset: RuleSet, n: int, seed: int = 0,
                     match_bias: float = 0.7) -> List[Dict[str, int]]:
    """MCT queries with production-like skew. With prob `match_bias` a query
    is derived from a random rule (guaranteeing matches exist)."""
    rng = np.random.default_rng(seed + 1)
    schema = ruleset.schema
    by_name = {c.name: c for c in schema}
    queries = []
    for _ in range(n):
        q: Dict[str, int] = {}
        base: Optional[Rule] = None
        if rng.random() < match_bias and ruleset.rules:
            base = ruleset.rules[int(rng.integers(len(ruleset.rules)))]
        for c in schema:
            v = base.values.get(c.name, WILDCARD) if base else WILDCARD
            if c.kind == "cat":
                if v == WILDCARD:
                    q[c.name] = int(_zipf_choice(rng, c.cardinality, 1)[0])
                else:
                    q[c.name] = int(v)
            else:
                if v == WILDCARD:
                    q[c.name] = int(rng.integers(c.domain[0], c.domain[1]))
                else:
                    lo, hi = v
                    q[c.name] = int(rng.integers(lo, hi + 1))
        # cross-match raw fields (v2): mkt/op carriers + code-share flags.
        # Values already derived from the base rule are preserved so that
        # encoder-side cross-matching reconstructs the rule's view.
        if ruleset.version >= 2:
            for side in ("arr", "dep"):
                op_n = f"{side}_op_carrier"
                mk_n = f"{side}_mkt_carrier"
                csf_n = f"{side}_cs_flightno"
                bound_op = (base is not None and
                            base.values.get(op_n, WILDCARD) != WILDCARD)
                bound_csf = (base is not None and
                             base.values.get(csf_n, WILDCARD) != WILDCARD)
                cs = 1 if (bound_op or bound_csf) \
                    else int(rng.random() < 0.15)
                q[f"{side}_cs"] = cs
                if not cs:
                    q[op_n] = q[mk_n]  # no code-share: operating == marketing
        queries.append(q)
    return queries
