"""Frozen copies of the generators the benchmark draws its inputs from.

The MCT rule schema and generators (``generate_rules``, ``generate_queries``)
and the Domain Explorer's user-query shapes are copied here unchanged in
behaviour from ``repro_torch.core.rules`` and ``repro_torch.core.workload``,
so that a later change to the program's generators cannot move the
yardstick. The same numpy ``default_rng`` seeds give the same rules, queries
and shapes as the program's copies (``bench/tests`` hold a golden hash).

``Rule.weight`` is the standard's precision weight (v2 adds a penalty for
wide ranges, paper section 3.2.2); the plain reference reads it from here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WILDCARD = -1


@dataclass(frozen=True)
class Criterion:
    name: str
    kind: str                 # "cat" | "range"
    cardinality: int = 0      # cat: dictionary size
    domain: Tuple[int, int] = (0, 9_999)  # range: value domain
    weight: int = 1           # intrinsic precision weight
    # v2 cross-matching: (field when code-share, field when not, flag field)
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
    return cats + ranges


def schema_v2() -> List[Criterion]:
    """26 consolidated criteria: v1 with cross-matching carriers and
    code-share flight-number ranges."""
    out = []
    for c in schema_v1():
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
    return out


@dataclass
class Rule:
    """values[name]: cat -> int or WILDCARD; range -> (lo, hi) or WILDCARD."""
    values: Dict[str, object]
    decision: int             # MCT minutes
    rule_id: int = 0

    def weight(self, schema: Sequence[Criterion], version: int = 1) -> int:
        """Sum of the intrinsic weights of the bound criteria; v2 takes a
        penalty for wide ranges."""
        w = 0
        for c in schema:
            v = self.values.get(c.name, WILDCARD)
            if v == WILDCARD:
                continue
            w += c.weight
            if c.kind == "range" and version >= 2:
                lo, hi = v
                size = max(hi - lo, 0) + 1
                w -= min(int(np.ceil(np.log2(size + 1))), c.weight // 2)
        return w


@dataclass
class RuleSet:
    schema: List[Criterion]
    rules: List[Rule]
    version: int = 1
    default_decision: int = 999


def _zipf_choice(rng, n, size, a=1.3):
    ranks = rng.zipf(a, size=size)
    return np.minimum(ranks - 1, n - 1).astype(np.int64)


def generate_rules(n_rules: int, version: int = 1, seed: int = 0,
                   wildcard_p: float = 0.55, overlap_p: float = 0.002
                   ) -> RuleSet:
    """Synthetic IATA-like rule set: most criteria wildcards, rare overlaps
    of flight-number ranges."""
    rng = np.random.default_rng(seed)
    schema = schema_v2() if version >= 2 else schema_v1()
    by_name = {c.name: c for c in schema}
    rules = []
    airports = _zipf_choice(rng, by_name["airport"].cardinality, n_rules)
    for i in range(n_rules):
        vals: Dict[str, object] = {"airport": int(airports[i])}
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
    """MCT queries; with probability ``match_bias`` one is derived from a
    random rule, so that matches exist."""
    rng = np.random.default_rng(seed + 1)
    queries = []
    for _ in range(n):
        q: Dict[str, int] = {}
        base: Optional[Rule] = None
        if rng.random() < match_bias and ruleset.rules:
            base = ruleset.rules[int(rng.integers(len(ruleset.rules)))]
        for c in ruleset.schema:
            v = base.values.get(c.name, WILDCARD) if base else WILDCARD
            if c.kind == "cat":
                q[c.name] = int(_zipf_choice(rng, c.cardinality, 1)[0]) \
                    if v == WILDCARD else int(v)
            elif v == WILDCARD:
                q[c.name] = int(rng.integers(c.domain[0], c.domain[1]))
            else:
                q[c.name] = int(rng.integers(v[0], v[1] + 1))
        if ruleset.version >= 2:
            for side in ("arr", "dep"):
                op_n, mk_n = f"{side}_op_carrier", f"{side}_mkt_carrier"
                csf_n = f"{side}_cs_flightno"
                bound_op = (base is not None and
                            base.values.get(op_n, WILDCARD) != WILDCARD)
                bound_csf = (base is not None and
                             base.values.get(csf_n, WILDCARD) != WILDCARD)
                cs = 1 if (bound_op or bound_csf) \
                    else int(rng.random() < 0.15)
                q[f"{side}_cs"] = cs
                if not cs:
                    q[op_n] = q[mk_n]
        queries.append(q)
    return queries


@dataclass
class SearchShape:
    """One user query of the Domain Explorer, without its MCT queries:
    the qualified travel solutions it asks for and, in order, the number of
    connections of each travel solution (0 for a direct flight)."""
    required_ts: int
    connections: List[int]

    @property
    def n_mct(self) -> int:
        return sum(self.connections)


def search_shapes(n_user_queries: int, *, seed: int = 0,
                  mean_ts: float = 920.0, direct_frac: float = 0.17,
                  mean_mct_per_ts: float = 1.24) -> List[SearchShape]:
    """The shapes ``generate_workload`` draws (paper sections 2.2 and 5.1:
    17% direct, 1.24 MCT queries per indirect travel solution, log-normal
    travel-solution counts), from the same random stream: its MCT queries
    come from a separate generator, so the shapes are the same."""
    rng = np.random.default_rng(seed)
    out: List[SearchShape] = []
    for _ in range(n_user_queries):
        n_ts = int(np.clip(rng.lognormal(np.log(mean_ts) - 0.5, 1.0), 1,
                           8_000))
        required = int(rng.choice([200, 500, 1_000, 1_500],
                                  p=[0.25, 0.3, 0.3, 0.15]))
        n_direct = rng.binomial(n_ts, direct_frac)
        conns = np.clip(rng.geometric(1.0 / mean_mct_per_ts,
                                      n_ts - n_direct), 1, 4)
        sols = [0] * int(n_direct) + [int(c) for c in conns]
        rng.shuffle(sols)
        out.append(SearchShape(required_ts=required, connections=sols))
    return out

