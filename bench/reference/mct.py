"""Plain reference of MCT rule matching, from the raw rule set.

It reads the rules and queries as the generators give them (``bench/harness
/gen.py``) and nothing that the program derives from them: no compiled
table, dictionary, encoding, criterion order or packing. A rule matches a
query when every criterion it binds holds: a categorical value equals the
query's, a range holds the query's value. A v2 cross-matching criterion
reads the query field that the code-share flag selects. The answer is the
highest precision weight among the matching rules (v2: with the penalty
for wide ranges), the decision and id of a rule of that weight, or
(-1, -1, -1) where no rule matches.

Rules of equal weight can both match. The program picks one of them by
its own table order, which is not part of the semantics, so ``judge``
accepts any rule of the best weight and checks that the decision is that
rule's.

Matching runs in plain PyTorch on the card (or the CPU), int64, in blocks
of queries and rules whose comparison stays under ``MAX_ELEMS`` elements.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from bench.harness.gen import WILDCARD, RuleSet

MAX_ELEMS = 1 << 26
_LO, _HI = -(1 << 40), 1 << 40


class DenseRules(NamedTuple):
    """The rule set as (R, K) int64 bounds over the schema's K criteria in
    schema order, wildcards as (-2**40, 2**40)."""
    names: List[str]
    lo: np.ndarray
    hi: np.ndarray
    weight: np.ndarray      # (R,) int64
    decision: np.ndarray    # (R,) int64
    rule_id: np.ndarray     # (R,) int64


def dense_rules(ruleset: RuleSet, *, dynamic_weights: bool = True
                ) -> DenseRules:
    """``dynamic_weights=False`` drops v2's penalty for wide ranges: the
    control, which breaks the standard's precision guarantee."""
    schema = ruleset.schema
    R, K = len(ruleset.rules), len(schema)
    lo = np.full((R, K), _LO, np.int64)
    hi = np.full((R, K), _HI, np.int64)
    weight = np.zeros(R, np.int64)
    version = ruleset.version if dynamic_weights else 1
    for i, r in enumerate(ruleset.rules):
        for k, c in enumerate(schema):
            v = r.values.get(c.name, WILDCARD)
            if v == WILDCARD:
                continue
            if c.kind == "cat":
                lo[i, k] = hi[i, k] = int(v)
            else:
                lo[i, k], hi[i, k] = int(v[0]), int(v[1])
        weight[i] = r.weight(schema, version)
    return DenseRules([c.name for c in schema], lo, hi, weight,
                      np.array([r.decision for r in ruleset.rules], np.int64),
                      np.array([r.rule_id for r in ruleset.rules], np.int64))


def query_values(ruleset: RuleSet, queries: Sequence[Dict[str, int]]
                 ) -> np.ndarray:
    """(B, K) int64: each criterion's value in each query, the field that
    the code-share flag selects for a cross-matching criterion."""
    out = np.zeros((len(queries), len(ruleset.schema)), np.int64)
    for b, q in enumerate(queries):
        for k, c in enumerate(ruleset.schema):
            if c.cross_fields is None:
                out[b, k] = q[c.name]
            else:
                primary, fallback, flag = c.cross_fields
                out[b, k] = q[primary] if q[flag] else q[fallback]
    return out


def best_matches(rules: DenseRules, values: np.ndarray, device="cpu"):
    """For each query: the best weight (-1 where nothing matches) and the
    (B, R) matches of that weight, as a list of index arrays."""
    dev = torch.device(device)
    lo = torch.as_tensor(rules.lo, device=dev)
    hi = torch.as_tensor(rules.hi, device=dev)
    w = torch.as_tensor(rules.weight, device=dev)
    B, K = values.shape
    R = lo.shape[0]
    qb = max(1, min(B, 1024))
    rb = max(1, MAX_ELEMS // (qb * K))
    best_w = np.full(B, -1, np.int64)
    ties: List[np.ndarray] = [np.zeros(0, np.int64)] * B
    for s in range(0, B, qb):
        v = torch.as_tensor(values[s:s + qb], device=dev)[:, None, :]
        n = v.shape[0]
        best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        hits = []
        for r0 in range(0, R, rb):
            ok = ((v >= lo[None, r0:r0 + rb]) & (v <= hi[None, r0:r0 + rb])
                  ).all(dim=-1)
            score = torch.where(ok, w[None, r0:r0 + rb], -1)
            best = torch.maximum(best, score.max(dim=1).values)
            qi, ri = torch.nonzero(ok, as_tuple=True)
            hits.append(torch.stack([qi, ri + r0]))
        hits_t = torch.cat(hits, dim=1)
        keep = w[hits_t[1]] == best[hits_t[0]]
        hits_h = hits_t[:, keep].cpu().numpy()
        best_h = best.cpu().numpy()
        best_w[s:s + n] = best_h
        order = np.argsort(hits_h[0], kind="stable")
        qi, ri = hits_h[0][order], hits_h[1][order]
        bounds = np.searchsorted(qi, np.arange(n + 1))
        for j in range(n):
            ties[s + j] = ri[bounds[j]:bounds[j + 1]]
    return best_w, ties


def judge(rules: DenseRules, values: np.ndarray, decision: np.ndarray,
          weight: np.ndarray, rule_id: np.ndarray, device="cpu") -> int:
    """The number of answers that are wrong: a weight other than the best,
    or a rule id that is not one of the best-weight matches, or a decision
    that is not that rule's. ``decision``, ``weight``, ``rule_id``: the
    program's answers to the queries whose criterion values are ``values``."""
    best_w, ties = best_matches(rules, values, device)
    by_id = {int(r): i for i, r in enumerate(rules.rule_id)}
    wrong = 0
    for b in range(len(best_w)):
        if best_w[b] < 0:
            ok = weight[b] == -1 and rule_id[b] == -1 and decision[b] == -1
        else:
            ids = set(int(x) for x in rules.rule_id[ties[b]])
            rid = int(rule_id[b])
            ok = (int(weight[b]) == best_w[b] and rid in ids
                  and int(decision[b]) == rules.decision[by_id[rid]])
        wrong += not ok
    return wrong


def answers(rules: DenseRules, values: np.ndarray, device="cpu"):
    """The reference's own answers (decision, weight, rule id), the lowest
    rule id among the best-weight matches: the control's answers when
    ``rules`` was built with ``dynamic_weights=False``."""
    best_w, ties = best_matches(rules, values, device)
    B = len(best_w)
    dec = np.full(B, -1, np.int64)
    rid = np.full(B, -1, np.int64)
    for b in range(B):
        if best_w[b] >= 0:
            i = int(ties[b][np.argmin(rules.rule_id[ties[b]])])
            dec[b], rid[b] = rules.decision[i], rules.rule_id[i]
    return dec, best_w, rid


def decision_range(rules: DenseRules, values: np.ndarray, device="cpu",
                   default: int = 999):
    """The least and the greatest decision among each query's best-weight
    matches (``default`` where none matches): any rule of the best weight
    is a right answer, so a connect time is feasible for every right answer
    above the greatest and infeasible for every one below the least."""
    best_w, ties = best_matches(rules, values, device)
    lo = np.full(len(best_w), default, np.int64)
    hi = np.full(len(best_w), default, np.int64)
    for b in range(len(best_w)):
        if best_w[b] >= 0:
            d = rules.decision[ties[b]]
            lo[b], hi[b] = d.min(), d.max()
    return lo, hi
