"""Plain PyTorch versions of the rule-match kernel (the port's oracles).

``rule_match_ref`` has the semantics of ``repro.kernels.ref.rule_match_ref``;
``rule_match_packed_ref`` computes the same function on the kernel's packed
table (``rule_match.pack``). The reference broadcasts a (B, R, C)
comparison, which at the paper's 160k rules and a 4096-query batch is some
20 GB of bools; these versions walk the rules in chunks whose (B, chunk, C)
comparison stays under ``MAX_ELEMS`` elements and keep a running best,
updated only on a strictly greater weight, so earlier chunks win ties.
"""
from __future__ import annotations

import torch

_BIG = 2 ** 30
MAX_ELEMS = 1 << 27   # elements in one chunk's (B, chunk, C) comparison


def _running_best(matched, weights, B, R, C, dev):
    """Best (weight, lowest index) over rule chunks; matched(s, e) gives the
    (B, e - s) bool matrix of rules s..e-1."""
    best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    idx = torch.full((B,), -1, dtype=torch.int32, device=dev)
    chunk = max(1, MAX_ELEMS // max(B * C, 1))
    for s in range(0, R, chunk):
        e = min(s + chunk, R)
        score = torch.where(matched(s, e), weights[None, s:e], -1)
        cbest = score.max(dim=1).values                      # (B,)
        ridx = torch.arange(s, e, dtype=torch.int32, device=dev)
        cidx = torch.where(score == cbest[:, None], ridx[None, :],
                           _BIG).min(dim=1).values
        better = cbest > best                   # strict: earlier chunk wins
        best = torch.where(better, cbest, best)
        idx = torch.where(better, cidx, idx)
    return best, idx


def rule_match_ref(queries, mins, maxs, weights):
    """Dense interval-stabbing rule match.

    queries: (B, C) int32; mins/maxs: (R, C) int32; weights: (R,) int32
    (padding rules carry weight < 0 and never-matching intervals).
    Returns (best_weight (B,), best_idx (B,)) — highest weight among matching
    rules, lowest index tie-break; (-1, -1) when nothing matches.
    """
    B, C = queries.shape
    q = queries[:, None, :]                                  # (B, 1, C)

    def matched(s, e):
        return ((q >= mins[None, s:e]) & (q <= maxs[None, s:e])).all(dim=-1)

    return _running_best(matched, weights, B, mins.shape[0], C,
                         queries.device)


def rule_match_packed_ref(queries, bounds, weights_k, crit_order):
    """The same match on the packed table, with the kernel's test.

    queries: (B, C) int32 in the caller's column order; bounds: (C, R, 2)
    int32 (base, span) rows in ``crit_order``; weights_k: (R,) int32 (-1 for
    rules that never match). A criterion holds when (q - base) mod 2**32 <=
    span mod 2**32, computed here in int64. Returns (best_weight (B,),
    best_idx (B,)).
    """
    B, C = queries.shape
    q = queries[:, crit_order.long()].long()[:, None, :]     # (B, 1, C)
    base = bounds[..., 0].T.long()                           # (R, C)
    span = bounds[..., 1].T.long() & 0xFFFFFFFF

    def matched(s, e):
        d = (q - base[None, s:e]) & 0xFFFFFFFF
        return (d <= span[None, s:e]).all(dim=-1)

    return _running_best(matched, weights_k, B, bounds.shape[1], C,
                         queries.device)
