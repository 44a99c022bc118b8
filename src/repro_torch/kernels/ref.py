"""Plain PyTorch version of the rule-match kernel (the port's oracle).

Same semantics as ``repro.kernels.ref.rule_match_ref``. The reference
broadcasts a (B, R, C) comparison, which at the paper's 160k rules and a
4096-query batch is some 20 GB of bools; this version walks the rules in
chunks whose (B, chunk, C) comparison stays under ``MAX_ELEMS`` elements and
keeps a running best, updated only on a strictly greater weight, so earlier
chunks win ties.
"""
from __future__ import annotations

import torch

_BIG = 2 ** 30
MAX_ELEMS = 1 << 27   # booleans in one chunk's (B, chunk, C) comparison


def rule_match_ref(queries, mins, maxs, weights):
    """Dense interval-stabbing rule match.

    queries: (B, C) int32; mins/maxs: (R, C) int32; weights: (R,) int32
    (padding rules carry weight < 0 and never-matching intervals).
    Returns (best_weight (B,), best_idx (B,)) — highest weight among matching
    rules, lowest index tie-break; (-1, -1) when nothing matches.
    """
    B, C = queries.shape
    R = mins.shape[0]
    dev = queries.device
    best = torch.full((B,), -1, dtype=torch.int32, device=dev)
    idx = torch.full((B,), -1, dtype=torch.int32, device=dev)
    chunk = max(1, MAX_ELEMS // max(B * C, 1))
    q = queries[:, None, :]                                  # (B, 1, C)
    for s in range(0, R, chunk):
        e = min(s + chunk, R)
        ok = (q >= mins[None, s:e]) & (q <= maxs[None, s:e])  # (B, n, C)
        matched = ok.all(dim=-1)                             # (B, n)
        score = torch.where(matched, weights[None, s:e], -1)
        cbest = score.max(dim=1).values                      # (B,)
        ridx = torch.arange(s, e, dtype=torch.int32, device=dev)
        cidx = torch.where(score == cbest[:, None], ridx[None, :],
                           _BIG).min(dim=1).values
        better = cbest > best                   # strict: earlier chunk wins
        best = torch.where(better, cbest, best)
        idx = torch.where(better, cidx, idx)
    return best, idx
