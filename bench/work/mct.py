"""Work of one rule-match call, counted from the benchmark's own view of the
inputs: the raw rule set as ``reference.mct.DenseRules`` (one bound pair per
rule and criterion of the schema, wildcards unbound) and the queries'
criterion values. Nothing here reads the program's compiled table, its
criterion order or its packing, so a change to the compiler or the kernel
leaves these counts unchanged.

Operations: int32 compares in the fixed criterion order ``order`` (the
configuration's ``work_order``). A bound criterion's test ``v < lo or
v > hi`` is two compares, or one where the first holds; a wildcard needs
none. The leading criterion (``airport``, bound in every rule) is tested
once per distinct value in the batch and rule, since queries with one
value pass or fail it together; the others only for the (query, rule)
pairs that pass it, up to the first that fails: the least any mapping
needs. Bytes: the bounds and weights of every rule read once, the queries
read once and the three int32 answers written once.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.work import peaks

MAX_ELEMS = 1 << 26


def compares(dense, values: np.ndarray, order, device="cpu") -> int:
    """Compares that the queries ``values`` (B, K) need against ``dense``,
    criteria taken in ``order`` (indices into the schema)."""
    dev = torch.device(device)
    idx = torch.as_tensor(np.asarray(order), device=dev)
    lo = torch.as_tensor(dense.lo, device=dev)[:, idx]
    hi = torch.as_tensor(dense.hi, device=dev)[:, idx]
    q = torch.as_tensor(values, device=dev)[:, idx]
    bound = (lo > -(1 << 39)) | (hi < (1 << 39))
    lead_r = lo[:, 0]
    if not bool(bound[:, 0].all()) or not bool((lo[:, 0] == hi[:, 0]).all()):
        raise ValueError("the leading criterion must be a value bound in "
                         "every rule")
    # leading criterion: once per (distinct value, rule)
    codes = torch.unique(q[:, 0])
    total = int(torch.where(codes[:, None] < lead_r[None, :], 1, 2)
                .sum(dtype=torch.int64))
    # the rest, for the pairs that pass it, grouped by the leading value
    order_r = torch.argsort(lead_r, stable=True)
    lead_sorted = lead_r[order_r]
    K = lo.shape[1] - 1
    cost_pass = torch.cumsum(2 * bound[:, 1:].long(), dim=1)   # (R, K)
    for code in codes.tolist():
        qs = q[q[:, 0] == code][:, 1:]
        s = int(torch.searchsorted(lead_sorted, code))
        e = int(torch.searchsorted(lead_sorted, code, right=True))
        if e == s:
            continue
        rows = order_r[s:e]
        rb = max(1, MAX_ELEMS // max(len(qs) * K, 1))
        for r0 in range(0, len(rows), rb):
            r = rows[r0:r0 + rb]
            v = qs[:, None, :]
            below = (v < lo[r, 1:][None]) & bound[r, 1:][None]
            above = (v > hi[r, 1:][None]) & bound[r, 1:][None]
            fail = below | above
            any_fail = fail.any(dim=-1)
            first = fail.int().argmax(dim=-1)                  # (b, n)
            cp = cost_pass[r][None].expand(len(qs), -1, -1)
            before = torch.where(first > 0, cp.gather(
                -1, (first - 1).clamp_min(0)[..., None])[..., 0], 0)
            at = torch.where(below.gather(-1, first[..., None])[..., 0], 1, 2)
            n = torch.where(any_fail, before + at, cp[..., -1])
            total += int(n.sum(dtype=torch.int64))
    return total


def lane_bytes(dense, n_queries: int) -> int:
    R, K = dense.lo.shape
    return 4 * (R * (2 * K + 1) + n_queries * K + 3 * n_queries)


def lane_bound(dense, values: np.ndarray, order, device="cpu") -> dict:
    """The least time one call on these queries could take on the card:
    the larger of its compares over the int32 issue rate and its bytes over
    the memory bandwidth; ``by`` says which."""
    ops = compares(dense, values, order, device)
    nbytes = lane_bytes(dense, len(values))
    t_ops, t_bytes = ops / peaks.INT32_OPS, nbytes / peaks.HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}
