"""Int8 gradient compression with error feedback (distributed-optimization
trick for cross-pod / DCN all-reduce).

Per-tensor symmetric quantisation: g ~ scale * q, q in int8. The residual
(g - scale*q) is carried to the next step (error feedback), which keeps SGD
convergence (Karimireddy et al., 2019). The all-reduce then moves 1/4 the
bytes of fp32.

Port of ``repro.train.grad_compress``; trees are nested dicts and lists of
tensors:
    state = init(grads)
    q, scales, state = compress(grads, state)
    ...all-reduce q (int32-accumulate)...
    grads = decompress(q_sum, scales_mean)

``allreduce_compressed`` is the reference's body for inside ``shard_map``:
it sums the int8 payloads as int32 over one named axis of a mesh.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.sharding.specs import axis_sizes, done, group
from repro_torch.train.optimizer import tree_leaves, tree_map


class EFState(NamedTuple):
    residual: Any  # tree like grads, fp32


def init(grads_or_struct) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_or_struct))


def _q_one(g: torch.Tensor, r: torch.Tensor):
    g = g.float() + r
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_r = g - q.float() * scale
    return q, scale, new_r


def compress(grads, state: EFState):
    """(int8 payloads, float32 scalar scales, the new error-feedback
    state), each a tree like ``grads``."""
    flat = iter([_q_one(g, r) for g, r in zip(tree_leaves(grads),
                                              tree_leaves(state.residual))])
    out = tree_map(lambda _: next(flat), grads)
    return _pick(out, 0), _pick(out, 1), EFState(residual=_pick(out, 2))


def _pick(tree, i: int):
    """Element i of each (q, scale, residual) triple of a tree."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def decompress(q, scales):
    flat = iter(tree_leaves(scales))
    return tree_map(lambda qq: qq.float() * next(flat), q)


def allreduce_compressed(grads, state: EFState, mesh, axis_name: str):
    """Each rank's local grads (plain tensors): quantise, sum the payloads
    as int32 over the mesh axis ``axis_name``, dequantise with the mean
    scale. Returns (mean grads, new state)."""
    q, scales, state = compress(grads, state)
    n = axis_sizes(mesh)[axis_name]
    grp = group(mesh, axis_name)

    def psum(t):
        return done(funcol.all_reduce(t, "sum", grp)) if n > 1 else t

    q_sum = tree_map(lambda qq: psum(qq.to(torch.int32)), q)
    s_mean = tree_map(lambda s: psum(s) / n, scales)
    flat = iter(tree_leaves(s_mean))
    g = tree_map(lambda qq: qq.float() * next(flat) / n, q_sum)
    return g, state
