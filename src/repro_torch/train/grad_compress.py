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

``allreduce_compressed`` needs a process group and waits for the sharding
slice (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

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


def allreduce_compressed(grads, state: EFState, group=None):
    """Quantise, sum the int8 payloads as int32 across ``group``, dequantise
    with the mean scale; returns (mean grads, new state). Needs the port of
    the sharding slice."""
    raise NotImplementedError(
        "allreduce_compressed needs a process group from the port of "
        "sharding/specs.py and launch/ (ROADMAP queue 1, item 11)")
