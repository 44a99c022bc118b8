"""AdamW with configurable state dtype (bf16 states for the 314B/340B archs),
global-norm clipping and cosine schedule.

Port of ``repro.train.optimizer``, with the same arithmetic: the schedule in
float32 from the step counter, decay on every leaf (norms and embeddings
included), bias corrections ``1 - b**step`` with ``step`` incremented before
the schedule is read, and the moments and the update in float32 whatever the
state and parameter dtypes.

The update runs in place on the parameter and state tensors, under
``torch.no_grad()``: the counterpart of the reference's jitted step with
donated buffers, so that a step holds no second copy of the parameters and
moments. Trees are nested dicts and lists of tensors (the port's parameter
layout); ``grads`` has the parameters' structure and may be in any float
dtype. Leaves may be DTensors: the moments take each parameter's
placements, the update runs on the local shards, and the global norm is a
full reduction (the unsharded norm).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.sharding.specs import implicit_replication


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the parameters' device
    mu: Any
    nu: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in its order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts and lists (NamedTuples
    keep their type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: torch.dtype = torch.float32
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """Linear warmup, then cosine decay to ``min_lr_frac``; float32."""
        s = step.float()
        warm = torch.clamp(s / max(self.warmup, 1), max=1.0)
        prog = torch.clamp((s - self.warmup)
                           / max(self.total_steps - self.warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else torch.device("cpu")
        z = lambda p: torch.zeros_like(p, dtype=self.state_dtype)  # noqa
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_map(z, params), nu=tree_map(z, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, torch.Tensor]:
        """One step, in place. Returns (params, state, grad_norm): the same
        parameter and moment tensors, updated, a new step counter, and the
        global norm of ``grads`` before clipping (float32 scalar).
        ``grads``' float32 leaves are scaled in place by the clipping."""
        with implicit_replication():
            return self._update(grads, state, params)

    def _update(self, grads, state: AdamWState, params):
        g32 = [g.float() for g in tree_leaves(grads)]
        gnorm = torch.sqrt(torch.stack([g.square().sum() for g in g32]).sum())
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            for g in g32:
                g.mul_(scale)
        step = state.step + 1
        lr = self.schedule(step)
        sf = step.float()
        c1 = 1 - self.b1 ** sf
        c2 = 1 - self.b2 ** sf
        for p, g, m, v in zip(tree_leaves(params), g32,
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            m32 = m.float()
            v32 = v.float()
            m32.mul_(self.b1).add_((1 - self.b1) * g)
            v32.mul_(self.b2).add_((1 - self.b2) * g.square())
            delta = (m32 / c1).div_((v32 / c2).sqrt_().add_(self.eps))
            p32 = p.float()
            delta.add_(self.weight_decay * p32)
            if m32 is not m:
                m.copy_(m32)
            if v32 is not v:
                v.copy_(v32)
            if p32 is p:
                p.sub_(lr * delta)
            else:
                p.copy_(p32 - lr * delta)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
