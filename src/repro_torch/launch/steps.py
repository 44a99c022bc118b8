"""Step builders shared by the dry run, the trainer and the server:
microbatched (grad-accumulation) train step, prefill step, decode step —
each placing its inputs by the sharding policy.

Port of ``repro.launch.steps``. The reference jits each step with in/out
shardings and donated buffers; the port places parameters, optimizer
state, batch and cache as DTensors (:func:`place`) and runs the step
eagerly, its ``AdamW.update`` in place (the donation). There is no
``torch.compile``: this layer is about placement, not capture.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import Model
from repro_torch.sharding.specs import (NamedSharding, P, ShardCtx,
                                        axis_sizes, cache_shardings,
                                        implicit_replication,
                                        param_shardings, placements)
from repro_torch.train.optimizer import (AdamW, AdamWState, tree_leaves,
                                         tree_map)


def make_ctx(mesh, cell: Optional[ShapeCell], cfg: ModelConfig) -> ShardCtx:
    """ShardCtx for a (mesh, shape-cell): decode/prefill cells get
    sequence-sharded KV caches when kv-heads don't divide the model axis."""
    baxes = batch_axes_of(mesh)
    seq_axes = None
    if cell is not None and cell.kind in ("prefill", "decode"):
        if cell.global_batch == 1:
            seq_axes = ("data", "model")
        elif cfg.n_kv_heads % axis_sizes(mesh)["model"] != 0:
            seq_axes = ("model",)
    return ShardCtx(mesh=mesh, batch_axes=baxes, fsdp_axis="data",
                    model_axis="model", cache_seq_axes=seq_axes)


def abstract_params(model: Model):
    """The parameter tree on the meta device (shapes and dtypes)."""
    return model.init(device="meta")


def microbatches_for(cfg: ModelConfig, cell: ShapeCell, mesh,
                     batch_axes=None) -> int:
    """Largest M <= cfg.train_microbatches with (B/M) divisible by dp."""
    axes = batch_axes or batch_axes_of(mesh)
    sizes = axis_sizes(mesh)
    dp = int(np.prod([sizes[a] for a in axes]))
    m = min(cfg.train_microbatches, max(cell.global_batch // dp, 1))
    while m > 1 and (cell.global_batch % m or
                     (cell.global_batch // m) % dp):
        m -= 1
    return max(m, 1)


def place(tree, shardings):
    """Each tensor of ``tree`` laid out as its :class:`NamedSharding` in
    ``shardings`` (a tree of the same structure): a DTensor is
    redistributed, a plain tensor, the same on every rank, is split
    locally without communication."""
    flat = iter(tree_leaves(shardings))

    def one(t):
        s = next(flat)
        pl = placements(s.mesh, s.spec, t.shape)
        if isinstance(t, DTensor):
            return t.redistribute(s.mesh, pl)
        return distribute_tensor(t, s.mesh, pl, src_data_rank=None)
    return tree_map(one, tree)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A scalar metric as a plain tensor."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _grads(model: Model, params, leaves: List[torch.Tensor], batch):
    """(loss, float32 grads of ``leaves``); each leaf's own-dtype grad is
    freed as soon as its float32 copy exists. The backward, like the
    sharded forward, takes plain tensors as replicated."""
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad(), implicit_replication():
        loss = model.loss(params, batch)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    for i, g in enumerate(grads):
        grads[i] = g.float()
    return loss.detach(), grads


def build_train_step(model: Model, ctx: ShardCtx, opt: AdamW,
                     n_microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    With M microbatches the batch's rows split into M contiguous blocks,
    each constrained to the batch layout; their grads accumulate in the
    config's accumulation dtype (float32, or bf16 where
    ``cfg.optimizer_dtype`` is bf16) and are averaged in float32, as are
    the losses."""
    cfg = model.cfg
    accum_dtype = torch.float32 if cfg.optimizer_dtype == "float32" \
        else torch.bfloat16

    def constrain_batch(tree):
        return tree_map(lambda t: ctx._c(t, P(
            ctx.maybe(t.shape[0], ctx.batch_axes),
            *([None] * (t.ndim - 1)))), tree)

    def train_step(params, opt_state: AdamWState, batch):
        M = n_microbatches
        leaves = tree_leaves(params)
        if M == 1:
            loss, grads = _grads(model, params, leaves, batch)
        else:
            rows = next(iter(batch.values())).shape[0] // M
            g_sum, loss_sum = None, torch.zeros((), dtype=torch.float32,
                                                device=leaves[0].device)
            for i in range(M):
                mb = constrain_batch({k: v[i * rows:(i + 1) * rows]
                                      for k, v in batch.items()})
                loss, g = _grads(model, params, leaves, mb)
                if g_sum is None:      # 0 + g: the first block starts it
                    g_sum = [gg.to(accum_dtype) for gg in g]
                else:
                    for a, gg in zip(g_sum, g):
                        a.add_(gg.to(accum_dtype))
                del g
                loss_sum = loss_sum + _full(loss)
            grads = [g.float() / M for g in g_sum]
            del g_sum
            loss = loss_sum / M
        flat = iter(grads)
        new_p, new_s, gnorm = opt.update(
            tree_map(lambda _: next(flat), params), opt_state, params)
        return new_p, new_s, {"loss": _full(loss), "grad_norm": _full(gnorm)}

    return train_step


def opt_state_shardings(pshard, mesh):
    rep = NamedSharding(mesh, P())
    return AdamWState(step=rep, mu=pshard, nu=pshard)


def _placed(fn, *shardings):
    """``fn`` with each positional argument first placed by the matching
    tree of shardings (None: as it comes)."""
    def run(*args):
        return fn(*(a if s is None else place(a, s)
                    for a, s in zip(args, shardings)))
    return run


def shard_train_step(model: Model, ctx: ShardCtx, opt: AdamW,
                     batch_struct, n_microbatches: int = 1,
                     zero1: bool = False):
    """The counterpart of the reference's ``jit_train_step``: the train
    step with its parameters, optimizer state and batch placed by the
    specs. Returns (step, (pstruct, ostruct, pshard, oshard)).

    zero1=True: params replicated over the data axis (TP only), optimizer
    states FSDP-sharded — removes the per-microbatch weight all-gathers of
    ZeRO-3 at the cost of one param all-gather per step."""
    pstruct = abstract_params(model)
    pshard = param_shardings(pstruct, model.cfg, ctx)
    oshard = opt_state_shardings(pshard, ctx.mesh)
    if zero1:
        ctx_nofsdp = dataclasses.replace(ctx, fsdp_axis=None)
        pshard = param_shardings(pstruct, model.cfg, ctx_nofsdp)
    bshard = ctx.batch_spec(batch_struct)
    step = build_train_step(model, ctx, opt, n_microbatches)
    ostruct = opt.init(pstruct)
    return _placed(step, pshard, oshard, bshard), \
        (pstruct, ostruct, pshard, oshard)


def shard_prefill(model: Model, ctx: ShardCtx, batch_struct):
    """The counterpart of ``jit_prefill``: (params, batch) -> (logits,
    cache), params and batch placed by the specs. Returns (step,
    (pstruct, pshard))."""
    pstruct = abstract_params(model)
    pshard = param_shardings(pstruct, model.cfg, ctx)
    bshard = ctx.batch_spec(batch_struct)
    return _placed(model.prefill, pshard, bshard), (pstruct, pshard)


def shard_decode(model: Model, ctx: ShardCtx, batch: int, seq_len: int):
    """The counterpart of ``jit_decode``: (params, cache, token, pos) ->
    (logits, cache), params, cache and token placed by the specs and the
    logits laid out (batch, -, vocab over model); the cache is updated in
    place. Returns (step, (pstruct, cstruct, tok_struct, pos))."""
    pstruct = abstract_params(model)
    pshard = param_shardings(pstruct, model.cfg, ctx)
    cstruct = model.cache_struct(batch, seq_len)
    cshard = cache_shardings(cstruct, model.cfg, ctx)
    b = ctx.maybe(batch, ctx.batch_axes)
    tok_sh = NamedSharding(ctx.mesh, P(b, None))
    lg_sh = NamedSharding(ctx.mesh, P(b, None, ctx.maybe(
        model.cfg.vocab, ctx.model_axis)))
    decode = _placed(model.decode_step, pshard, cshard, tok_sh, None)

    def step(params, cache, token, pos):
        logits, cache = decode(params, cache, token, pos)
        return place(logits, lg_sh), cache

    tok_struct = torch.empty((batch, 1), dtype=torch.long, device="meta")
    return step, (pstruct, cstruct, tok_struct, 0)


def cell_batch_struct(cfg: ModelConfig, cell: ShapeCell
                      ) -> Dict[str, torch.Tensor]:
    """The cell's input batch as meta tensors, laid out as
    ``registry.make_inputs`` makes it (token ids and labels int64)."""
    B, S = cell.global_batch, cell.seq_len
    emb_dt = dtype_of("bfloat16" if cfg.dtype == "bfloat16" else "float32")

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    b: Dict[str, torch.Tensor] = {}
    if cfg.embedding_inputs:
        b["embeds"] = meta((B, S, cfg.d_model), emb_dt)
    else:
        b["tokens"] = meta((B, S), torch.long)
    b["labels"] = meta((B, S), torch.long)
    if cfg.cross_attn_every:
        b["vision_embeds"] = meta((B, cfg.n_vision_tokens, cfg.d_model),
                                  emb_dt)
    if cell.kind == "prefill" and not cfg.encoder_only:
        b.pop("labels", None)
    return b
