"""Mixture-of-Experts FFN: sort-based capacity dispatch and the dense
reference.

Port of ``repro.models.moe``. Over a mesh, :func:`moe_forward` runs the
reference's ``shard_map`` bodies on local shards (``DTensor.to_local``)
with the same collectives, from ``torch.distributed._functional_collectives``:

- ``ep``  — experts split over the ``model`` axis (num_experts % tp == 0):
  each rank dispatches the tokens routed to ITS experts into an
  (E_loc, C, D) capacity buffer, and the partial outputs are summed over
  ``model``;
- ``tp``  — every rank holds all experts, the expert d_ff split over
  ``model``; the d_ff partial products are summed over ``model``.

Both gather the FSDP weight shards over the ``data`` axis inside the body.
The weight-stationary decode body gathers the tokens over the FSDP axis
instead, sums the partial products over it, and sends each rank back its
own rows (an all-to-all). Without a mesh it is the ``tp = 1`` case on one
device. A sum over an axis whose result every rank then holds is a sum
forward and the identity backward (shard_map's transpose of ``psum``
into a replicated output); inputs leave the body with their gradients
marked partial over the axes they are replicated on
(``sharding.specs.to_local``).

Token dispatch is the Switch-style capacity buffer with dropping: a stable
sort of the tokens by expert, a scatter into an (E, C, D) buffer, the
expert products, and a gather back. Which tokens overflow the capacity
depends on the sort being stable, as ``jnp.argsort`` is.

Top-k routing: ``torch.topk`` promises no order among equal logits, where
``jax.lax.top_k`` takes the lower index first. :func:`_top_k` sorts stably
instead, so ties go to the lower expert index as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.common import (_trunc_normal, act_fn, dense_init,
                                       is_gated)
from repro_torch.sharding.specs import (P, all_gather, axis_sizes, group,
                                       placements, psum, to_local)


def init_moe(generator: torch.Generator, d_model: int, cfg, act: str,
             dtype: torch.dtype) -> dict:
    """cfg: MoEConfig. The router stays float32, as in the reference;
    expert weights are (E, d_in, d_out)."""
    E, Fe = cfg.num_experts, cfg.d_ff_expert
    p = {"router": dense_init(generator, d_model, E, torch.float32),
         "wi": _einit(generator, E, d_model, Fe, dtype),
         "wo": _einit(generator, E, Fe, d_model, dtype)}
    if is_gated(act):
        p["wg"] = _einit(generator, E, d_model, Fe, dtype)
    return p


def _einit(generator: torch.Generator, e: int, din: int, dout: int,
           dtype: torch.dtype) -> torch.Tensor:
    return _trunc_normal((e, din, dout), generator, 1.0 / math.sqrt(din),
                         dtype)


def capacity_for(tokens_local: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-slot, per-expert capacity for a device-local token count."""
    c = int(np.ceil(tokens_local * capacity_factor / num_experts))
    c = max(c, min(tokens_local, 8))
    return min(c, tokens_local)


def _top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest logits along the last axis, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    idx = torch.argsort(logits, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(logits, -1, idx), idx


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """Router logits in float32, top-k experts and their softmax weights."""
    topv, topi = _top_k(xf.float() @ router, k)
    return torch.softmax(topv, dim=-1), topi


def _dispatch_compute(x_flat: torch.Tensor, expert_of_tok: torch.Tensor,
                      wi, wg, wo, *, n_local: int, local_off: int,
                      capacity: int, act: str, partial_d=None,
                      partial_f=None) -> torch.Tensor:
    """Route tokens to local experts via a stable sort and a capacity
    buffer, then run the expert FFN.

    x_flat: (t, D); expert_of_tok: (t,) global expert id for this slot;
    wi/wg: (E_loc, D, F); wo: (E_loc, F, D); local experts are
    [local_off, local_off + n_local). Returns (t, D): zeros for tokens not
    local or dropped. ``partial_d`` completes the contraction over a D
    split (weight-stationary), ``partial_f`` the one over an F split.
    """
    t, D = x_flat.shape
    dev = x_flat.device
    f = act_fn(act)
    local_e = expert_of_tok - local_off
    is_local = (local_e >= 0) & (local_e < n_local)
    key = torch.where(is_local, local_e, n_local)            # sentinel last
    order = torch.argsort(key, stable=True)
    sorted_e = key[order]
    counts = torch.zeros(n_local + 1, dtype=key.dtype, device=dev) \
        .scatter_add_(0, key, torch.ones_like(key))      # bincount
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t, device=dev) - seg_start[sorted_e]
    valid = (sorted_e < n_local) & (pos < capacity)
    slot = torch.where(valid, sorted_e * capacity + pos, n_local * capacity)
    x_sorted = x_flat[order]
    buf = torch.zeros((n_local * capacity + 1, D), dtype=x_flat.dtype,
                      device=dev)
    # the extra row takes the invalid slots (the reference drops them)
    buf[slot] = torch.where(valid[:, None], x_sorted, 0)
    buf = buf[:-1].reshape(n_local, capacity, D)

    done_d = partial_d or (lambda t: t)
    h = done_d(torch.einsum("ecd,edf->ecf", buf, wi.to(buf.dtype)))
    if wg is not None:
        h = f(done_d(torch.einsum("ecd,edf->ecf", buf,
                                  wg.to(buf.dtype)))) * h
    else:
        h = f(h)
    y = torch.einsum("ecf,efd->ecd", h, wo.to(h.dtype))
    if partial_f is not None:
        y = partial_f(y)
    y_flat = y.reshape(n_local * capacity, D)

    out_sorted = torch.where(
        valid[:, None], y_flat[torch.clamp(slot, max=n_local * capacity - 1)],
        0)
    out = torch.zeros_like(x_flat)
    out[order] = out_sorted
    return out


def moe_forward(params, x: torch.Tensor, *, cfg, act: str, mesh=None,
                batch_axes=("data",), fsdp_axis: str = "data",
                model_axis: str = "model", weight_stationary: bool = False
                ) -> torch.Tensor:
    """MoE FFN with capacity dropping. x: (B, S, D), over a mesh sharded
    over ``batch_axes``. Returns (B, S, D) (a DTensor over a mesh).

    weight_stationary=True (decode-optimised path): expert weights are
    NEVER gathered — tokens are all-gathered over the fsdp axis, each rank
    computes with its D-shard of the weights, and partial products are
    summed over the fsdp axis.

    Without a mesh: one device holding every token, the capacity
    ``capacity_for(B * S, ...)``.
    """
    E, K = cfg.num_experts, cfg.top_k
    if mesh is None:
        B, S, D = x.shape
        xf = x.reshape(B * S, D)
        cap = capacity_for(max(1, B * S), E, K, cfg.capacity_factor)
        cw, topi = _route(xf, params["router"], K)
        acc = torch.zeros_like(xf)
        for j in range(K):
            outj = _dispatch_compute(xf, topi[:, j], params["wi"],
                                     params.get("wg"), params["wo"],
                                     n_local=E, local_off=0, capacity=cap,
                                     act=act)
            acc = acc + cw[:, j, None].to(acc.dtype) * outj
        return acc.reshape(B, S, D)

    sizes = axis_sizes(mesh)
    tp = sizes[model_axis]
    mode = cfg.parallel_mode
    if mode == "ep" and E % tp != 0:
        mode = "tp"
    gated = params.get("wg") is not None
    if mode == "ep":
        wspec = P(model_axis, fsdp_axis, None)
        wospec = P(model_axis, None, fsdp_axis)
        n_local = E // tp
        local_off = mesh.get_local_rank(model_axis) * n_local
    else:
        wspec = P(None, fsdp_axis, model_axis)
        wospec = P(None, model_axis, fsdp_axis)
        n_local, local_off = E, 0
    xspec = P(tuple(batch_axes), None, None)
    dp_total = int(np.prod([sizes[a] for a in batch_axes]))
    dp_fsdp = sizes[fsdp_axis] if fsdp_axis else 1
    B, S, D = x.shape
    t_local = max(1, (B // dp_total) * S)

    plain = not isinstance(x, DTensor)
    x_loc = to_local(x, mesh, xspec)
    router = to_local(params["router"], mesh, P(None, None))
    wi = to_local(params["wi"], mesh, wspec)
    wg = to_local(params["wg"], mesh, wspec) if gated else None
    wo = to_local(params["wo"], mesh, wospec)
    b, s, d = x_loc.shape

    if weight_stationary:
        cap_ws = capacity_for(t_local * dp_fsdp, E, K, cfg.capacity_factor)
        t_loc = b * s
        x_all = all_gather(x_loc.reshape(t_loc, d), mesh, fsdp_axis, 0)
        t_all = t_loc * dp_fsdp
        cw, topi = _route(x_all, router, K)
        rd = mesh.get_local_rank(fsdp_axis)
        d_loc = wi.shape[1]
        x_slice = x_all[:, rd * d_loc:(rd + 1) * d_loc]
        acc = torch.zeros((t_all, d_loc), dtype=x_loc.dtype,
                          device=x_loc.device)
        for j in range(K):
            outj = _dispatch_compute(
                x_slice, topi[:, j], wi, wg, wo, n_local=n_local,
                local_off=local_off, capacity=cap_ws, act=act,
                partial_d=lambda h: psum(h, mesh, fsdp_axis),
                partial_f=(None if mode == "ep" else
                           lambda y: psum(y, mesh, model_axis)))
            acc = acc + cw[:, j, None].to(acc.dtype) * outj
        if mode == "ep":
            acc = psum(acc, mesh, model_axis)  # combine expert groups
        # back to this rank's tokens and the full D: rank r sends rank j
        # the D-slice r of j's rows
        if dp_fsdp > 1:
            acc = funcol.all_to_all_single_autograd(
                acc.contiguous(), None, None, group(mesh, fsdp_axis))
            acc = acc.reshape(dp_fsdp, t_loc, d_loc).transpose(0, 1)
        out_loc = acc.reshape(b, s, d_loc * dp_fsdp)
    else:
        cap = capacity_for(t_local, E, K, cfg.capacity_factor)
        xf = x_loc.reshape(b * s, d)
        # FSDP: collect the d_model shards of the weights
        wi = all_gather(wi, mesh, fsdp_axis, 1)
        wo = all_gather(wo, mesh, fsdp_axis, 2)
        if gated:
            wg = all_gather(wg, mesh, fsdp_axis, 1)
        cw, topi = _route(xf, router, K)
        acc = torch.zeros_like(xf)
        for j in range(K):
            outj = _dispatch_compute(xf, topi[:, j], wi, wg, wo,
                                     n_local=n_local, local_off=local_off,
                                     capacity=cap, act=act)
            acc = acc + cw[:, j, None].to(acc.dtype) * outj
        out_loc = psum(acc, mesh, model_axis).reshape(b, s, d)
    out = DTensor.from_local(out_loc, mesh, placements(mesh, xspec),
                             run_check=False)
    if plain:
        return out.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    return out


def moe_ref(params, x: torch.Tensor, *, cfg, act: str) -> torch.Tensor:
    """Dense reference: no dropping; every expert runs on every token and
    the outputs accumulate in x's dtype, in expert order."""
    E, K = cfg.num_experts, cfg.top_k
    f = act_fn(act)
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    cw, topi = _route(xf, params["router"], K)
    out = torch.zeros_like(xf)
    for e in range(E):
        h = xf @ params["wi"][e].to(xf.dtype)
        if "wg" in params:
            h = f(xf @ params["wg"][e].to(xf.dtype)) * h
        else:
            h = f(h)
        y = h @ params["wo"][e].to(h.dtype)
        w_e = torch.where(topi == e, cw, 0.0).sum(dim=-1)
        out = out + w_e[:, None].to(out.dtype) * y
    return out.reshape(B, S, D)
