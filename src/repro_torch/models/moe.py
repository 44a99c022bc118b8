"""Mixture-of-Experts FFN: sort-based capacity dispatch and the dense
reference.

Port of ``repro.models.moe`` on one device. The reference's ``moe_forward``
runs its body under ``shard_map`` with experts (``ep``) or the expert d_ff
(``tp``) split over the ``model`` axis and the weights gathered over the
``data`` axis; with one device (``tp = 1``) both modes are the same
computation, which is what :func:`moe_forward` computes. The multi-device
split and the weight-stationary decode body wait for the sharding slice
(ROADMAP.md queue 1, item 11).

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

from repro_torch.models.common import (_trunc_normal, act_fn, dense_init,
                                       is_gated)


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
                      capacity: int, act: str) -> torch.Tensor:
    """Route tokens to local experts via a stable sort and a capacity
    buffer, then run the expert FFN.

    x_flat: (t, D); expert_of_tok: (t,) global expert id for this slot;
    wi/wg: (E_loc, D, F); wo: (E_loc, F, D); local experts are
    [local_off, local_off + n_local). Returns (t, D): zeros for tokens not
    local or dropped.
    """
    t, D = x_flat.shape
    dev = x_flat.device
    f = act_fn(act)
    local_e = expert_of_tok - local_off
    is_local = (local_e >= 0) & (local_e < n_local)
    key = torch.where(is_local, local_e, n_local)            # sentinel last
    order = torch.argsort(key, stable=True)
    sorted_e = key[order]
    counts = torch.bincount(key, minlength=n_local + 1)
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

    h = torch.einsum("ecd,edf->ecf", buf, wi.to(buf.dtype))
    if wg is not None:
        h = f(torch.einsum("ecd,edf->ecf", buf, wg.to(buf.dtype))) * h
    else:
        h = f(h)
    y = torch.einsum("ecf,efd->ecd", h, wo.to(h.dtype))
    y_flat = y.reshape(n_local * capacity, D)

    out_sorted = torch.where(
        valid[:, None], y_flat[torch.clamp(slot, max=n_local * capacity - 1)],
        0)
    out = torch.zeros_like(x_flat)
    out[order] = out_sorted
    return out


def moe_forward(params, x: torch.Tensor, *, cfg, act: str) -> torch.Tensor:
    """MoE FFN with capacity dropping on one device. x: (B, S, D).

    The capacity is the reference's for one device holding every token
    (``capacity_for(B * S, ...)``); each of the top-k slots dispatches
    separately and the slots are summed with their softmax weights."""
    E, K = cfg.num_experts, cfg.top_k
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    cap = capacity_for(max(1, B * S), E, K, cfg.capacity_factor)
    cw, topi = _route(xf, params["router"], K)
    acc = torch.zeros_like(xf)
    for j in range(K):
        outj = _dispatch_compute(xf, topi[:, j], params["wi"],
                                 params.get("wg"), params["wo"], n_local=E,
                                 local_off=0, capacity=cap, act=act)
        acc = acc + cw[:, j, None].to(acc.dtype) * outj
    return acc.reshape(B, S, D)


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
