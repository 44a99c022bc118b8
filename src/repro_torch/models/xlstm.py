"""xLSTM blocks: chunkwise-parallel mLSTM (matrix memory, exponential
gating) and sequential sLSTM (scalar memory, head-wise recurrence).

Port of ``repro.models.xlstm`` (the chunkwise form is written out there).
Every exponent is clipped before ``exp`` exactly as the reference clips it,
so the -1e30 initial stabilisers and padding never overflow. Over a mesh,
``slstm_forward_sharded`` runs the recurrence on each rank's batch rows
with a backward that accumulates the weight gradients locally and reduces
them once at the end (the reference's custom VJP). DTensor has no sharding
rule for ``logsigmoid``'s backward: the forget gate's ``logsigmoid`` runs
on the local shards (``local_map``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import dense_init
from repro_torch.sharding.specs import (P, axis_sizes, done, group,
                                       merge_last, on_batch_head_shards,
                                       placements, split_last, to_local)

_CLIP = 80.0
_NEG = -1e30


def _exp_le0(x: torch.Tensor) -> torch.Tensor:
    """exp of x clipped to [-80, 0] (the reference's jnp.clip(x, -80, 0))."""
    return torch.exp(torch.clamp(x, -_CLIP, 0.0))


def _exp_neg(m: torch.Tensor) -> torch.Tensor:
    """exp(-m) with -m clipped above at 80 (jnp.clip(-m, None, 80))."""
    return torch.exp(torch.clamp(-m, max=_CLIP))


def init_mlstm(generator: torch.Generator, d_model: int, n_heads: int,
               dtype: torch.dtype) -> dict:
    """The gate projections and biases stay float32, as in the reference."""
    D, dev = d_model, generator.device
    return {
        "wq": dense_init(generator, D, D, dtype),
        "wk": dense_init(generator, D, D, dtype),
        "wv": dense_init(generator, D, D, dtype),
        "wog": dense_init(generator, D, D, dtype),
        "wo": dense_init(generator, D, D, dtype),
        "w_ig": dense_init(generator, D, n_heads, torch.float32, scale=0.01),
        "w_fg": dense_init(generator, D, n_heads, torch.float32, scale=0.01),
        # open forget gates
        "b_fg": torch.full((n_heads,), 3.0, dtype=torch.float32, device=dev),
        "b_ig": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, d, d)  stabilised matrix memory
    n: torch.Tensor  # (B, H, d)
    m: torch.Tensor  # (B, H)


def mlstm_init_state(batch: int, n_heads: int, head_dim: int,
                     device=None) -> MLSTMState:
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, n_heads, head_dim, head_dim), dtype=f32,
                      device=device),
        n=torch.zeros((batch, n_heads, head_dim), dtype=f32, device=device),
        m=torch.full((batch, n_heads), _NEG, dtype=f32, device=device))


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``, elementwise on each rank's shard of a DTensor."""
    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return local_map(F.logsigmoid, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def _qkv_gates(params, x: torch.Tensor, n_heads: int):
    B, T, D = x.shape
    hd = D // n_heads
    q = split_last(x @ params["wq"].to(x.dtype), n_heads, hd)
    k = split_last(x @ params["wk"].to(x.dtype), n_heads, hd)
    v = split_last(x @ params["wv"].to(x.dtype), n_heads, hd)
    x32 = x.float()
    li = x32 @ params["w_ig"] + params["b_ig"]                  # (B,T,H)
    lf = _logsigmoid(x32 @ params["w_fg"] + params["b_fg"])
    og = torch.sigmoid(x @ params["wog"].to(x.dtype))           # (B,T,D)
    return q, k, v, li, lf, og


def mlstm_forward(params, x: torch.Tensor, *, n_heads: int,
                  chunk: int = 128) -> torch.Tensor:
    """Full-sequence chunkwise mLSTM. x: (B, T, D) -> (B, T, D)."""
    B, T, D = x.shape
    q, k, v, li, lf, og = _qkv_gates(params, x, n_heads)
    h = on_batch_head_shards(_mlstm_chunks, q, k, v, li, lf, chunk=chunk)
    h = merge_last(h, 2).to(x.dtype) * og
    return h @ params["wo"].to(x.dtype)


def _mlstm_chunks(q, k, v, li, lf, *, chunk: int) -> torch.Tensor:
    """The chunkwise recurrence: q, k, v (B, T, H, d), log gates li, lf
    (B, T, H) -> h (B, T, H, d) in float32. Each (batch row, head) is
    independent."""
    B, T, n_heads, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    L = min(chunk, T)
    pad = (-T) % L
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=_NEG)
        lf = F.pad(lf, (0, 0, 0, pad))
    c0, n0, m0 = mlstm_init_state(B, n_heads, hd, device=q.device)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    hs = []
    for s in range(0, T + pad, L):
        qf = q[:, s:s + L].float() * scale
        kf, vf = k[:, s:s + L].float(), v[:, s:s + L].float()
        lic, lfc = li[:, s:s + L], lf[:, s:s + L]
        b = torch.cumsum(lfc, dim=1)                            # (B,L,H)
        a = lic - b
        A = torch.maximum(m0[:, None], torch.cummax(a, dim=1).values)
        W = _exp_le0(a[:, None, :] - A[:, :, None])             # (B,t,s,H)
        W = torch.where(tri[None, :, :, None], W, 0.0)          # s <= t
        scores = torch.einsum("bthd,bshd->btsh", qf, kf)
        num = torch.einsum("btsh,bshd->bthd", scores * W, vf)
        inter = _exp_le0(m0[:, None] - A)                       # (B,L,H)
        num = num + inter[..., None] * torch.einsum("bthd,bhde->bthe",
                                                    qf, c0)
        n_t = torch.einsum("btsh,bshd->bthd", W, kf)
        n_t = n_t + inter[..., None] * n0[:, None]
        m_t = b + A
        qn = torch.abs(torch.einsum("bthd,bthd->bth", qf, n_t))
        denom = torch.maximum(qn, _exp_neg(m_t))
        hs.append(num / denom[..., None])
        # carry at the chunk's end
        AL = A[:, -1]
        wk_coef = _exp_le0(a - AL[:, None])                     # (B,L,H)
        i_coef = _exp_le0(m0 - AL)
        c0 = torch.einsum("bshd,bshe,bsh->bhde", kf, vf, wk_coef) \
            + i_coef[..., None, None] * c0
        n0 = torch.einsum("bshd,bsh->bhd", kf, wk_coef) \
            + i_coef[..., None] * n0
        m0 = b[:, -1] + AL
    return torch.cat(hs, dim=1)[:, :T]


def mlstm_step(params, x: torch.Tensor, state: MLSTMState, *,
               n_heads: int):
    """Single-token decode. x: (B, 1, D). Returns (y, the new state)."""
    B, _, D = x.shape
    hd = D // n_heads
    scale = 1.0 / math.sqrt(hd)
    q, k, v, li, lf, og = _qkv_gates(params, x, n_heads)
    qf = q[:, 0].float() * scale                                # (B,H,d)
    kf, vf = k[:, 0].float(), v[:, 0].float()
    li, lf = li[:, 0], lf[:, 0]                                 # (B,H)
    m_new = torch.maximum(lf + state.m, li)
    i_c = _exp_le0(li - m_new)
    f_c = _exp_le0(lf + state.m - m_new)
    c = f_c[..., None, None] * state.c \
        + i_c[..., None, None] * torch.einsum("bhd,bhe->bhde", kf, vf)
    n = f_c[..., None] * state.n + i_c[..., None] * kf
    qn = torch.abs(torch.einsum("bhd,bhd->bh", qf, n))
    denom = torch.maximum(qn, _exp_neg(m_new))
    h = torch.einsum("bhd,bhde->bhe", qf, c) / denom[..., None]
    h = merge_last(h, 2)[:, None].to(x.dtype) * og
    return h @ params["wo"].to(x.dtype), MLSTMState(c, n, m_new)


def mlstm_ref(params, x: torch.Tensor, *, n_heads: int) -> torch.Tensor:
    """Sequential oracle."""
    B, T, D = x.shape
    state = mlstm_init_state(B, n_heads, D // n_heads, device=x.device)
    ys = []
    for t in range(T):
        y, state = mlstm_step(params, x[:, t:t + 1], state, n_heads=n_heads)
        ys.append(y)
    return torch.cat(ys, dim=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(generator: torch.Generator, d_model: int, n_heads: int,
               dtype: torch.dtype) -> dict:
    """Gate order i, f, z, o; the bias ``b`` stays float32."""
    hd, dev = d_model // n_heads, generator.device
    w = dense_init(generator, d_model, 4 * d_model, dtype)
    r = torch.randn((4, n_heads, hd, hd), generator=generator,
                    dtype=torch.float32, device=dev) / math.sqrt(hd)
    b = torch.zeros((4 * d_model,), dtype=torch.float32, device=dev)
    b[d_model:2 * d_model] = 3.0
    return {"w": w, "r": r.to(dtype), "b": b,
            "wo": dense_init(generator, d_model, d_model, dtype)}


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, d)
    n: torch.Tensor
    m: torch.Tensor  # (B, H, d)
    h: torch.Tensor  # (B, H, d)


def slstm_init_state(batch: int, n_heads: int, head_dim: int,
                     device=None) -> SLSTMState:
    z = torch.zeros((batch, n_heads, head_dim), dtype=torch.float32,
                    device=device)
    return SLSTMState(c=z, n=z, m=z + _NEG, h=z)


def _slstm_cell(params, x_t: torch.Tensor, st: SLSTMState, n_heads: int
                ) -> SLSTMState:
    """x_t: (B, D)."""
    B, D = x_t.shape
    hd = D // n_heads
    wx = (x_t @ params["w"].to(x_t.dtype)).float() + params["b"]
    wx = split_last(wx, 4, n_heads, hd)
    rh = torch.einsum("bhd,ghde->bghe", st.h, params["r"].float())
    it, ft, zt, ot = (wx[:, g] + rh[:, g] for g in range(4))
    m_new = torch.maximum(ft + st.m, it)
    i_c = _exp_le0(it - m_new)
    f_c = _exp_le0(ft + st.m - m_new)
    c = f_c * st.c + i_c * torch.tanh(zt)
    n = torch.clamp(f_c * st.n + i_c, min=1e-6)
    h = torch.sigmoid(ot) * c / n
    return SLSTMState(c=c, n=n, m=m_new, h=h)


def slstm_forward(params, x: torch.Tensor, *, n_heads: int) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D), one cell step a token."""
    B, T, D = x.shape
    st = slstm_init_state(B, n_heads, D // n_heads, device=x.device)
    hs = []
    for t in range(T):
        st = _slstm_cell(params, x[:, t], st, n_heads)
        hs.append(st.h)
    h = merge_last(torch.stack(hs, dim=1), 2).to(x.dtype)
    return h @ params["wo"].to(x.dtype)


def slstm_step(params, x: torch.Tensor, st: SLSTMState, *, n_heads: int):
    """x: (B, 1, D). Returns (y, the new state)."""
    B, _, D = x.shape
    st = _slstm_cell(params, x[:, 0], st, n_heads)
    h = merge_last(st.h, 2)[:, None].to(x.dtype)
    return h @ params["wo"].to(x.dtype), st


# ---------------------------------------------------------------------------
# sLSTM with locally-accumulated recurrent-weight gradients
# ---------------------------------------------------------------------------
#
# Differentiating the time loop on DTensors reduces dR/dW across the batch
# shards at EVERY timestep. Here the whole recurrence runs on each rank's
# batch rows (the reference's shard_map body): the backward loop
# accumulates the weight gradients locally (per-step autograd of the local
# cell, correct by construction), and ONE all-reduce of all of them at the
# end sums across the batch shards.


def slstm_forward_sharded(params, x: torch.Tensor, *, n_heads: int, mesh,
                          batch_axes) -> torch.Tensor:
    """``slstm_forward`` over a mesh, x (B, T, D) split over
    ``batch_axes``; the weights ``w``, ``r``, ``b`` are gathered whole."""
    axes = tuple(batch_axes)
    xspec = P(axes, None, None)
    w = to_local(params["w"], mesh, P(None, None), partial_grad=False)
    r = to_local(params["r"], mesh, P(None, None, None, None),
                 partial_grad=False)
    b = to_local(params["b"], mesh, P(None), partial_grad=False)
    plain = not isinstance(x, DTensor)
    x_loc = to_local(x, mesh, xspec, partial_grad=False)
    h = _SLSTMLocalGrad.apply(w, r, b, x_loc, n_heads, mesh, axes)
    h = DTensor.from_local(h, mesh, placements(mesh, xspec),
                           run_check=False)
    if plain:
        h = h.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    return h @ params["wo"].to(x.dtype)


def _slstm_scan(rwb, x: torch.Tensor, n_heads: int):
    """The local recurrence: (h (B, T, D) in x's dtype, the state after
    each step)."""
    B, T, D = x.shape
    st = slstm_init_state(B, n_heads, D // n_heads, device=x.device)
    traj = []
    for t in range(T):
        st = _slstm_cell(rwb, x[:, t], st, n_heads)
        traj.append(st)
    h = torch.stack([s.h for s in traj], dim=1).reshape(B, T, D)
    return h.to(x.dtype), traj


class _SLSTMLocalGrad(torch.autograd.Function):
    """The sLSTM time loop on local rows: the forward keeps each step's
    state; the backward runs the loop in reverse, one cell's autograd a
    step, sums the weight gradients in float32 and all-reduces them once
    over the batch axes."""

    @staticmethod
    def forward(ctx, w, r, b, x, n_heads, mesh, axes):
        with torch.no_grad():
            h, traj = _slstm_scan({"w": w, "r": r, "b": b}, x, n_heads)
        ctx.n_heads, ctx.mesh, ctx.axes = n_heads, mesh, axes
        ctx.traj = traj
        ctx.save_for_backward(w, r, b, x)
        return h

    @staticmethod
    def backward(ctx, g):
        w, r, b, x = ctx.saved_tensors
        n_heads, traj = ctx.n_heads, ctx.traj
        B, T, D = x.shape
        hd = D // n_heads
        st0 = slstm_init_state(B, n_heads, hd, device=x.device)
        g_h = g.reshape(B, T, n_heads, hd).float()
        d_rwb = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in (w, r, b)]
        dst = [torch.zeros((B, n_heads, hd), dtype=torch.float32,
                           device=x.device) for _ in range(4)]
        dx = torch.empty_like(x)
        for t in reversed(range(T)):
            prev = traj[t - 1] if t else st0
            with torch.enable_grad():
                ins = [p.detach().requires_grad_(True) for p in (w, r, b)]
                x_t = x[:, t].detach().requires_grad_(True)
                st_in = [s.detach().requires_grad_(True) for s in prev]
                out = _slstm_cell({"w": ins[0], "r": ins[1], "b": ins[2]},
                                  x_t, SLSTMState(*st_in), n_heads)
                douts = (dst[0], dst[1], dst[2], dst[3] + g_h[:, t])
                grads = torch.autograd.grad(out, ins + [x_t] + st_in,
                                            douts, allow_unused=True,
                                            materialize_grads=True)
            for acc, gr in zip(d_rwb, grads[:3]):
                acc += gr.float()
            dx[:, t] = grads[3]
            dst = [gr.float() for gr in grads[4:]]
        # ONE cross-shard reduction instead of one per timestep
        flat = torch.cat([d.reshape(-1) for d in d_rwb])
        for a in ctx.axes:
            if axis_sizes(ctx.mesh)[a] > 1:
                flat = done(funcol.all_reduce(flat, "sum",
                                              group(ctx.mesh, a)))
        outs, off = [], 0
        for p in (w, r, b):
            outs.append(flat[off:off + p.numel()].reshape(p.shape)
                        .to(p.dtype))
            off += p.numel()
        del ctx.traj
        return outs[0], outs[1], outs[2], dx, None, None, None
