"""Mamba-style selective SSM head (hymba's parallel attention + SSM layers).

Port of ``repro.models.ssm``. Training and prefill run the recurrence chunk
by chunk (the reference's ``lax.scan`` over chunks with a static unroll
inside each chunk); decode is one recurrent step with a carried
(conv_state, ssm_state).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_mamba(generator: torch.Generator, d_model: int, cfg,
               dtype: torch.dtype) -> dict:
    """cfg: SSMConfig. ``dt_bias``, ``a_log`` and ``d_skip`` stay float32,
    as in the reference."""
    di = cfg.d_inner_mult * d_model
    N = cfg.state_dim
    dev = generator.device
    # S4D-real initialisation for A
    a = torch.arange(1, N + 1, dtype=torch.float32, device=dev)[None, :] \
        .repeat(di, 1)
    conv = torch.randn((cfg.conv_width, di), generator=generator,
                       dtype=torch.float32, device=dev) * 0.1
    return {
        "w_in": dense_init(generator, d_model, 2 * di, dtype),  # x and z
        "conv_w": conv.to(dtype),
        "w_bcd": dense_init(generator, di, 2 * N + 1, dtype),  # B, C, dt
        "dt_bias": torch.full((di,), 0.5, dtype=torch.float32, device=dev),
        "a_log": torch.log(a),                                  # (di, N)
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": dense_init(generator, di, d_model, dtype),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, T, di); w: (W, di)."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + T] * w[i][None, None, :]
    return out


def _ssm_inputs(params, u: torch.Tensor):
    """Gating and projection math shared by every path. u: (B, T, di)
    post-conv. Returns (dA (B, T, di, N) decay, dBx (B, T, di, N) input,
    C (B, T, N)), float32.

    The step size adds the *mean* of ``dt_bias``, a scalar, as the
    reference does (not the per-channel bias)."""
    N = (params["w_bcd"].shape[1] - 1) // 2
    bcd = u @ params["w_bcd"].to(u.dtype)
    B_t = bcd[..., :N].float()                                  # (B,T,N)
    C_t = bcd[..., N:2 * N].float()
    dt = F.softplus(bcd[..., -1].float() + params["dt_bias"].mean())  # (B,T)
    A = -torch.exp(params["a_log"])                             # (di, N)
    dA = torch.exp(dt[..., None, None] * A[None, None])         # (B,T,di,N)
    dBx = (dt[..., None] * u.float())[..., None] * B_t[..., None, :]
    return dA, dBx, C_t


def N_state(params) -> int:
    return params["a_log"].shape[1]


def _scan_chunk(h: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor,
                C_t: torch.Tensor):
    """h_t = dA_t h_{t-1} + dBx_t over one chunk's L steps; returns the
    final h and y (B, L, di) = <h_t, C_t>."""
    ys = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C_t[:, t]))
    return h, torch.stack(ys, dim=1)


def mamba_forward(params, x: torch.Tensor, *, cfg) -> torch.Tensor:
    """Full-sequence forward. x: (B, T, D) -> (B, T, D).

    The baseline precomputes the gates for the whole sequence and runs the
    recurrence chunk by chunk; ``cfg.chunk_local`` computes projections,
    conv and gates inside each chunk instead, carrying the conv tail, so no
    (B, T, di, N) tensor exists at once.
    """
    if getattr(cfg, "chunk_local", False):
        return _mamba_forward_chunk_local(params, x, cfg=cfg)
    B, T, D = x.shape
    di = cfg.d_inner_mult * D
    L = min(cfg.chunk, T)
    pad = (-T) % L
    xz = x @ params["w_in"].to(x.dtype)
    u, z = xz.chunk(2, dim=-1)
    u = F.silu(_conv_causal(u, params["conv_w"].to(u.dtype)))
    dA, dBx, C_t = _ssm_inputs(params, u)
    if pad:
        dA = F.pad(dA, (0, 0, 0, 0, 0, pad), value=1.0)
        dBx = F.pad(dBx, (0, 0, 0, 0, 0, pad))
        C_t = F.pad(C_t, (0, 0, 0, pad))
    h = torch.zeros((B, di, N_state(params)), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(0, T + pad, L):
        h, y = _scan_chunk(h, dA[:, c:c + L], dBx[:, c:c + L],
                           C_t[:, c:c + L])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    y = y + u.float() * params["d_skip"][None, None]
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["w_out"].to(x.dtype)


def _mamba_forward_chunk_local(params, x: torch.Tensor, *, cfg
                               ) -> torch.Tensor:
    """Memory-optimised path: everything is computed per chunk; the conv
    tail (W-1 tokens) is carried between chunks in float32."""
    B, T, D = x.shape
    di = cfg.d_inner_mult * D
    W = params["conv_w"].shape[0]
    L = min(cfg.chunk, T)
    pad = (-T) % L
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    w_in, conv_w = params["w_in"], params["conv_w"]
    h = torch.zeros((B, di, N_state(params)), dtype=torch.float32,
                    device=x.device)
    tail = torch.zeros((B, W - 1, di), dtype=torch.float32, device=x.device)
    outs = []
    for c in range(0, T + pad, L):
        x_c = xp[:, c:c + L]
        u, z = (x_c @ w_in.to(x_c.dtype)).chunk(2, dim=-1)
        u_ext = torch.cat([tail.to(u.dtype), u], dim=1)
        conv = torch.zeros_like(u)
        for i in range(W):
            conv = conv + u_ext[:, i:i + L] * conv_w[i][None, None].to(
                u.dtype)
        uc = F.silu(conv)
        dA, dBx, C_t = _ssm_inputs(params, uc)
        h, y = _scan_chunk(h, dA, dBx, C_t)
        y = y + uc.float() * params["d_skip"][None, None]
        y = y.to(x_c.dtype) * F.silu(z)
        outs.append(y @ params["w_out"].to(x_c.dtype))
        tail = u_ext[:, L:L + W - 1].float()
    return torch.cat(outs, dim=1)[:, :T]


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, W-1, di)
    h: torch.Tensor     # (B, di, N) float32


def mamba_init_state(params, batch: int, dtype=torch.float32
                     ) -> MambaState:
    W, di = params["conv_w"].shape
    dev = params["conv_w"].device
    return MambaState(
        conv=torch.zeros((batch, W - 1, di), dtype=dtype, device=dev),
        h=torch.zeros((batch, di, N_state(params)), dtype=torch.float32,
                      device=dev))


def mamba_step(params, x: torch.Tensor, state: MambaState, *, cfg):
    """Single-token decode. x: (B, 1, D). Returns (y (B, 1, D), the new
    state as new tensors)."""
    u, z = (x @ params["w_in"].to(x.dtype)).chunk(2, dim=-1)   # (B, 1, di)
    conv_in = torch.cat([state.conv, u.to(state.conv.dtype)], dim=1)
    w = params["conv_w"].float()
    u_c = F.silu(torch.einsum("bwd,wd->bd", conv_in.float(), w)[:, None])
    dA, dBx, C_t = _ssm_inputs(params, u_c)
    h = dA[:, 0] * state.h + dBx[:, 0]
    y = torch.einsum("bdn,bn->bd", h, C_t[:, 0])[:, None]
    y = y + u_c.float() * params["d_skip"][None, None]
    y = y.to(x.dtype) * F.silu(z)
    return (y @ params["w_out"].to(x.dtype),
            MambaState(conv=conv_in[:, 1:], h=h))


def mamba_prefill_state(params, x: torch.Tensor, *, cfg) -> MambaState:
    """Exact post-sequence state (conv tail, float32, and ssm state) for
    the decode handoff. x: (B, T, D), the input given to mamba_forward."""
    B, T, D = x.shape
    W = params["conv_w"].shape[0]
    u, _ = (x @ params["w_in"].to(x.dtype)).chunk(2, dim=-1)
    tail = u[:, -(W - 1):]
    if T < W - 1:
        tail = F.pad(u, (0, 0, W - 1 - T, 0))
    u_c = F.silu(_conv_causal(u, params["conv_w"].to(u.dtype)))
    dA, dBx, _ = _ssm_inputs(params, u_c)
    h = torch.zeros((B, u.shape[-1], N_state(params)), dtype=torch.float32,
                    device=x.device)
    for t in range(T):
        h = dA[:, t] * h + dBx[:, t]
    return MambaState(conv=tail.float(), h=h)


def mamba_ref(params, x: torch.Tensor, *, cfg) -> torch.Tensor:
    """Step-by-step oracle (the decode path over the sequence)."""
    state = mamba_init_state(params, x.shape[0])
    ys = []
    for t in range(x.shape[1]):
        y, state = mamba_step(params, x[:, t:t + 1], state, cfg=cfg)
        ys.append(y)
    return torch.cat(ys, dim=1)
