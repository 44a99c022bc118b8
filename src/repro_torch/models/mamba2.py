"""Mamba-2 mixer (SSD), the SSM branch of Falcon-H1's parallel blocks.

Plain PyTorch, no hand kernel. The in-projection gives z (the gate), x, B,
C and one step size a head; a causal depthwise conv (with bias) runs over
x, B and C, then SiLU. Each head h has one scalar decay ``A_h = -exp(a_log)``
a step, ``dt = softplus(dt_raw + dt_bias)``, and the recurrence

    S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t + D_h x_t

per head, over a state of ``head_dim x state_dim``, B and C shared by the
heads of a group. The output goes through a gated RMS norm (per group of
channels) and the out-projection. Falcon-H1's muP multipliers act on the
mixer's input (``ssm_in``) and on the five segments of the in-projection
(``ssm_zxbcdt``); the block applies ``ssm_out``.

``mamba2_forward`` runs a whole sequence with the chunked SSD (chunks of
``chunk`` steps: within a chunk the outputs are masked matrix products,
across chunks the states are carried), and returns the final conv and SSM
state for decoding. Given ``valid`` (False at a row's left padding), the
pad positions' inputs and step sizes are zeroed, so each row's conv window
and state start at its first real token. ``mamba2_step`` is one decode
step against that state, updated in place. ``ssd_sequential`` is the
plain recurrence, for tests.

Parameters keep the port's layout, ``x @ w``; the gated norm's weight is
an offset from 1, as the port's other RMS norms; ``dt_bias``, ``a_log``
and ``d_skip`` are float32. The scan, the conv and the states are float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_mamba2(generator: torch.Generator, d_model: int, m, mup,
                dtype: torch.dtype) -> dict:
    """m: ``Mamba2Config``; mup: ``MuPMultipliers``. The in- and
    out-projections are drawn at the fan-in scale over the muP multiplier
    applied to them (``ssm_in``, ``ssm_out``), so that the branch reaches
    the residual at unit scale as a trained model's does; the conv as
    ``torch.nn.Conv1d`` draws it; step sizes log-uniform in [1e-3, 0.1]
    through the inverse softplus; ``A_h = -h`` (h = 1..heads)."""
    dev = generator.device
    W, C, H = m.conv_width, m.conv_dim, m.n_heads
    bound = 1.0 / math.sqrt(W)

    def uniform(shape, b):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=dev)
        return (2.0 * u - 1.0) * b

    dt = torch.exp(torch.rand((H,), generator=generator, dtype=torch.float32,
                              device=dev)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "w_in": dense_init(generator, d_model, m.in_dim, dtype,
                           scale=1.0 / (math.sqrt(d_model) * mup.ssm_in)),
        "conv_w": uniform((W, C), bound).to(dtype),
        "conv_b": uniform((C,), bound).to(dtype),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "a_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_w": torch.zeros((m.d_ssm,), dtype=dtype, device=dev),
        "w_out": dense_init(generator, m.d_ssm, d_model, dtype,
                            scale=1.0 / (math.sqrt(m.d_ssm) * mup.ssm_out)),
    }


_MULT_VECTORS: dict = {}


def _segment_multipliers(m, mup, dtype, device) -> torch.Tensor:
    """The in-projection's multiplier a channel (z, x, B, C, dt), made
    once per widths, dtype and device."""
    key = (m, mup.ssm_zxbcdt, dtype, str(device))
    vec = _MULT_VECTORS.get(key)
    if vec is None:
        sizes = (m.d_ssm, m.d_ssm, m.n_groups * m.state_dim,
                 m.n_groups * m.state_dim, m.n_heads)
        vec = torch.cat([torch.full((n,), float(k), dtype=dtype,
                                    device=device)
                         for n, k in zip(sizes, mup.ssm_zxbcdt)])
        _MULT_VECTORS[key] = vec
    return vec


def _in_proj(p, h: torch.Tensor, m, mup):
    """(z, xbc, dt_raw): the in-projection of the normed input h, each
    segment times its multiplier, in h's dtype."""
    zxbcdt = (h * mup.ssm_in) @ p["w_in"].to(h.dtype)
    zxbcdt = zxbcdt * _segment_multipliers(m, mup, h.dtype, h.device)
    return zxbcdt.split((m.d_ssm, m.conv_dim, m.n_heads), dim=-1)


def _split_xbc(xbc: torch.Tensor, m):
    """x (..., heads, head_dim), B and C (..., groups, state)."""
    x, B, C = xbc.split((m.d_ssm, m.n_groups * m.state_dim,
                         m.n_groups * m.state_dim), dim=-1)
    lead = xbc.shape[:-1]
    return (x.reshape(*lead, m.n_heads, m.head_dim),
            B.reshape(*lead, m.n_groups, m.state_dim),
            C.reshape(*lead, m.n_groups, m.state_dim))


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
               n_groups: int, eps: float) -> torch.Tensor:
    """``y * silu(z)``, then an RMS norm over each of ``n_groups`` groups
    of channels, weight ``1 + w``. float32."""
    y = y.float() * F.silu(z.float())
    g = y.reshape(*y.shape[:-1], n_groups, y.shape[-1] // n_groups)
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + eps)
    return g.reshape(y.shape) * (1.0 + w.float())


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int):
    """The SSD scan in chunks, float32, from a zero state.

    x: (b, T, H, P); dt: (b, T, H), already through softplus; A: (H,);
    B, C: (b, T, G, N), group g serving heads g*H/G .. (g+1)*H/G - 1.
    Returns y (b, T, H, P), without the D skip, and the state after the
    last step (b, H, P, N). T is padded at the end to a whole chunk with
    dt = 0 (no decay, no input), so the state is that of step T - 1."""
    b, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    J = H // G
    L = min(chunk, T)
    pad = (-T) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    c = (T + pad) // L
    x = x.reshape(b, c, L, G, J, P)
    dt = dt.reshape(b, c, L, G, J)
    B = B.reshape(b, c, L, G, N)
    C = C.reshape(b, c, L, G, N)
    acs = torch.cumsum(dt * A.reshape(G, J), dim=2)          # (b,c,L,G,J)
    xdt = x * dt[..., None]
    # within a chunk: y_l = sum_{s<=l} (C_l . B_s) exp(acs_l - acs_s) xdt_s
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    seg = acs[:, :, :, None] - acs[:, :, None, :]            # (b,c,l,s,G,J)
    decay = torch.exp(seg.masked_fill(~causal[:, :, None, None],
                                      -math.inf))
    cb = torch.einsum("bclgn,bcsgn->bclsg", C, B)
    y = torch.einsum("bclsgj,bcsgjp->bclgjp", cb[..., None] * decay, xdt)
    # each chunk's own state, then the states carried across chunks
    to_end = torch.exp(acs[:, :, -1:] - acs)                 # (b,c,L,G,J)
    states = torch.einsum("bcsgn,bcsgjp->bcgjpn", B,
                          xdt * to_end[..., None])
    whole = torch.exp(acs[:, :, -1])                         # (b,c,G,J)
    h = torch.zeros((b, G, J, P, N), dtype=torch.float32, device=x.device)
    prev = []
    for k in range(c):
        prev.append(h)
        h = h * whole[:, k, ..., None, None] + states[:, k]
    prev = torch.stack(prev, dim=1)                          # (b,c,G,J,P,N)
    y = y + torch.einsum("bclgn,bcgjpn->bclgjp", C, prev) \
        * torch.exp(acs)[..., None]
    y = y.reshape(b, c * L, H, P)[:, :T]
    return y, h.reshape(b, H, P, N)


def ssd_sequential(x, dt, A, B, C):
    """The recurrence step by step (the chunked scan's oracle): same
    arguments and results as :func:`ssd_chunked`."""
    b, T, H, P = x.shape
    G = B.shape[2]
    Bh = B.repeat_interleave(H // G, dim=2)                  # (b,T,H,N)
    Ch = C.repeat_interleave(H // G, dim=2)
    h = torch.zeros((b, H, P, B.shape[3]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(T):
        a = torch.exp(dt[:, t] * A)                          # (b, H)
        h = h * a[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1), h


def _conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    """Causal depthwise conv, float32, zeros before the first step, then
    SiLU. xbc: (B, T, C); w: (W, C); b: (C,)."""
    W, T = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc.float(), (0, 0, W - 1, 0))
    out = b.float().expand_as(xp[:, :T]).clone()
    for i in range(W):
        out = out + xp[:, i:i + T] * w[i].float()
    return F.silu(out)


def mamba2_forward(p, h: torch.Tensor, m, mup, *, eps: float,
                   valid: torch.Tensor = None):
    """Whole sequence. h: (B, T, D), the block's normed input; valid:
    (B, T) bool, False at left padding, or None. Returns (out (B, T, D)
    in h's dtype, before ``ssm_out``; conv state (B, W - 1, conv_dim) and
    SSM state (B, H, P, N), float32, after the last step)."""
    if valid is not None:
        h = h * valid[..., None].to(h.dtype)
    z, xbc, dt = _in_proj(p, h, m, mup)
    W = m.conv_width
    tail = xbc[:, -(W - 1):].float()
    if tail.shape[1] < W - 1:
        tail = F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))
    u = _conv(xbc, p["conv_w"], p["conv_b"])
    dt = F.softplus(dt.float() + p["dt_bias"])
    if valid is not None:
        u = u * valid[..., None]
        dt = dt * valid[..., None]
    x, B, C = _split_xbc(u, m)
    y, state = ssd_chunked(x, dt, -torch.exp(p["a_log"]), B, C, m.chunk)
    y = y + x * p["d_skip"][:, None]
    y = gated_norm(y.reshape(*y.shape[:2], m.d_ssm), z, p["norm_w"],
                   m.n_groups, eps)
    return y.to(h.dtype) @ p["w_out"].to(h.dtype), tail, state


def mamba2_step(p, h: torch.Tensor, conv_state: torch.Tensor,
                ssm_state: torch.Tensor, m, mup, *, eps: float
                ) -> torch.Tensor:
    """One token. h: (B, 1, D); conv_state (B, W - 1, conv_dim) and
    ssm_state (B, H, P, N), float32, updated in place. Returns out
    (B, 1, D), before ``ssm_out``."""
    z, xbc, dt = _in_proj(p, h, m, mup)
    win = torch.cat([conv_state, xbc.float()], dim=1)        # (B, W, C)
    u = F.silu((win * p["conv_w"].float()).sum(dim=1)
               + p["conv_b"].float())                        # (B, C)
    conv_state.copy_(win[:, 1:])
    x, B, C = _split_xbc(u, m)                               # (B,H,P), (B,G,N)
    J = m.n_heads // m.n_groups
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])         # (B, H)
    a = torch.exp(dt * -torch.exp(p["a_log"]))
    ssm_state.mul_(a[..., None, None]).addcmul_(
        (dt[..., None] * x)[..., None],
        B.repeat_interleave(J, dim=1)[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", ssm_state,
                     C.repeat_interleave(J, dim=1))
    y = y + x * p["d_skip"][:, None]
    y = gated_norm(y.reshape(y.shape[0], 1, m.d_ssm), z, p["norm_w"],
                   m.n_groups, eps)
    return y.to(h.dtype) @ p["w_out"].to(h.dtype)
