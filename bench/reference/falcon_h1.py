"""Plain reference of Falcon-H1's causal LM, for the comparison that decides
``correct`` in the route scorer's cell and for the CPU tests.

It follows ``transformers.models.falcon_h1.modeling_falcon_h1`` (version
4.57): ``FalconH1ForCausalLM`` with eager attention and the Mamba-2
mixer's ``torch_forward``, from the keys of the model's ``config.json``
(``cfg``, the benchmark's configuration file). Plain PyTorch, float32,
one sequence at a time: no cache, no batching, no chunking; the SSM is the
recurrence over tokens in order. It imports nothing of the program.

Each block: ``h = rms_norm(x)``; attention on ``h * attention_in_multiplier``
(GQA, keys times ``key_multiplier`` before RoPE, rotate-half RoPE,
scale ``head_dim ** -0.5``, causal softmax), times
``attention_out_multiplier``; the Mamba-2 mixer on ``h``: input times
``ssm_in_multiplier``, in-projection times ``ssm_multipliers`` on its z /
x / B / C / dt segments, causal depthwise conv (with bias) over x||B||C and
SiLU, ``dt = softplus(dt + dt_bias)``, per head ``S_t = exp(dt A) S_{t-1} +
dt x_t B_t^T``, ``y_t = S_t C_t + D x_t``, the gated RMS norm per group
(``y * silu(z)`` first where ``mamba_norm_before_gate`` is false),
out-projection, times ``ssm_out_multiplier``; both summed into the
residual; then ``rms_norm`` and the MLP ``down(up(x) * silu(gate(x) *
m_gate)) * m_down``. Embeddings times ``embedding_multiplier``; logits
``lm_head(final_norm(x)) * lm_head_multiplier``.

Departures from the transformers file, none of which changes a value in
exact arithmetic: the SSM runs step by step where transformers runs its
chunked form; the conv is written as its sum over the window (four
shifted products); the in-projection's multipliers are applied a segment
at a time.

Weights are plain tensors in the layout ``x @ w`` (d_in, d_out), norm
weights multiplicative (1.0 = identity). ``forward`` takes them whole;
``embed``, ``block`` and ``head`` (or ``logits``) take them a piece at a
time, so that on the card the program's weights can be upcast one layer at
a time.
``from_port_*`` map the program's parameter dicts onto this layout by key
(its norms store an offset from 1; a tied model's head is its embedding).

``CONTROLS`` names the controls of ``correct`` in the route scorer's cell
and the weight groups each rounds to the precision below the
configuration's; ``matrices`` yields those groups' matrices from the
program's tree, in a fixed order.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List

import torch
import torch.nn.functional as F


def strict_float32() -> None:
    """No TF32 in float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def embed(w_embed: torch.Tensor, tokens: torch.Tensor, cfg: dict
          ) -> torch.Tensor:
    """(T,) ids -> (T, D) float32."""
    return w_embed[tokens].float() * cfg["embedding_multiplier"]


def head(w_norm: torch.Tensor, w_unembed: torch.Tensor, x: torch.Tensor,
         cfg: dict) -> torch.Tensor:
    """(T, D) -> (T, V) logits, float32."""
    h = _rms(x, w_norm.float(), cfg["rms_norm_eps"])
    return (h @ w_unembed.float().T) * cfg["lm_head_multiplier"]


def logits(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict
           ) -> torch.Tensor:
    """``head`` with the final norm and the head of ``from_port``'s tree
    (or ``forward``'s weights)."""
    return head(w["final_norm"], w["unembed"], x, cfg)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (heads, T, d); rotate-half RoPE at positions 0 .. T - 1."""
    d, T = x.shape[-1], x.shape[-2]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64,
                                        device=x.device).float() / d))
    ang = torch.arange(T, device=x.device).float()[:, None] * inv[None]
    cos = torch.cat([ang, ang], -1).cos()
    sin = torch.cat([ang, ang], -1).sin()
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(w: Dict[str, torch.Tensor], h: torch.Tensor, cfg: dict
              ) -> torch.Tensor:
    T = h.shape[0]
    nh, nkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    q = (h @ w["q"]).view(T, nh, d).transpose(0, 1)
    k = (h @ w["k"]).view(T, nkv, d).transpose(0, 1) * cfg["key_multiplier"]
    v = (h @ w["v"]).view(T, nkv, d).transpose(0, 1)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(nh // nkv, dim=0)
    v = v.repeat_interleave(nh // nkv, dim=0)
    s = (q @ k.transpose(1, 2)) * d ** -0.5
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool,
                                 device=h.device).triu(1), -math.inf)
    o = torch.softmax(s, dim=-1) @ v                       # (nh, T, d)
    return o.transpose(0, 1).reshape(T, nh * d) @ w["o"]


def mixer(w: Dict[str, torch.Tensor], h: torch.Tensor, cfg: dict
          ) -> torch.Tensor:
    """The Mamba-2 mixer over one sequence, step by step."""
    T = h.shape[0]
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    G, N = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    K = cfg["mamba_d_conv"]
    d_ssm = cfg["mamba_d_ssm"]
    gs = G * N
    proj = (h * cfg["ssm_in_multiplier"]) @ w["in_proj"]
    m = cfg["ssm_multipliers"]
    z = proj[:, :d_ssm] * m[0]
    xs = proj[:, d_ssm:2 * d_ssm] * m[1]
    Bs = proj[:, 2 * d_ssm:2 * d_ssm + gs] * m[2]
    Cs = proj[:, 2 * d_ssm + gs:2 * d_ssm + 2 * gs] * m[3]
    dts = proj[:, 2 * d_ssm + 2 * gs:] * m[4]
    xbc = torch.cat([xs, Bs, Cs], -1)                      # (T, conv_dim)
    padded = torch.cat([torch.zeros(K - 1, xbc.shape[1], device=h.device),
                        xbc])
    conv = w["conv_b"] + sum(padded[i:i + T] * w["conv_w"][:, i]
                             for i in range(K))
    xbc = F.silu(conv)
    x = xbc[:, :d_ssm].view(T, H, P)
    B = xbc[:, d_ssm:d_ssm + gs].view(T, G, N).repeat_interleave(H // G, 1)
    C = xbc[:, d_ssm + gs:].view(T, G, N).repeat_interleave(H // G, 1)
    dt = F.softplus(dts + w["dt_bias"])                    # (T, H)
    decay = torch.exp(dt * -torch.exp(w["A_log"]))[:, :, None, None]
    dtx = (dt[:, :, None] * x)[..., None]                  # (T, H, P, 1)
    B, C = B[:, :, None, :], C[:, :, :, None]       # (T,H,1,N), (T,H,N,1)
    S = torch.zeros(H, P, N, device=h.device)
    ys = []
    for t in range(T):
        S = S * decay[t] + dtx[t] * B[t]
        ys.append(S @ C[t])
    y = (torch.stack(ys)[..., 0] + w["D"][:, None] * x).reshape(T, d_ssm)
    if not cfg["mamba_norm_before_gate"]:
        y = y * F.silu(z)
    g = y.view(T, G, d_ssm // G)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"])
    y = g.reshape(T, d_ssm) * w["norm"]
    if cfg["mamba_norm_before_gate"]:
        y = y * F.silu(z)
    return y @ w["out_proj"]


def mlp(w: Dict[str, torch.Tensor], h: torch.Tensor, cfg: dict
        ) -> torch.Tensor:
    gm, dm = cfg["mlp_multipliers"]
    y = (h @ w["up"]) * F.silu((h @ w["gate"]) * gm)
    return (y @ w["down"]) * dm


def to_float32(w: dict) -> dict:
    """A layer's weights upcast (tensors already float32 are kept)."""
    return {k: (v.float() if torch.is_tensor(v) else to_float32(v))
            for k, v in w.items()}


def block(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict
          ) -> torch.Tensor:
    """One decoder layer over one sequence x (T, D), float32. ``w``: the
    layer's weights (any float dtype; upcast here)."""
    w = to_float32(w)
    eps = cfg["rms_norm_eps"]
    h = _rms(x, w["input_norm"], eps)
    m = mixer(w["mamba"], h, cfg) * cfg["ssm_out_multiplier"]
    a = attention(w["attn"], h * cfg["attention_in_multiplier"], cfg) \
        * cfg["attention_out_multiplier"]
    x = x + (m + a)
    return x + mlp(w["mlp"], _rms(x, w["pre_ff_norm"], eps), cfg)


def forward(weights: dict, tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Logits (T, V) of one sequence (T,), float32. ``weights``: "embed",
    "unembed", "final_norm" and "layers" (a list of ``block``'s dicts)."""
    x = embed(weights["embed"], tokens, cfg)
    for lw in weights["layers"]:
        x = block(lw, x, cfg)
    return logits(weights, x, cfg)


# -- the program's parameter tree, read by key ------------------------------

def from_port_block(p: dict) -> dict:
    """One block of the program's tree (``blocks[0][i]``) in this layout."""
    m = p["mamba2"]
    return {
        "input_norm": 1.0 + p["norm1"]["w"].float(),
        "attn": {"q": p["attn"]["wq"], "k": p["attn"]["wk"],
                 "v": p["attn"]["wv"], "o": p["attn"]["wo"]},
        "mamba": {"in_proj": m["w_in"], "conv_w": m["conv_w"].T,
                  "conv_b": m["conv_b"], "dt_bias": m["dt_bias"],
                  "A_log": m["a_log"], "D": m["d_skip"],
                  "norm": 1.0 + m["norm_w"].float(),
                  "out_proj": m["w_out"]},
        "pre_ff_norm": 1.0 + p["norm2"]["w"].float(),
        "mlp": {"gate": p["ffn"]["wg"], "up": p["ffn"]["wi"],
                "down": p["ffn"]["wo"]},
    }


def from_port(params: dict, cfg: dict | None = None) -> dict:
    """The program's whole tree in this layout (tensors shared, not
    copied; upcast in ``block``). Where ``cfg`` (the configuration's keys)
    ties the embeddings, the head is the embedding."""
    tied = bool(cfg and cfg.get("tie_word_embeddings"))
    layers: List[dict] = [from_port_block(b) for run in params["blocks"]
                          for b in run]
    return {"embed": params["embed"],
            "unembed": params["embed" if tied else "unembed"],
            "final_norm": 1.0 + params["norm_f"]["w"].float(),
            "layers": layers}


# -- the controls: weight groups rounded below the configuration's precision

# each block's weight groups, by the program's keys
_GROUPS = (("attn", ("wq", "wk", "wv", "wo")),
           ("mamba2", ("w_in", "w_out")),
           ("ffn", ("wg", "wi", "wo")))
# "fp8" every weight matrix, "mlp_fp8" the MLP's alone
CONTROLS = {"mlp_fp8": ("ffn",),
            "fp8": ("embed", "unembed", "attn", "mamba2", "ffn")}


def matrices(params: dict, parts) -> Iterator[torch.Tensor]:
    """The weight matrices of ``parts`` ("embed", "unembed" and the block
    groups "attn", "mamba2", "ffn") in the program's tree, in a fixed
    order; a tied model has no "unembed" of its own."""
    for k in ("embed", "unembed"):
        if k in parts and k in params:
            yield params[k]
    for run in params["blocks"]:
        for blk in run:
            for g, keys in _GROUPS:
                if g in parts:
                    for k in keys:
                        yield blk[g][k]
