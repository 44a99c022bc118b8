"""Config system: architecture and shape-cell configuration.

Port of ``repro.configs.base``, kept as the port's own copy (plain
dataclasses, no torch). Every assigned architecture has a
``src/repro_torch/configs/<id>.py`` exporting ``CONFIG`` (full-scale, the
reference's numbers) built on :class:`ModelConfig`.
``ModelConfig.reduced()`` derives the CPU-test variant of the same family
(small widths / few layers / tiny vocab).

Beside the reference's archs the port carries architectures of its own
(``PORT_ONLY_ARCHS``), which ``get_config`` knows but ``ASSIGNED_ARCHS``
leaves out, so that every loop over the reference's archs stays as it
is. They may need fields the reference's ``ModelConfig`` lacks; those live
on a subclass (``Mamba2HybridConfig``), and ``ModelConfig`` answers
``None`` for them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Shape cells (assigned input-shape set for the LM family)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    """One (workload kind, seq_len, global_batch) cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeCell("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeCell("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeCell("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeCell("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeCell, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                   LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # "ep": experts sharded over model axis; "tp": expert d_ff sharded.
    parallel_mode: str = "ep"


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    d_inner_mult: int = 2
    conv_width: int = 4
    chunk: int = 128  # chunk length for chunkwise-parallel scans
    # compute projections/gates inside the chunk scan (memory-optimised;
    # baseline materialises (B,T,di,N) inputs for the whole sequence)
    chunk_local: bool = False


@dataclass(frozen=True)
class Mamba2Config:
    """A Mamba-2 mixer (SSD): ``n_heads`` heads of ``head_dim`` channels,
    one scalar decay a head, B and C shared by the heads of each of
    ``n_groups`` groups, state ``state_dim`` a channel; a causal
    depthwise conv of ``conv_width``, with bias, over x, B and C; the
    chunked scan in chunks of ``chunk``; a gated RMS norm over each group
    of channels, the gate applied first."""
    n_heads: int
    head_dim: int
    n_groups: int
    state_dim: int
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_ssm(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        """Channels of the conv: x, then B and C of every group."""
        return self.d_ssm + 2 * self.n_groups * self.state_dim

    @property
    def in_dim(self) -> int:
        """Width of the in-projection: z, x, B, C and one dt a head."""
        return self.d_ssm + self.conv_dim + self.n_heads


@dataclass(frozen=True)
class MuPMultipliers:
    """Falcon-H1's muP multipliers, each a constant factor on one tensor:
    the embeddings, the logits, the attention branch's input and output
    and its keys, the Mamba-2 branch's input and output and the five
    segments z / x / B / C / dt of its in-projection, and the MLP's gate
    and down projections."""
    embedding: float = 1.0
    lm_head: float = 1.0
    attn_in: float = 1.0
    attn_out: float = 1.0
    key: float = 1.0
    ssm_in: float = 1.0
    ssm_out: float = 1.0
    ssm_zxbcdt: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    mlp_gate: float = 1.0
    mlp_down: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    # identity
    arch: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    # transformer backbone
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # activations / variants
    act: str = "swiglu"  # swiglu | relu2 | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention pattern: window size per layer; 0 == global. Specified via a
    # repeating pattern applied cyclically over layers.
    attn_pattern: Tuple[int, ...] = (0,)
    local_window: int = 1_024
    rope_theta_global: Optional[float] = None  # gemma3: different theta on globals
    # encoder-only (no causal mask, no decode step)
    encoder_only: bool = False
    # cross-attention (VLM): one cross-attn layer after every `cross_attn_every`
    # self-attn layers; 0 == disabled. n_layers counts self-attn layers.
    cross_attn_every: int = 0
    n_vision_tokens: int = 0
    # MoE / SSM / hybrid
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # xLSTM: every `slstm_every`-th block is an sLSTM block (0 == none)
    slstm_every: int = 0
    # hybrid (hymba): attention and SSM run in parallel in each layer
    parallel_ssm: bool = False
    # modality frontend stub (audio/vlm): inputs arrive as embeddings
    embedding_inputs: bool = False
    # long-context capability (sub-quadratic path exists)
    supports_long_context: bool = False
    # numerics / memory policy
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # bf16 for the largest archs
    remat: str = "full"  # full | dots | none
    # gradient-accumulation microbatches for train_4k (global_batch divides)
    train_microbatches: int = 8
    # two-level remat: scan over groups of layers, remat inside groups
    remat_groups: Optional[int] = None
    # scan segmentation for heterogeneous stacks (set automatically)
    logical_axis_rules: Tuple[Tuple[str, Optional[str]], ...] = ()

    # the port-only fields of ``Mamba2HybridConfig`` (class attributes
    # here, not fields: the reference's configs compare equal field by
    # field)
    mamba2 = None
    mup = None

    # -- derived ------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def window_for_layer(self, i: int) -> int:
        return self.attn_pattern[i % len(self.attn_pattern)]

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline math."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        if self.mamba2 is not None:
            return self._n_params_mamba2()
        p = V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family != "ssm":  # xLSTM blocks carry no attention
            per_layer += (D * self.q_dim + 2 * D * self.kv_dim
                          + self.q_dim * D)
        # norms
        per_layer += 2 * D
        if self.moe is not None:
            e, fe = self.moe.num_experts, self.moe.d_ff_expert
            n_mats = 3 if self.act == "swiglu" else 2
            per_layer += D * e + e * n_mats * D * fe
        elif self.parallel_ssm and self.ssm is not None:
            di = self.ssm.d_inner_mult * D
            per_layer += D * 2 * di + di * D + di * (2 * self.ssm.state_dim + 2)
            n_mats = 3 if self.act == "swiglu" else 2
            per_layer += n_mats * D * F
        elif self.family == "ssm":
            # xLSTM mLSTM block: Wq,Wk,Wv,Wo,Wog (DxD each) + scalar gate projs
            per_layer += 5 * D * D + 2 * D * self.n_heads
        else:
            n_mats = 3 if self.act == "swiglu" else 2
            per_layer += n_mats * D * F
        if self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            cross = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D + 2 * D
            p += n_cross * cross
        return p + L * per_layer

    def _n_params_mamba2(self) -> int:
        """Every parameter of a parallel attention + Mamba-2 model, the
        final norm included."""
        D, F, V, m = self.d_model, self.d_ff, self.vocab, self.mamba2
        attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
        mixer = (D * m.in_dim + m.conv_dim * (m.conv_width + 1)
                 + 3 * m.n_heads + m.d_ssm + m.d_ssm * D)
        mlp = (3 if self.act == "swiglu" else 2) * D * F
        block = attn + mixer + mlp + 2 * D
        return (V * D * (1 if self.tie_embeddings else 2) + D
                + self.n_layers * block)

    def n_active_params(self) -> int:
        """Active (per-token) parameters — differs from n_params for MoE."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        e, k, fe = self.moe.num_experts, self.moe.top_k, self.moe.d_ff_expert
        n_mats = 3 if self.act == "swiglu" else 2
        inactive = self.n_layers * (e - k) * n_mats * self.d_model * fe
        return full - inactive

    def shape_cells(self) -> Tuple[ShapeCell, ...]:
        """The assigned shape cells applicable to this architecture."""
        cells = [TRAIN_4K, PREFILL_32K]
        if not self.encoder_only:
            cells.append(DECODE_32K)
            if self.supports_long_context:
                cells.append(LONG_500K)
        return tuple(cells)

    def skipped_cells(self) -> Tuple[Tuple[str, str], ...]:
        out = []
        if self.encoder_only:
            out.append(("decode_32k", "encoder-only architecture: no decode step"))
            out.append(("long_500k", "encoder-only architecture: no decode step"))
        elif not self.supports_long_context:
            out.append(
                ("long_500k", "pure full-attention architecture: 500k dense KV "
                              "cache / quadratic attention; no sub-quadratic path")
            )
        return tuple(out)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_vision_tokens=16 if self.cross_attn_every else 0,
            remat="none",
        )
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
            kw["n_layers"] = 4
        if self.slstm_every:
            kw["slstm_every"] = 2
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                capacity_factor=2.0, parallel_mode=self.moe.parallel_mode)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_dim=8, chunk=16)
        if len(self.attn_pattern) > 1:
            kw["attn_pattern"] = self.attn_pattern[: 2]
            kw["local_window"] = 8
        if self.mamba2 is not None:
            kw.update(d_model=256, head_dim=64, d_ff=512, vocab=512,
                      n_kv_heads=2, mamba2=dataclasses.replace(
                          self.mamba2, n_heads=4, head_dim=32, n_groups=2,
                          state_dim=16, chunk=8))
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Mamba2HybridConfig(ModelConfig):
    """A parallel hybrid: attention and a Mamba-2 mixer side by side in
    every block (``parallel_ssm``), their outputs, each times its muP
    multiplier, summed into the residual (hymba's blocks instead average
    the two outputs' norms). The port's own; the reference has no such
    arch."""
    mamba2: Optional[Mamba2Config] = None
    mup: MuPMultipliers = MuPMultipliers()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ASSIGNED_ARCHS: Tuple[str, ...] = (
    "grok-1-314b",
    "qwen3-moe-235b-a22b",
    "xlstm-1.3b",
    "llama-3.2-vision-11b",
    "hubert-xlarge",
    "llama3.2-3b",
    "internlm2-20b",
    "gemma3-1b",
    "nemotron-4-340b",
    "hymba-1.5b",
)

# architectures of the port alone: served, tested against the plain
# reference of the benchmark, outside every loop over the JAX package's
# archs (no sharding specs, dry run or training parity)
PORT_ONLY_ARCHS: Tuple[str, ...] = (
    "falcon-h1-34b",
)


def get_config(arch: str) -> ModelConfig:
    """Load the full-scale config for an architecture id of
    ``ASSIGNED_ARCHS`` or ``PORT_ONLY_ARCHS``."""
    import importlib

    if arch not in ASSIGNED_ARCHS + PORT_ONLY_ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; the port carries "
                         f"{', '.join(ASSIGNED_ARCHS + PORT_ONLY_ARCHS)}")
    mod_name = "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(mod_name)
    cfg = mod.CONFIG
    if cfg.arch != arch:
        raise ValueError(f"{mod_name} holds {cfg.arch!r}, not {arch!r}")
    return cfg


def all_cells() -> Sequence[Tuple[str, ShapeCell]]:
    """Every runnable (arch, shape) dry-run cell."""
    return [(a, cell) for a in ASSIGNED_ARCHS
            for cell in get_config(a).shape_cells()]
