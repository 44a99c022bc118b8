"""Model registry: the public entry point for building any assigned arch.

Port of ``repro.models.registry``. ``build_model(cfg, ctx)`` binds a sharding
context (``sharding.specs.ShardCtx``) into every function, as the
reference does; with one, the functions take DTensor parameters and
inputs and run under ``implicit_replication``, so that the plain tensors
the model makes (positions, masks, zeros) act as replicated.
``Model.loss(params, batch)`` is the training loss (``transformer.loss_fn``)
that ``repro_torch.train`` differentiates. ``Model.init(device="meta")``
gives the parameter tree's shapes and dtypes without storage."""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.sharding.specs import implicit_replication


class Model(NamedTuple):
    """Bundle of functions for one architecture."""

    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., torch.Tensor]
    logits: Callable[..., torch.Tensor]
    prefill: Callable[..., Any]
    # (params, cache, toks, lens) -> (last logits, passes, tokens
    # computed): a batch of prompts into a decode cache
    prefill_prompts: Callable[..., Any]
    decode_step: Callable[..., Any]
    # (params, max_seq, device) -> the device's decoder, kept across
    # batches (``decode.decoder``: captured for a Mamba-2 hybrid on the
    # card, eager otherwise)
    decoder: Callable[..., Any]
    cache_struct: Callable[[int, int], Any]
    init_cache: Callable[..., Any]


class _OnMeta(TorchFunctionMode):
    """Every tensor the initialisers make lands on the meta device, and
    nothing is drawn."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        kwargs.pop("generator", None)
        return func(*args, **kwargs)


def _init(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
          device="cuda"):
    """Random parameters on ``device``, drawn from ``generator`` (seeded 0
    when none is given), which must live on that device. On ``"meta"``:
    the tree's shapes and dtypes, nothing drawn."""
    dev = resolve_device(device, meta_ok=True)
    if dev.type == "meta":
        with _OnMeta():
            return tf_mod.init_params(cfg, torch.Generator())
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters "
                         f"asked for on {dev}")
    return tf_mod.init_params(cfg, generator)


def _sharded(fn: Callable, ctx) -> Callable:
    """``fn`` with ``ctx`` bound, under ``implicit_replication`` when there
    is a context."""
    fn = functools.partial(fn, ctx=ctx)
    if ctx is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with implicit_replication():
            return fn(*args, **kwargs)
    return run


def build_model(cfg_or_arch, ctx=None) -> Model:
    """Build a Model for a ModelConfig or an architecture id of
    ``ASSIGNED_ARCHS`` or ``PORT_ONLY_ARCHS``. A Mamba-2 hybrid runs
    unsharded (``ctx`` must be None)."""
    cfg = (cfg_or_arch if isinstance(cfg_or_arch, ModelConfig)
           else get_config(cfg_or_arch))
    if cfg.mamba2 is not None and ctx is not None:
        raise ValueError(f"{cfg.arch}: no sharded path")
    step = _sharded(functools.partial(decode_mod.decode_step, cfg=cfg), ctx)
    return Model(
        cfg=cfg,
        init=functools.partial(_init, cfg),
        loss=_sharded(functools.partial(tf_mod.loss_fn, cfg=cfg), ctx),
        logits=_sharded(functools.partial(tf_mod.logits_fn, cfg=cfg), ctx),
        prefill=_sharded(functools.partial(decode_mod.prefill, cfg=cfg),
                         ctx),
        prefill_prompts=_sharded(functools.partial(
            decode_mod.prefill_prompts, cfg=cfg), ctx),
        decode_step=step,
        decoder=functools.partial(decode_mod.decoder, cfg=cfg, step=step),
        cache_struct=functools.partial(decode_mod.cache_struct, cfg),
        init_cache=functools.partial(decode_mod.init_cache, cfg),
    )


def make_inputs(cfg: ModelConfig, batch: int, seq_len: int, rng=None, *,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A random prefill batch drawn from the numpy generator ``rng``
    (``default_rng(0)`` when None) in the reference's order, so one seed
    gives both packages the same arrays; tensors on ``device``.

    Token ids and labels are int64; embeddings (the audio and vision
    frontends are stubs: ``embeds``, ``vision_embeds``) are bf16 for a
    bf16 config, float32 otherwise.
    """
    dev = resolve_device(device)
    r = np.random.default_rng(0) if rng is None else rng
    emb_dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def ints(shape):
        return torch.as_tensor(r.integers(0, cfg.vocab, shape),
                               dtype=torch.long).to(dev)

    def normal(shape):
        return torch.as_tensor(r.standard_normal(shape)).to(dev, emb_dt)

    out: Dict[str, torch.Tensor] = {}
    if cfg.embedding_inputs:
        out["embeds"] = normal((batch, seq_len, cfg.d_model))
    else:
        out["tokens"] = ints((batch, seq_len))
    out["labels"] = ints((batch, seq_len))
    if cfg.cross_attn_every:
        out["vision_embeds"] = normal((batch, cfg.n_vision_tokens,
                                       cfg.d_model))
    return out
