"""Model registry: the public entry point for building a ported arch.

Port of ``repro.models.registry``. There is no sharding context: the port's
sharding is ROADMAP.md queue 1, item 11."""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer as tf_mod


class Model(NamedTuple):
    """Bundle of functions for one architecture."""

    cfg: ModelConfig
    init: Callable[..., Any]
    logits: Callable[..., torch.Tensor]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    cache_struct: Callable[[int, int], Any]
    init_cache: Callable[..., Any]


def _init(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
          device="cuda"):
    """Random parameters on ``device``, drawn from ``generator`` (seeded 0
    when none is given), which must live on that device."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters "
                         f"asked for on {dev}")
    return tf_mod.init_params(cfg, generator)


def build_model(cfg_or_arch) -> Model:
    """Build a Model for a ModelConfig or a ported architecture id."""
    cfg = (cfg_or_arch if isinstance(cfg_or_arch, ModelConfig)
           else get_config(cfg_or_arch))
    tf_mod.check_supported(cfg)
    return Model(
        cfg=cfg,
        init=functools.partial(_init, cfg),
        logits=functools.partial(tf_mod.logits_fn, cfg=cfg),
        prefill=functools.partial(decode_mod.prefill, cfg=cfg),
        decode_step=functools.partial(decode_mod.decode_step, cfg=cfg),
        cache_struct=functools.partial(decode_mod.cache_struct, cfg),
        init_cache=functools.partial(decode_mod.init_cache, cfg),
    )
