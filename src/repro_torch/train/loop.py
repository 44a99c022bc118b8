"""Training loop: microbatched train step + prefetching data pipeline +
async checkpointing + failure handling (restart from the last checkpoint) +
straggler policy.

Port of ``repro.train.loop``. ``fit`` runs on ``device`` (the card unless
the caller asks for the CPU): eager autograd and the in-place
``AdamW.update``, through ``_local_step`` without a sharding context, and
through ``launch.steps.build_train_step`` with one (``ctx``), its
parameters, optimizer state and batches placed as DTensors on
``ctx.mesh`` by the sharding policy.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Prefetcher
from repro_torch.device import resolve_device
from repro_torch.ft.failures import FailureInjector, StragglerPolicy
from repro_torch.launch.steps import (_grads, build_train_step, place,
                                      opt_state_shardings)
from repro_torch.models.registry import Model, build_model
from repro_torch.sharding.specs import param_shardings
from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map


@dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup: int = 20
    microbatches: int = 1
    schedule_steps: Optional[int] = None  # LR schedule horizon (default steps)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    seed: int = 0
    log_every: int = 10


@dataclass
class TrainResult:
    """The reference's fields, then what the port adds: each step's grad
    norm and the final parameters and optimizer state (the tensors the
    loop updated in place)."""
    losses: List[float]
    steps_done: int
    restarts: int
    step_times: List[float]
    grad_norms: List[float] = field(default_factory=list)
    params: Any = None
    opt_state: Any = None


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A pipeline batch as tensors on ``device``: token ids and labels as
    int64 (the port indexes with them), embeddings as they come."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device, torch.long) if np.issubdtype(
            v.dtype, np.integer) else t.to(device)
    return out


def make_optimizer(cfg: ModelConfig, tc: TrainConfig) -> AdamW:
    """``fit``'s AdamW: the schedule of ``tc``, the state dtype of
    ``cfg.optimizer_dtype``."""
    return AdamW(lr=tc.lr, warmup=tc.warmup,
                 total_steps=tc.schedule_steps or tc.steps,
                 state_dtype=torch.bfloat16
                 if cfg.optimizer_dtype == "bfloat16" else torch.float32)


def fit(cfg: ModelConfig, tc: TrainConfig, *, ctx=None,
        injector: Optional[FailureInjector] = None,
        log: Callable[[str], None] = print, device="cuda") -> TrainResult:
    dev = resolve_device(device)
    model = build_model(cfg, ctx)
    opt = make_optimizer(cfg, tc)
    step_fn = build_train_step(model, ctx, opt, tc.microbatches) if ctx \
        else _local_step(model, opt, tc.microbatches)
    pshard = oshard = None
    if ctx is not None:
        pshard = param_shardings(model.init(device="meta"), cfg, ctx)
        oshard = opt_state_shardings(pshard, ctx.mesh)

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(tc.seed)
        p = model.init(gen, device=dev)
        if ctx is not None:
            p = place(p, pshard)
        return p, opt.init(p)

    def restored(last):
        tree = {"params": params, "opt": opt_state}
        shardings = None if ctx is None else \
            {"params": pshard, "opt": oshard}
        r = store.restore(tc.ckpt_dir, last, tree, shardings, device=dev)
        return r["params"], r["opt"]

    def to_device(batch):
        b = batch_to_device(batch, dev)
        return b if ctx is None else place(b, ctx.batch_spec(b))

    params, opt_state = fresh()
    start = 0
    ckpt = store.AsyncCheckpointer(tc.ckpt_dir, keep=tc.keep) \
        if tc.ckpt_dir else None
    if tc.ckpt_dir:
        last = store.latest_step(tc.ckpt_dir)
        if last is not None:
            params, opt_state = restored(last)
            start = last
            log(f"[train] resumed from step {last}")

    pf = Prefetcher(cfg, tc.batch, tc.seq_len, seed=tc.seed,
                    start_step=start)
    straggler = StragglerPolicy()
    losses, times, gnorms = [], [], []
    restarts = 0
    step = start
    try:
        while step < tc.steps:
            if injector is not None and injector.check(step):
                # simulated node failure: drop state, restore from ckpt
                injector.schedule.pop(step, None)  # fires once
                restarts += 1
                log(f"[train] injected failure at step {step}; restarting")
                if ckpt:
                    ckpt.wait()
                last = store.latest_step(tc.ckpt_dir) if tc.ckpt_dir else None
                if last is None:
                    params, opt_state = fresh()
                    step = 0
                else:
                    params, opt_state = restored(last)
                    step = last
                pf.close()
                pf = Prefetcher(cfg, tc.batch, tc.seq_len, seed=tc.seed,
                                start_step=step)
                continue

            t0 = time.perf_counter()
            got_step, batch = pf.next()
            if got_step != step:
                raise RuntimeError(f"prefetcher at step {got_step}, the "
                                   f"loop at {step}")
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 to_device(batch))
            loss = float(metrics["loss"])
            gnorms.append(float(metrics["grad_norm"]))
            dt = time.perf_counter() - t0
            straggler.observe(dt)
            losses.append(loss)
            times.append(dt)
            step += 1
            if step % tc.log_every == 0:
                log(f"[train] step={step} loss={loss:.4f} "
                    f"dt={dt*1e3:.1f}ms")
            if ckpt and step % tc.ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt_state})
        if ckpt:
            ckpt.save(tc.steps, {"params": params, "opt": opt_state})
            ckpt.wait()
    finally:
        pf.close()
    return TrainResult(losses=losses, steps_done=step, restarts=restarts,
                       step_times=times, grad_norms=gnorms, params=params,
                       opt_state=opt_state)


def _local_step(model: Model, opt: AdamW, n_mb: int):
    """step(params, opt_state, batch) -> (params, opt_state, metrics): one
    optimizer step on the batch, split into ``n_mb`` contiguous row blocks
    whose float32 grads and losses are averaged. Updates ``params`` and the
    state's moments in place."""
    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if n_mb == 1:
            loss, grads = _grads(model, params, leaves, batch)
        else:
            rows = next(iter(batch.values())).shape[0] // n_mb
            grads, loss = None, None
            for i in range(n_mb):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l_mb, g_mb = _grads(model, params, leaves, mb)
                if grads is None:       # the first block's grads accumulate
                    grads, loss = g_mb, l_mb
                    continue
                for a, g in zip(grads, g_mb):
                    a.add_(g)
                del g_mb
                loss = loss + l_mb
            for g in grads:
                g.div_(n_mb)
            loss = loss / n_mb
        flat = iter(grads)
        params, opt_state, gnorm = opt.update(
            tree_map(lambda _: next(flat), params), opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step
