"""Training parity: the port's loss, gradients, remat modes, AdamW and train
step (``repro_torch.models`` / ``repro_torch.train``) against the JAX
package on the CPU, on the JAX package's own initialised parameters carried
across by ``convert.params_from_numpy`` (which carries a gradient tree leaf
for leaf too), every arch at ``reduced()`` size in float32.

Tolerances (float32):
- losses: ``atol = rtol = 1e-5`` (another summation order over at most a
  few thousand terms);
- gradients: each leaf within ``1e-4 * max|g_ref|`` of the reference's
  (measured: within 3e-6 of it for every arch);
- AdamW on identical gradients: ``atol = rtol = 1e-6`` (the same float32
  arithmetic; the port may fuse a multiply-add);
- a train step's new parameters: within 1e-6 wherever the reference's
  gradient is at least 1e-6 in size; below that Adam's normalised update
  ``m / (sqrt(v) + eps)`` of a gradient within float32 rounding of zero is
  ill-conditioned, and such elements are held to the most one step can move
  them, ``2 * lr``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import synth_batch as j_synth_batch
from repro.models.common import cross_entropy as j_cross_entropy
from repro.models.registry import build_model as j_build_model
from repro.train.loop import _local_step as j_local_step
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs.base import ASSIGNED_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import synth_batch
from repro_torch.models.common import cross_entropy
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.train.loop import _local_step, batch_to_device
from repro_torch.train.optimizer import AdamW, tree_leaves

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-4
ADAM_TOL = dict(atol=1e-6, rtol=1e-6)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _j_init(arch):
    """(port cfg, JAX model, the JAX package's float32 params as numpy)."""
    j_model = j_build_model(_f32(j_get_config(arch).reduced()))
    tree = _np_tree(jax.jit(j_model.init)(jax.random.PRNGKey(0)))
    if "cross" in tree:          # a zero gate would hide the cross attention
        tree["cross"]["gate"][:] = 0.5
    return _f32(get_config(arch).reduced()), j_model, tree


def _port_grads(cfg, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = build_model(cfg).loss(params, batch)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True)


@pytest.mark.parametrize("ignore", [False, True])
def test_cross_entropy_matches_reference(ignore):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((4, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (4, 7)).astype(np.int64)
    if ignore:
        labels[rng.random((4, 7)) < 0.4] = -1
    want = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    if ignore:                        # the masked positions weigh nothing
        keep = labels != -1
        ref = cross_entropy(torch.tensor(logits[keep]),
                            torch.tensor(labels[keep]))
        np.testing.assert_allclose(got.item(), ref.item(), **LOSS_TOL)


@pytest.fixture(scope="module", params=ASSIGNED_ARCHS)
def loss_pair(request):
    """(reference loss, reference grads, port loss, port grads) for one
    arch on one make_inputs batch."""
    cfg, j_model, tree = _j_init(request.param)
    batch = make_inputs(cfg, B, S, np.random.default_rng(0), device="cpu")
    j_batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    j_loss, j_grads = jax.value_and_grad(j_model.loss)(
        jax.tree_util.tree_map(jnp.asarray, tree), j_batch)
    want_g = tree_leaves(params_from_numpy(_np_tree(j_grads), cfg,
                                           device="cpu"))
    loss, grads = _port_grads(cfg, params_from_numpy(tree, cfg,
                                                     device="cpu"), batch)
    return float(j_loss), want_g, loss.item(), grads


def test_loss_matches_reference(loss_pair):
    want, _, got, _ = loss_pair
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_loss_grads_match_reference(loss_pair):
    _, want, _, got = loss_pair
    assert len(got) == len(want)
    scale = max(float(g.abs().max()) for g in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_REL * scale)


def test_encoder_loss_masks_nothing_and_lm_loss_shifts():
    """hubert's loss covers every position; an LM's covers positions
    1..S-1 (labels shifted by one), chunked or not."""
    for arch in ("hubert-xlarge", "llama3.2-3b"):
        cfg = _f32(get_config(arch).reduced())
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        batch = make_inputs(cfg, B, S, np.random.default_rng(1),
                            device="cpu")
        with torch.no_grad():
            logits = model.logits(params, batch)
            if cfg.encoder_only:
                want = cross_entropy(logits, batch["labels"])
            else:
                want = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
            for chunk in (1024, 5):
                got = model.loss(params, batch, ce_chunk=chunk)
                np.testing.assert_allclose(got.item(), want.item(),
                                           **LOSS_TOL)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,groups", [("llama3.2-3b", None),
                                         ("nemotron-4-340b", 2),
                                         ("xlstm-1.3b", None),
                                         ("llama-3.2-vision-11b", None),
                                         ("hymba-1.5b", None)])
def test_remat_modes_identical(arch, groups):
    """remat "none", "full" and "dots" (and the two-level form) give the
    same loss and grads, bit for bit. Counted in the backward pass: "dots"
    reruns no weight product (``aten.mm``) beyond "none"'s and reruns the
    batched ones (``aten.bmm``); "full" reruns weight products too; with
    groups every mode reruns each group whole."""
    base = _f32(get_config(arch).reduced())
    model = build_model(base)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_inputs(base, B, S, np.random.default_rng(0), device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out, mm = {}, {}
    modes = [("none", None), ("none", groups), ("full", groups),
             ("dots", groups)]
    for remat, g in modes:
        cfg = dataclasses.replace(base, remat=remat, remat_groups=g)
        bwd = _CountOps()
        loss = build_model(cfg).loss(params, batch)
        with bwd:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        out[remat, g] = (loss.detach(), grads)
        mm[remat, g] = (bwd.n.get(torch.ops.aten.mm.default, 0),
                        bwd.n.get(torch.ops.aten.bmm.default, 0))
    for key in modes[1:]:
        assert torch.equal(out[key][0], out["none", None][0])
        for g, w in zip(out[key][1], out["none", None][1]):
            assert torch.equal(g, w)
    none_mm, none_bmm = mm["none", None]
    if groups is None:
        assert mm["dots", None] == (none_mm, mm["dots", None][1])
        assert mm["dots", None][1] > none_bmm
        assert mm["full", None][0] > none_mm
    else:
        assert all(mm[key][0] > none_mm for key in modes[1:])


def _adam_trees(rng, n_steps):
    shapes = {"a": (8, 6), "b": [(5,), (3, 4)], "c": {"d": (7,)}}

    def draw(scale):
        return {"a": rng.standard_normal(shapes["a"]) * scale,
                "b": [rng.standard_normal(s) * scale for s in shapes["b"]],
                "c": {"d": rng.standard_normal(shapes["c"]["d"]) * scale}}
    params = draw(1.0)
    return params, [draw(0.5 + i) for i in range(n_steps)]


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32)).to(dtype)


def _to_jax(tree, dtype):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32), dtype), tree)


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state):
    """Three steps on identical gradients, warmup 2 and total_steps 3: the
    schedule at step 1, at the end of warmup and at total_steps; the first
    step's grads are clipped (norm above 1), the last not."""
    rng = np.random.default_rng(0)
    params, grads = _adam_trees(rng, 3)
    grads[2] = jax.tree_util.tree_map(lambda g: g * 0.01, grads[2])
    t_dt, j_dt = ((torch.float32, jnp.float32) if state == "float32"
                  else (torch.bfloat16, jnp.bfloat16))
    j_opt = JAdamW(lr=1e-2, warmup=2, total_steps=3, state_dtype=j_dt)
    opt = AdamW(lr=1e-2, warmup=2, total_steps=3, state_dtype=t_dt)
    jp = _to_jax(params, jnp.float32)
    js = j_opt.init(jp)
    p = _to_torch(params, torch.float32)
    s = opt.init(p)
    update = jax.jit(j_opt.update)
    for g in grads:
        jp, js, jn = update(_to_jax(g, jnp.float32), js, jp)
        p, s, n = opt.update(_to_torch(g, torch.float32), s, p)
        np.testing.assert_allclose(n.item(), float(jn), **ADAM_TOL)
        assert int(s.step) == int(js.step)
        for got, want in ((p, jp), (s.mu, js.mu), (s.nu, js.nu)):
            _assert_tree(got, want)
    for m in tree_leaves(s.mu) + tree_leaves(s.nu):
        assert m.dtype == t_dt


def _assert_tree(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree(got[k], want[k])
    elif isinstance(want, list):
        for a, b in zip(got, want):
            _assert_tree(a, b)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **ADAM_TOL)


def test_schedule_matches_reference():
    j_opt = JAdamW(lr=3e-4, warmup=3, total_steps=10, min_lr_frac=0.1)
    opt = AdamW(lr=3e-4, warmup=3, total_steps=10, min_lr_frac=0.1)
    for s in range(13):
        want = float(j_opt.schedule(jnp.int32(s)))
        got = opt.schedule(torch.tensor(s, dtype=torch.int32)).item()
        assert got == want, (s, got, want)


@pytest.mark.parametrize("n_mb", [1, 2])
def test_local_step_matches_reference(n_mb):
    """Three steps of the train step on reduced float32 llama3.2-3b from
    the same params and pipeline batches: losses and grad norms each step,
    and the new parameters after the first."""
    cfg, j_model, tree = _j_init("llama3.2-3b")
    j_opt = JAdamW(lr=1e-3, warmup=2, total_steps=3)
    opt = AdamW(lr=1e-3, warmup=2, total_steps=3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = j_opt.init(jp)
    p = params_from_numpy(tree, cfg, device="cpu")
    s = opt.init(p)
    j_step = jax.jit(j_local_step(j_model, j_opt, n_mb))
    step = _local_step(build_model(cfg), opt, n_mb)
    for i in range(3):
        j_b = j_synth_batch(j_model.cfg, i, 4, S)
        b = synth_batch(cfg, i, 4, S)
        j_b = {k: jnp.asarray(v) for k, v in j_b.items()}
        if i == 0:
            g_ref = jax.grad(j_model.loss)(jp, j_b)
            lr = float(j_opt.schedule(jnp.int32(1)))
        jp, js, jm = j_step(jp, js, j_b)
        p, s, m = step(p, s, batch_to_device(b, "cpu"))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm["grad_norm"]), **LOSS_TOL)
        if i == 0:
            want = tree_leaves(params_from_numpy(_np_tree(jp), cfg,
                                                 device="cpu"))
            gs = tree_leaves(params_from_numpy(_np_tree(g_ref), cfg,
                                               device="cpu"))
            for a, w, g in zip(tree_leaves(p), want, gs):
                d = (a.detach() - w).abs()
                well = g.abs() >= 1e-6
                assert float(torch.where(well, d, 0).max()) <= 1e-6
                assert float(d.max()) <= 2 * lr
