"""The port's train loop (``repro_torch.train.loop.fit`` on the CPU): the
cases of tests/test_train_loop.py, the injected-failure restart of
tests/test_ft.py, and the train half of
test_models_smoke.py::test_smoke_forward_and_train_step for every arch,
each against the port with the reference's sizes and bounds. Plus what the
port adds: resumed state equal to the saved state bit for bit, and the
entry points that raise (no card, a sharding context).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ASSIGNED_ARCHS, get_config
from repro_torch.ft.failures import FailureInjector
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.train import grad_compress
from repro_torch.train.loop import TrainConfig, fit
from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

CPU = dict(log=lambda s: None, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tensors are small: one intra-op thread runs them faster than
    many, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_decreases():
    cfg = get_config("gemma3-1b").reduced()
    tc = TrainConfig(steps=25, batch=4, seq_len=32, lr=3e-3, warmup=5,
                     log_every=100)
    res = fit(cfg, tc, **CPU)
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_resume_matches_uninterrupted(tmp_path):
    cfg = get_config("llama3.2-3b").reduced()
    common = dict(batch=4, seq_len=16, lr=1e-3, warmup=2, log_every=100,
                  schedule_steps=10)  # identical LR schedule on both legs
    # uninterrupted 10 steps
    res_a = fit(cfg, TrainConfig(steps=10, **common), **CPU)
    # 5 steps + resume for 5 more
    d = str(tmp_path / "ck")
    fit(cfg, TrainConfig(steps=5, ckpt_dir=d, ckpt_every=100, **common),
        **CPU)
    res_b = fit(cfg, TrainConfig(steps=10, ckpt_dir=d, ckpt_every=100,
                                 **common), **CPU)
    np.testing.assert_allclose(res_a.losses[5:], res_b.losses, rtol=1e-4)


def test_resume_restores_saved_state_bit_for_bit(tmp_path):
    """The checkpoint fit writes at its last step restores to tensors equal
    to its final parameters and optimizer state, dtypes included."""
    cfg = get_config("llama3.2-3b").reduced()
    d = str(tmp_path / "ck")
    res = fit(cfg, TrainConfig(steps=3, batch=2, seq_len=16, ckpt_dir=d,
                               ckpt_every=100, log_every=100), **CPU)
    tree = {"params": res.params, "opt": res.opt_state}
    restored = store.restore(d, 3, tree)
    got, want = tree_leaves(restored), tree_leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b.detach())
    assert int(restored["opt"].step) == 3


def test_microbatch_equivalence():
    """M=1 vs M=4 gradient accumulation gives (near-)identical losses."""
    cfg = get_config("gemma3-1b").reduced()
    common = dict(steps=4, batch=8, seq_len=16, lr=1e-3, warmup=1,
                  log_every=100)
    r1 = fit(cfg, TrainConfig(microbatches=1, **common), **CPU)
    r4 = fit(cfg, TrainConfig(microbatches=4, **common), **CPU)
    # first-step loss: identical data, different averaging order
    assert abs(r1.losses[0] - r4.losses[0]) < 5e-2
    assert abs(r1.losses[-1] - r4.losses[-1]) < 1e-1


def test_grad_compress_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.tensor(rng.standard_normal((64, 64)),
                           dtype=torch.float32)}
    st = grad_compress.init(g)
    q, s, st2 = grad_compress.compress(g, st)
    back = grad_compress.decompress(q, s)
    # quantisation error bounded by scale/2 per element
    err = (back["w"] - g["w"]).abs()
    assert float(err.max()) <= float(s["w"]) * 0.51
    # error feedback: residual equals the quantisation error
    np.testing.assert_allclose(st2.residual["w"].numpy(),
                               (g["w"] - back["w"]).numpy(), atol=1e-6)
    # second round with zero grads flushes the residual
    q2, s2, _ = grad_compress.compress(
        {"w": torch.zeros_like(g["w"])}, st2)
    back2 = grad_compress.decompress(q2, s2)
    assert float((back2["w"] - st2.residual["w"]).abs().max()) \
        < float(s2["w"])


def test_grad_compress_int8_payload():
    g = {"w": torch.ones((8, 8), dtype=torch.float32)}
    q, s, _ = grad_compress.compress(g, grad_compress.init(g))
    assert q["w"].dtype == torch.int8


def test_optimizer_state_dtype():
    opt = AdamW(state_dtype=torch.bfloat16)
    p = {"w": torch.ones((4, 4), dtype=torch.float32)}
    st = opt.init(p)
    assert st.mu["w"].dtype == torch.bfloat16


def test_injected_failure_restart(tmp_path):
    cfg = get_config("llama3.2-3b").reduced()
    tc = TrainConfig(steps=8, batch=4, seq_len=16, ckpt_dir=str(tmp_path),
                     ckpt_every=3, log_every=100, lr=1e-3)
    inj = FailureInjector(schedule={5: "host3"})
    res = fit(cfg, tc, injector=inj, **CPU)
    assert res.restarts == 1
    assert res.steps_done == 8
    assert all(np.isfinite(res.losses))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_smoke_train_step(arch):
    """The train half of the reference's smoke test: one loss, its grads
    and an AdamW update on the reduced config (bf16 as the config says),
    all finite, and the loss again after the update."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = make_inputs(cfg, 2, 32, np.random.default_rng(0), device="cpu")
    opt = AdamW(lr=1e-3, warmup=1, total_steps=10)
    ostate = opt.init(params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert bool(torch.isfinite(loss))
    flat = iter([g.float() for g in grads])
    g32 = tree_map(lambda _: next(flat), params)
    new_p, new_s, gnorm = opt.update(g32, ostate, params)
    assert bool(torch.isfinite(gnorm))
    assert int(new_s.step) == 1
    with torch.no_grad():
        loss2 = model.loss(new_p, batch)
    assert bool(torch.isfinite(loss2))
    assert all(p.dtype == q.dtype for p, q in
               zip(tree_leaves(new_p), tree_leaves(
                   model.init(torch.Generator().manual_seed(0),
                              device="cpu"))))


def test_fit_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: fit(device='cuda') would train")
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fit(cfg, TrainConfig(steps=1), log=lambda s: None)


def test_fit_with_ctx_names_the_roadmap(tmp_path):
    """``fit(ctx=...)`` through ``build_train_step`` on a one-rank (1, 1)
    CPU mesh: the parameters become DTensors, and the losses and grad
    norms equal ``fit`` without a context (float32, 1e-5; 4 ranks:
    ``tests/test_torch_dist.py``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import make_ctx
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              dtype="float32", param_dtype="float32",
                              n_layers=2)
    tc = TrainConfig(steps=2, batch=2, seq_len=16, microbatches=2)
    plain = fit(cfg, tc, **CPU)
    init_distributed("cpu", init_method=f"file://{tmp_path}/store")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        res = fit(cfg, tc, ctx=make_ctx(mesh, None, cfg), **CPU)
        assert all(isinstance(p, DTensor) for p in tree_leaves(res.params))
        np.testing.assert_allclose(res.losses, plain.losses, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res.grad_norms, plain.grad_norms,
                                   rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_fit_float32_and_bf16_state_configs():
    """optimizer_dtype picks the moments' dtype; float32 params train
    with float32 moments."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              optimizer_dtype="bfloat16")
    res = fit(cfg, TrainConfig(steps=2, batch=2, seq_len=16), **CPU)
    assert all(m.dtype == torch.bfloat16
               for m in tree_leaves(res.opt_state.mu))
    cfg32 = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                                dtype="float32", param_dtype="float32")
    res32 = fit(cfg32, TrainConfig(steps=2, batch=2, seq_len=16), **CPU)
    assert all(p.dtype == torch.float32 for p in tree_leaves(res32.params))
    assert len(res32.grad_norms) == 2 and all(np.isfinite(res32.grad_norms))
