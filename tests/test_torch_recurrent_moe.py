"""Port parity, recurrent and MoE layers: the cases of
``tests/test_recurrent.py`` and ``tests/test_moe.py`` run against
``repro_torch.models`` on the CPU, each once within the port (chunkwise
against its sequential oracle, as the reference tests do) and once against
the JAX package on the same parameters (the reference's own initialised
ones, carried across as float32 numpy) and the same numpy inputs.

The sharded sLSTM with its custom backward (``slstm_forward_sharded``,
``test_slstm_local_grad_matches_plain``) and ``moe_forward`` over a mesh
run on 4 ranks in ``tests/test_torch_dist.py``.

Tolerances: the reference tests' own between a chunkwise form and its
oracle; ``atol = rtol = 1e-4`` port against reference in float32 (the same
formulas, another summation order); bf16 ``moe_ref`` within 0.03 (a bf16
ulp at 1 is 0.0078).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models import xlstm as j_xlstm
from repro_torch.configs.base import MoEConfig, SSMConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod

TOL32 = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(x, np.float32)


def _torch(tree, dtype=torch.float32, keep_f32=()):
    """A reference parameter dict as torch tensors; ``keep_f32`` leaves
    stay float32."""
    return {k: torch.tensor(_np(v)).to(torch.float32 if k in keep_f32
                                       else dtype)
            for k, v in tree.items()}


def _x(rng, shape):
    return rng.standard_normal(shape) * 0.5


# ---------------------------------------------------------------------------
# mLSTM / sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk", [(16, 4), (17, 8), (32, 32), (7, 16)])
def test_mlstm_chunkwise_matches_sequential(T, chunk):
    rng = np.random.default_rng(T)
    B, D, H = 2, 32, 4
    j_params = j_xlstm.init_mlstm(jax.random.PRNGKey(0), D, H, jnp.float32)
    params = _torch(j_params)
    x = _x(rng, (B, T, D))
    out_c = xlstm_mod.mlstm_forward(params, torch.tensor(x).float(),
                                    n_heads=H, chunk=chunk)
    out_s = xlstm_mod.mlstm_ref(params, torch.tensor(x).float(), n_heads=H)
    np.testing.assert_allclose(_np(out_c), _np(out_s), rtol=2e-4, atol=2e-4)
    want = jax.jit(j_xlstm.mlstm_forward, static_argnames=(
        "n_heads", "chunk"))(j_params, jnp.asarray(x, jnp.float32),
                             n_heads=H, chunk=chunk)
    np.testing.assert_allclose(_np(out_c), _np(want), **TOL32)
    want_s = jax.jit(j_xlstm.mlstm_ref, static_argnames=("n_heads",))(
        j_params, jnp.asarray(x, jnp.float32), n_heads=H)
    np.testing.assert_allclose(_np(out_s), _np(want_s), **TOL32)


def test_mlstm_stabiliser_starts_at_minus_1e30():
    """The padded chunk and the -1e30 initial stabiliser stay finite."""
    st = xlstm_mod.mlstm_init_state(1, 2, 4)
    assert float(st.m.max()) == float(np.float32(-1e30))
    params = _torch(j_xlstm.init_mlstm(jax.random.PRNGKey(1), 8, 2,
                                       jnp.float32))
    out = xlstm_mod.mlstm_forward(params, torch.zeros(1, 5, 8), n_heads=2,
                                  chunk=4)
    assert bool(torch.isfinite(out).all())


def test_slstm_forward_matches_steps():
    rng = np.random.default_rng(1)
    B, T, D, H = 2, 9, 16, 2
    j_params = j_xlstm.init_slstm(jax.random.PRNGKey(1), D, H, jnp.float32)
    params = _torch(j_params)
    x = _x(rng, (B, T, D))
    xt = torch.tensor(x).float()
    full = xlstm_mod.slstm_forward(params, xt, n_heads=H)
    st = xlstm_mod.slstm_init_state(B, H, D // H)
    outs = []
    for t in range(T):
        y, st = xlstm_mod.slstm_step(params, xt[:, t:t + 1], st, n_heads=H)
        outs.append(y)
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, dim=1)),
                               rtol=1e-5, atol=1e-5)
    want = j_xlstm.slstm_forward(j_params, jnp.asarray(x, jnp.float32),
                                 n_heads=H)
    np.testing.assert_allclose(_np(full), _np(want), **TOL32)
    # the final state, every field, against the reference's steps
    j_st = j_xlstm.slstm_init_state(B, H, D // H)
    for t in range(T):
        _, j_st = j_xlstm.slstm_step(j_params, jnp.asarray(x[:, t:t + 1],
                                                           jnp.float32),
                                     j_st, n_heads=H)
    for got, want in zip(st, j_st):
        np.testing.assert_allclose(_np(got), _np(want), **TOL32)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def _mamba(seed, D, chunk, **kw):
    j_cfg = JSSMConfig(state_dim=kw.get("state_dim", 8), d_inner_mult=2,
                       conv_width=4, chunk=chunk)
    cfg = SSMConfig(state_dim=j_cfg.state_dim, d_inner_mult=2, conv_width=4,
                    chunk=chunk)
    j_params = j_ssm.init_mamba(jax.random.PRNGKey(seed), D, j_cfg,
                                jnp.float32)
    return j_cfg, cfg, j_params, _torch(j_params)


@pytest.mark.parametrize("T,chunk", [(12, 4), (16, 16), (9, 8)])
def test_mamba_chunked_matches_stepwise(T, chunk):
    rng = np.random.default_rng(T + 100)
    B, D = 2, 16
    j_cfg, cfg, j_params, params = _mamba(2, D, chunk)
    x = _x(rng, (B, T, D))
    full = ssm_mod.mamba_forward(params, torch.tensor(x).float(), cfg=cfg)
    step = ssm_mod.mamba_ref(params, torch.tensor(x).float(), cfg=cfg)
    np.testing.assert_allclose(_np(full), _np(step), rtol=2e-4, atol=2e-4)
    want = j_ssm.mamba_forward(j_params, jnp.asarray(x, jnp.float32),
                               cfg=j_cfg)
    np.testing.assert_allclose(_np(full), _np(want), **TOL32)
    want = j_ssm.mamba_ref(j_params, jnp.asarray(x, jnp.float32), cfg=j_cfg)
    np.testing.assert_allclose(_np(step), _np(want), **TOL32)


@pytest.mark.parametrize("T,chunk", [(12, 4), (16, 16), (9, 8)])
def test_mamba_chunk_local_matches_baseline(T, chunk):
    rng = np.random.default_rng(T + 200)
    B, D = 2, 16
    j_cfg, cfg, j_params, params = _mamba(4, D, chunk)
    cfg_cl = dataclasses.replace(cfg, chunk_local=True)
    x = _x(rng, (B, T, D))
    base = ssm_mod.mamba_forward(params, torch.tensor(x).float(), cfg=cfg)
    cl = ssm_mod.mamba_forward(params, torch.tensor(x).float(), cfg=cfg_cl)
    np.testing.assert_allclose(_np(cl), _np(base), rtol=2e-5, atol=2e-5)
    want = j_ssm.mamba_forward(j_params, jnp.asarray(x, jnp.float32),
                               cfg=dataclasses.replace(j_cfg,
                                                       chunk_local=True))
    np.testing.assert_allclose(_np(cl), _np(want), **TOL32)


def test_ssm_inputs_add_the_mean_dt_bias():
    """The step size adds the mean of dt_bias, a scalar (the reference's
    behaviour), not the per-channel bias."""
    _, _, j_params, params = _mamba(5, 8, 4)
    params["dt_bias"] = torch.linspace(-1.0, 2.0, params["dt_bias"].numel())
    j_params = dict(j_params, dt_bias=jnp.asarray(_np(params["dt_bias"])))
    u = np.random.default_rng(5).standard_normal((1, 3, 16))
    got = ssm_mod._ssm_inputs(params, torch.tensor(u).float())
    want = j_ssm._ssm_inputs(j_params, jnp.asarray(u, jnp.float32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL32)


def test_mamba_prefill_state_matches_stepped_state():
    rng = np.random.default_rng(7)
    B, T, D = 1, 11, 8
    j_cfg, cfg, j_params, params = _mamba(3, D, 4, state_dim=4)
    x = _x(rng, (B, T, D))
    xt = torch.tensor(x).float()
    st_pre = ssm_mod.mamba_prefill_state(params, xt, cfg=cfg)
    st = ssm_mod.mamba_init_state(params, B)
    for t in range(T):
        _, st = ssm_mod.mamba_step(params, xt[:, t:t + 1], st, cfg=cfg)
    np.testing.assert_allclose(_np(st_pre.h), _np(st.h), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(_np(st_pre.conv), _np(st.conv), rtol=2e-4,
                               atol=2e-4)
    want = j_ssm.mamba_prefill_state(j_params, jnp.asarray(x, jnp.float32),
                                     cfg=j_cfg)
    np.testing.assert_allclose(_np(st_pre.h), _np(want.h), **TOL32)
    np.testing.assert_allclose(_np(st_pre.conv), _np(want.conv), **TOL32)


def test_mamba_prefill_state_of_a_short_prompt():
    """T < W - 1: the conv tail is left-padded with zeros."""
    j_cfg, cfg, j_params, params = _mamba(6, 8, 4, state_dim=4)
    x = _x(np.random.default_rng(8), (2, 2, 8))
    got = ssm_mod.mamba_prefill_state(params, torch.tensor(x).float(),
                                      cfg=cfg)
    want = j_ssm.mamba_prefill_state(j_params, jnp.asarray(x, jnp.float32),
                                     cfg=j_cfg)
    assert tuple(got.conv.shape) == (2, 3, 16)
    np.testing.assert_allclose(_np(got.conv), _np(want.conv), **TOL32)
    np.testing.assert_allclose(_np(got.h), _np(want.h), **TOL32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _j_moe_forward(j_params, x, j_cfg, act):
    """The reference's shard_map path on a (1, 1) mesh, compiled once."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    fn = jax.jit(lambda p, x: j_moe.moe_forward(
        p, x, cfg=j_cfg, act=act, mesh=mesh, batch_axes=("data",)))
    return fn(j_params, jnp.asarray(x, jnp.float32))


def _moe(seed, D, act, **kw):
    j_cfg = JMoEConfig(**kw)
    cfg = MoEConfig(**kw)
    j_params = j_moe.init_moe(jax.random.PRNGKey(seed), D, j_cfg, act,
                              jnp.float32)
    return j_cfg, cfg, j_params, _torch(j_params)


@pytest.mark.parametrize("mode", ["ep", "tp"])
def test_moe_forward_matches_ref(mode):
    j_cfg, cfg, j_params, params = _moe(
        0, 8, "swiglu", num_experts=4, top_k=2, d_ff_expert=16,
        capacity_factor=4.0, parallel_mode=mode)
    x = np.random.default_rng(0).standard_normal((2, 6, 8))
    xt = torch.tensor(x).float()
    out = moe_mod.moe_forward(params, xt, cfg=cfg, act="swiglu")
    ref = moe_mod.moe_ref(params, xt, cfg=cfg, act="swiglu")
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)
    want = _j_moe_forward(j_params, x, j_cfg, "swiglu")
    np.testing.assert_allclose(_np(out), _np(want), **TOL32)
    want = j_moe.moe_ref(j_params, jnp.asarray(x, jnp.float32), cfg=j_cfg,
                         act="swiglu")
    np.testing.assert_allclose(_np(ref), _np(want), **TOL32)


def test_moe_capacity_drops_tokens_gracefully():
    """Tight capacity: the rows the port drops (zero outputs) are the rows
    the reference drops on the (1, 1) mesh, and the rest agree."""
    j_cfg, cfg, j_params, params = _moe(
        1, 4, "gelu", num_experts=2, top_k=1, d_ff_expert=8,
        capacity_factor=0.26, parallel_mode="ep")
    x = np.random.default_rng(1).standard_normal((1, 32, 4))
    out = moe_mod.moe_forward(params, torch.tensor(x).float(), cfg=cfg,
                              act="gelu")
    assert bool(torch.isfinite(out).all())
    norms = out.reshape(-1, 4).norm(dim=-1)
    assert float((norms == 0).float().mean()) > 0.1
    want = _j_moe_forward(j_params, x, j_cfg, "gelu")
    j_norms = np.linalg.norm(_np(want).reshape(-1, 4), axis=-1)
    np.testing.assert_array_equal(_np(norms) == 0, j_norms == 0)
    np.testing.assert_allclose(_np(out), _np(want), **TOL32)


def test_capacity_formula():
    assert moe_mod.capacity_for(65536, 128, 8, 1.25) == 640
    assert moe_mod.capacity_for(8, 128, 8, 1.25) >= 1
    for t in (1, 7, 8, 9, 100, 4096):
        for e, k, f in ((128, 8, 1.25), (8, 2, 1.25), (4, 2, 2.0),
                        (2, 1, 0.26)):
            assert moe_mod.capacity_for(t, e, k, f) == \
                j_moe.capacity_for(t, e, k, f)


def test_top_k_ties_go_to_the_lower_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0]])
    v, i = moe_mod._top_k(logits, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_moe_ref_bf16_accumulates_like_the_reference():
    """bf16 activations and experts: accumulation in x's dtype, in expert
    order."""
    j_cfg, cfg, j_params, _ = _moe(2, 16, "swiglu", num_experts=8, top_k=2,
                                   d_ff_expert=32)
    j_bf = {k: v if k == "router" else v.astype(jnp.bfloat16)
            for k, v in j_params.items()}
    params = _torch(j_bf, torch.bfloat16, keep_f32=("router",))
    x = np.random.default_rng(3).standard_normal((2, 5, 16))
    got = moe_mod.moe_ref(params, torch.tensor(x).to(torch.bfloat16),
                          cfg=cfg, act="swiglu")
    want = j_moe.moe_ref(j_bf, jnp.asarray(x, jnp.bfloat16), cfg=j_cfg,
                         act="swiglu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=0.03, rtol=0)
