"""Port parity, route-scorer model: the port's llama3.2-3b family
(``repro_torch.models``) against the JAX package's on the CPU, on the JAX
package's own initialised parameters carried across by
``convert.params_from_numpy``, on the reduced config (4 layers, d_model 64).

Tolerances: float32 ``atol = rtol = 1e-4``. bfloat16 logits: both frameworks
round each product and norm to bf16, but not at the same places, so they are
held to ``atol = 0.05`` against logits of about unit scale (a bf16 ulp at 1
is 0.0078) and greedy tokens only where the top-2 gap exceeds that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import ffn as j_ffn
from repro.models.registry import build_model as j_build_model
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import ffn
from repro_torch.models.registry import build_model

ARCH = "llama3.2-3b"
TOL32 = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 0.05


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(x, np.float32)


def _jax_tree_np(params):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(cfg, JAX model, JAX params, port model, port params) on the same
    weights, in the working type of the param."""
    cfg = get_config(ARCH).reduced()
    j_cfg = j_get_config(ARCH).reduced()
    if request.param == "float32":
        cfg, j_cfg = _f32(cfg), _f32(j_cfg)
    j_model = j_build_model(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = params_from_numpy(_jax_tree_np(j_params), cfg, device="cpu")
    return cfg, j_model, j_params, model, params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def _assert_close(got, want, cfg):
    if cfg.dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL32)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL,
                                   rtol=0)


def test_config_is_the_reference_config():
    for port, ref in ((get_config(ARCH), j_get_config(ARCH)),
                      (get_config(ARCH).reduced(),
                       j_get_config(ARCH).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
    assert get_config(ARCH).n_params() == 3_212_746_752


def test_unported_arch_names_the_roadmap():
    """Every assigned arch is ported; an unknown id is refused with the
    list of those the port carries."""
    assert get_config("gemma3-1b").arch == "gemma3-1b"
    with pytest.raises(ValueError, match="llama3.2-3b"):
        get_config("llama-9")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32) * 0.1
    want = j_common.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    got = common.rms_norm(torch.tensor(x).to(getattr(torch, dtype)),
                          torch.tensor(w).to(getattr(torch, dtype)))
    tol = TOL32 if dtype == "float32" else dict(atol=0.02, rtol=0.01)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("offset", [0, 200])
def test_apply_rope(offset):
    rng = np.random.default_rng(1)
    B, S, K, G, d = 2, 7, 2, 3, 16
    x = rng.standard_normal((B, S, K, G, d)).astype(np.float32)
    pos = np.arange(S) + offset
    for theta in (10_000.0, 500_000.0):
        want = j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = common.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
        np.testing.assert_allclose(_np(got), _np(want), **TOL32)
        # the (B, S, K, d) kv layout
        want = j_common.apply_rope(jnp.asarray(x[:, :, :, 0]),
                                   jnp.asarray(pos), theta)
        got = common.apply_rope(torch.tensor(x[:, :, :, 0]),
                                torch.tensor(pos), theta)
        np.testing.assert_allclose(_np(got), _np(want), **TOL32)


def test_ffn_forward(pair):
    cfg, _, j_params, _, params = pair
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model))
    j_p = jax.tree_util.tree_map(lambda a: a[1], j_params["blocks"][0]["ffn"])
    want = j_ffn.ffn_forward(j_p, jnp.asarray(x, cfg.dtype), cfg.act)
    got = ffn.ffn_forward(params["blocks"][0][1]["ffn"],
                          torch.tensor(x).to(common.dtype_of(cfg.dtype)),
                          cfg.act)
    _assert_close(got, want, cfg)


@pytest.mark.parametrize("causal,window,block", [
    (True, 0, 8), (True, 7, 8), (True, 16, 8), (False, 0, 8), (True, 0, 512),
    (True, 5, 512)])
def test_blockwise_attention(causal, window, block):
    rng = np.random.default_rng(3 + window)
    B, S, K, G, d = 2, 33, 2, 3, 8
    q = rng.standard_normal((B, S, K, G, d)).astype(np.float32)
    k = rng.standard_normal((B, S, K, d)).astype(np.float32)
    v = rng.standard_normal((B, S, K, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, block_q=block, block_kv=block)
    want = j_attn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    got = attn.blockwise_attention(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL32)
    if causal:
        # the last row is what one decode step at the same position sees
        dec = attn.attention_scores_decode(
            torch.tensor(q[:, -1:]), torch.tensor(k), torch.tensor(v),
            pos=S, window=window)
        np.testing.assert_allclose(_np(dec), _np(got[:, -1:]), **TOL32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_scores_decode(dtype, window):
    rng = np.random.default_rng(5)
    B, S, K, G, d = 2, 17, 2, 2, 8
    q = rng.standard_normal((B, 1, K, G, d)).astype(np.float32)
    k = rng.standard_normal((B, S, K, d)).astype(np.float32)
    v = rng.standard_normal((B, S, K, d)).astype(np.float32)
    for pos in (1, 9, S):
        want = j_attn.attention_scores_decode(
            jnp.asarray(q, dtype), jnp.asarray(k, dtype),
            jnp.asarray(v, dtype), pos=pos, window=window)
        tdt = getattr(torch, dtype)
        got = attn.attention_scores_decode(
            torch.tensor(q).to(tdt), torch.tensor(k).to(tdt),
            torch.tensor(v).to(tdt), pos=pos, window=window)
        tol = TOL32 if dtype == "float32" else dict(atol=0.02, rtol=0.01)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_logits_fn(pair):
    cfg, j_model, j_params, model, params = pair
    toks = _tokens(cfg, 2, 12, seed=1)
    want = j_model.logits(j_params, {"tokens": jnp.asarray(toks)})
    got = model.logits(params, {"tokens": torch.tensor(toks).long()})
    assert got.shape == (2, 12, cfg.vocab)
    _assert_close(got, want, cfg)
    if cfg.dtype == "bfloat16":
        _assert_tokens_where_clear(got, want)


def _assert_tokens_where_clear(got, want):
    """Equal argmax wherever the reference's top-2 gap exceeds the bf16
    tolerance."""
    w = _np(want).reshape(-1, _np(want).shape[-1])
    g = _np(got).reshape(w.shape)
    top2 = np.sort(w, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * BF16_ATOL
    assert clear.any()
    np.testing.assert_array_equal(g.argmax(-1)[clear], w.argmax(-1)[clear])


def test_prefill(pair):
    cfg, j_model, j_params, model, params = pair
    toks = _tokens(cfg, 2, 10, seed=2)
    j_logits, j_caches = j_model.prefill(j_params,
                                         {"tokens": jnp.asarray(toks)})
    logits, caches = model.prefill(params, {"tokens": torch.tensor(toks).long()})
    assert logits.shape == (2, 1, cfg.vocab)
    _assert_close(logits, j_logits, cfg)
    assert len(caches) == len(j_caches) == 1
    for name in ("k", "v"):
        assert caches[0][name].shape == j_caches[0][name].shape
        _assert_close(caches[0][name], j_caches[0][name], cfg)


def test_decode_steps(pair):
    """6 decode steps from an empty cache: logits per step and the cache."""
    cfg, j_model, j_params, model, params = pair
    B, S, steps = 2, 10, 6
    toks = _tokens(cfg, B, steps, seed=3)
    j_cache = j_model.init_cache(B, S)
    cache = model.init_cache(B, S, device="cpu")
    assert [{k: (tuple(t.shape), t.dtype) for k, t in run.items()}
            for run in model.cache_struct(B, S)["runs"]] == \
        [{k: (tuple(t.shape), t.dtype) for k, t in run.items()}
         for run in cache["runs"]]
    for t in range(steps):
        j_lg, j_cache = j_model.decode_step(j_params, j_cache,
                                            jnp.asarray(toks[:, t:t + 1]),
                                            jnp.int32(t))
        lg, cache = model.decode_step(params, cache,
                                      torch.tensor(toks[:, t:t + 1]).long(),
                                      t)
        _assert_close(lg, j_lg, cfg)
    for name in ("k", "v"):
        _assert_close(cache["runs"][0][name], j_cache["runs"][0][name], cfg)


def test_decode_matches_prefill_and_logits(pair):
    """Within the port: prefill's last-token logits and the full logits
    agree with token-by-token decode (the reference smoke test's check)."""
    cfg, _, _, model, params = pair
    B, S = 2, 12
    toks = torch.tensor(_tokens(cfg, B, S, seed=4)).long()
    full = model.logits(params, {"tokens": toks})
    last, _ = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    tol = TOL32 if cfg.dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(dec), _np(full), **tol)
    np.testing.assert_allclose(_np(last), _np(full[:, -1:]), **tol)


def test_params_from_numpy_layout(pair):
    cfg, _, j_params, _, params = pair
    assert len(params["blocks"]) == 1 and \
        len(params["blocks"][0]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        np.testing.assert_array_equal(
            _np(params["blocks"][0][i]["attn"]["wq"]),
            np.asarray(j_params["blocks"][0]["attn"]["wq"][i], np.float32))
    assert params["embed"].dtype == common.dtype_of(cfg.param_dtype)
    # the reference's analytic count leaves out the final norm
    n = sum(t.numel() for t in _leaves(params))
    assert n == cfg.n_params() + cfg.d_model


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_port_init_shapes_and_dtypes():
    cfg = get_config(ARCH).reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    assert sum(t.numel() for t in _leaves(params)) == \
        cfg.n_params() + cfg.d_model
    assert all(t.dtype == torch.bfloat16 for t in _leaves(params))
    assert not bool(params["norm_f"]["w"].any())   # rms w is an offset from 1
    again = build_model(cfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(params),
                                                 _leaves(again)))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        params_from_numpy({}, cfg)
