"""Port parity, every model family: each arch of ``ASSIGNED_ARCHS`` at its
``reduced()`` size in float32, the port (``repro_torch.models``) against the
JAX package on the CPU, on the JAX package's own initialised parameters
carried across by ``convert.params_from_numpy``: full logits, prefill logits
and caches, and a 12-token decode sequence for every decoder family.

The VLM's cross-attention gate is initialised to zero, which would hide a
wrong cross attention, so it is set to 0.5 in the numpy tree before both
runs; the decode runs fill the vision keys and values of both caches with
the same projections of the vision embeddings.

Tolerance: float32, ``atol = rtol = 1e-4``.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ASSIGNED_ARCHS as J_ARCHS
from repro.configs.base import get_config as j_get_config
from repro.models.registry import build_model as j_build_model
from repro.models.registry import make_inputs as j_make_inputs
from repro_torch.configs.base import ASSIGNED_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.registry import build_model, make_inputs
from repro_torch.serve import LMServer

TOL32 = dict(atol=1e-4, rtol=1e-4)
DECODERS = [a for a in ASSIGNED_ARCHS if not get_config(a).encoder_only]
NOMINAL = {
    "grok-1-314b": 314e9, "qwen3-moe-235b-a22b": 235e9,
    "xlstm-1.3b": 1.3e9, "llama-3.2-vision-11b": 11e9,
    "hubert-xlarge": 1.0e9, "llama3.2-3b": 3.2e9,
    "internlm2-20b": 20e9, "gemma3-1b": 1.0e9,
    "nemotron-4-340b": 340e9, "hymba-1.5b": 1.5e9,
}


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(x, np.float32)


def _jax_batch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ASSIGNED_ARCHS)
def pair(request):
    """(cfg, JAX model, JAX params, port model, port params) on the same
    float32 weights."""
    arch = request.param
    j_cfg = _f32(j_get_config(arch).reduced())
    cfg = _f32(get_config(arch).reduced())
    j_model = j_build_model(j_cfg)
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jax.jit(j_model.init)(
                                      jax.random.PRNGKey(0)))
    if "cross" in tree:
        tree["cross"]["gate"][:] = 0.5
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = build_model(cfg)
    return cfg, j_model, j_params, model, params_from_numpy(tree, cfg,
                                                            device="cpu")


def _assert_tree_close(got, want):
    """Port cache (dicts and lists of tensors) against the reference's."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w)
    else:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **TOL32)


ROOT = Path(__file__).resolve().parents[1]


def _imported_roots(path: Path):
    """The top-level package of every import statement in a file, nested
    imports included."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "benchmarks").glob("torch_*.py")) \
        + sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 60
    assert ROOT / "benchmarks" / "torch_run.py" in files
    assert ROOT / "examples" / "torch_quickstart.py" in files
    bad = {str(f.relative_to(ROOT)): r for f in files
           for r in _imported_roots(f) if r in ("jax", "jaxlib", "repro")}
    assert not bad


def test_archs_are_the_reference_archs():
    assert ASSIGNED_ARCHS == J_ARCHS
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("llama-9")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_config_is_the_reference_config(arch):
    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (get_config(arch).reduced(),
                       j_get_config(arch).reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_full_config_param_counts(arch):
    cfg = get_config(arch)
    n = cfg.n_params()
    nominal = NOMINAL[arch]
    assert 0.7 * nominal <= n <= 1.35 * nominal, \
        f"{arch}: {n/1e9:.1f}B vs nominal {nominal/1e9:.0f}B"
    assert cfg.n_active_params() <= n


def test_moe_active_params():
    cfg = get_config("qwen3-moe-235b-a22b")
    a = cfg.n_active_params()
    assert 15e9 <= a <= 30e9, f"active {a/1e9:.1f}B vs nominal 22B"


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_tree_layout(arch):
    """The port's own init (bf16 reduced) has the shapes and dtypes of the
    reference's tree carried across, leaf by leaf, float32 leaves kept."""
    cfg = get_config(arch).reduced()
    j_tree = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32),
        jax.eval_shape(j_build_model(j_get_config(arch).reduced()).init,
                       jax.random.PRNGKey(0)))
    mine = build_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    carried = params_from_numpy(j_tree, cfg, device="cpu")

    def sig(tree):
        if isinstance(tree, dict):
            return {k: sig(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [sig(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert sig(mine) == sig(carried)
    n = sum(int(np.prod(s)) for s, _ in _leaves(sig(mine)))
    assert n == sum(a.size for a in jax.tree_util.tree_leaves(j_tree))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_logits(pair):
    cfg, j_model, j_params, model, params = pair
    batch = make_inputs(cfg, 2, 12, np.random.default_rng(1), device="cpu")
    j_batch = j_make_inputs(cfg, 2, 12, rng=np.random.default_rng(1))
    for k in batch:
        np.testing.assert_array_equal(_np(batch[k]), _np(j_batch[k]))
    want = j_model.logits(j_params, j_batch)
    with torch.inference_mode():
        got = model.logits(params, batch)
    assert got.shape == (2, 12, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL32)


def test_prefill(pair):
    cfg, j_model, j_params, model, params = pair
    batch = make_inputs(cfg, 2, 10, np.random.default_rng(2), device="cpu")
    j_logits, j_cache = j_model.prefill(j_params, _jax_batch(batch))
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch)
    assert logits.shape == (2, 1, cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(j_logits), **TOL32)
    if j_cache is None:
        assert cache is None
    else:
        _assert_tree_close(cache, j_cache)


def _vision_kv(params, cfg, vis):
    """(xk, xv) of shape (n_seg, B, T, K, hd): each cross block's keys and
    values of the vision embeddings."""
    B, T, _ = vis.shape
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    xk = torch.stack([(vis @ c["attn"]["wk"]).reshape(shape)
                      for c in params["cross"]])
    xv = torch.stack([(vis @ c["attn"]["wv"]).reshape(shape)
                      for c in params["cross"]])
    return xk, xv


def _decode_both(cfg, j_model, j_params, model, params, toks, vis=None):
    B, S = toks.shape
    j_cache = j_model.init_cache(B, S)
    cache = model.init_cache(B, S, device="cpu")
    if vis is not None:
        xk, xv = _vision_kv(params, cfg, vis)
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
        j_cache = dict(j_cache, xk=jnp.asarray(xk.numpy()),
                       xv=jnp.asarray(xv.numpy()))
    j_step = jax.jit(j_model.decode_step)
    outs = []
    for t in range(S):
        j_lg, j_cache = j_step(
            j_params, j_cache, jnp.asarray(toks[:, t:t + 1].numpy()),
            jnp.int32(t))
        with torch.inference_mode():
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_np(lg), _np(j_lg), **TOL32)
        outs.append(lg)
    _assert_tree_close(cache, j_cache)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("pair", DECODERS, indirect=True)
def test_decode_sequence(pair):
    """12 decode steps from an empty cache: the logits of every step and the
    final cache equal the reference's; the decoded logits equal the port's
    full-sequence logits (the reference smoke test's consistency case)."""
    cfg, j_model, j_params, model, params = pair
    batch = make_inputs(cfg, 2, 12, np.random.default_rng(3), device="cpu")
    vis = batch.get("vision_embeds")
    dec = _decode_both(cfg, j_model, j_params, model, params,
                       batch["tokens"], vis)
    with torch.inference_mode():
        full = model.logits(params, batch)
    np.testing.assert_allclose(_np(dec), _np(full), **TOL32)


@pytest.mark.parametrize("pair", DECODERS, indirect=True)
def test_decode_after_prefill_state(pair):
    """Decoding on from a prefilled prompt: the hybrid's Mamba state and
    every family's caches carry over (ssm: stepped state)."""
    cfg, _, _, model, params = pair
    batch = make_inputs(cfg, 1, 9, np.random.default_rng(4), device="cpu")
    toks = batch["tokens"]
    with torch.inference_mode():
        full = model.logits(params, batch)
        last, pre = model.prefill(params, batch)
        np.testing.assert_allclose(_np(last), _np(full[:, -1:]), **TOL32)
        cache = model.init_cache(1, 10, device="cpu")
        if cfg.cross_attn_every:
            cache["xk"][:], cache["xv"][:] = _vision_kv(
                params, cfg, batch["vision_embeds"])
        for t in range(9):
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_np(lg), _np(last), **TOL32)
        if pre is not None and "runs" in cache:
            for run, prun in zip(cache["runs"], pre):
                for k, v in prun.items():
                    got = run[k][:, :, :9] if k in ("k", "v") else run[k]
                    np.testing.assert_allclose(_np(got), _np(v), **TOL32)


def test_lmserver_refuses_encoder_only():
    cfg = _f32(get_config("hubert-xlarge").reduced())
    with pytest.raises(ValueError, match="encoder-only"):
        LMServer(cfg, device="cpu")


@pytest.mark.parametrize("arch", DECODERS)
def test_lmserver_serves_every_decoder_family(arch):
    """The port's server draws its own weights for every decoder arch and
    serves a ragged batch of two."""
    from repro_torch.serve import Request
    cfg = get_config(arch).reduced()
    srv = LMServer(cfg, device="cpu", max_seq=16, seed=0)
    outs = srv.generate_batch([
        Request(rid=0, tokens=np.array([3, 5, 7], np.int32),
                max_new_tokens=3),
        Request(rid=1, tokens=np.array([2, 4], np.int32), max_new_tokens=2)])
    assert [len(o.tokens) for o in outs] == [3, 2]
    assert all(((o.tokens >= 0) & (o.tokens < cfg.vocab)).all()
               for o in outs)
