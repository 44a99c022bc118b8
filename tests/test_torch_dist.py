"""Multi-rank parity of the port's sharded paths (``repro_torch.sharding``,
``repro_torch.launch``): 4 gloo ranks on a (2, 2) ("data", "model") mesh,
against the JAX package's single-device results on the same numpy inputs.

One spawn of 4 ranks (``torch.multiprocessing``, a ``file://`` store under
``tmp_path``, a timeout on the group) runs every case; the ranks run
``tests/torch_dist_worker.py``, which imports only the port. The parent
builds the inputs with the JAX package, computes the reference while the
ranks run, and compares. Each case that
fails on the ranks reports its traceback in its own test.

Tolerances (float32):
- the train step (FSDP over ``data``, TP over ``model``; the reference's
  ``_local_step``): losses and grad norms ``atol = rtol = 1e-5``;
  parameters after 2 steps within 1e-5 wherever both steps' gradients are
  at least 1e-6 in size; below that Adam's normalised update of a gradient
  within rounding of zero is ill-conditioned, and such elements are held
  to the most two steps can move them, ``4 * lr``;
- ``moe_forward`` (ep / tp, weight-stationary off and on) against
  ``moe_ref`` and the reference's ``moe_forward`` on a (1, 1) mesh:
  ``2e-4`` (``test_moe.py``'s);
- ``slstm_forward_sharded``: loss ``1e-5``, grads ``rtol 1e-5, atol 1e-6``
  (``test_recurrent.py``'s), and exactly one all-reduce in its backward;
- qblock / expand attention: ``3e-4`` (``test_attention.py``'s);
- ``allreduce_compressed``: the reference's arithmetic within 1e-6;
- ``restore(shardings=)`` and the mesh serving group: bit for bit.
"""
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import synth_batch as j_synth_batch
from repro.models import attention as j_attn
from repro.models import moe as j_moe
from repro.models import xlstm as j_xlstm
from repro.models.registry import build_model as j_build_model
from repro.train import grad_compress as j_gc
from repro.train.loop import _local_step as j_local_step
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.configs.base import get_config
from torch_dist_worker import (ARCHS, ATTN_CASES, LR, MBS, MOE_CASES, S,
                               batch_rows, small, worker)


# ---------------------------------------------------------------------------
# the parent: inputs, the reference, the comparisons
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _inputs():
    rng = np.random.default_rng(0)
    inp = {"params": {}, "batches": {}, "moe_params": {}}
    for arch in ARCHS:
        jm = j_build_model(small(j_get_config(arch)))
        inp["params"][arch] = _np_tree(jax.jit(jm.init)(
            jax.random.PRNGKey(0)))
        for n_mb in MBS:
            inp["batches"][arch, n_mb] = [
                j_synth_batch(jm.cfg, i, batch_rows(n_mb), S)
                for i in range(2)]
    for mode in ("ep", "tp"):
        cfg = JMoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                         capacity_factor=4.0, parallel_mode=mode)
        inp["moe_params"][mode] = _np_tree(jax.jit(
            lambda k, cfg=cfg: j_moe.init_moe(k, 8, cfg, "swiglu",
                                              jnp.float32))(
                jax.random.PRNGKey(0)))
    inp["moe_x"] = np.random.default_rng(0).standard_normal(
        (2, 6, 8)).astype(np.float32)
    inp["slstm_params"] = _np_tree(jax.jit(
        lambda k: j_xlstm.init_slstm(k, 16, 2, jnp.float32))(
            jax.random.PRNGKey(1)))
    inp["slstm_x"] = (np.random.default_rng(0).standard_normal((2, 9, 16))
                      * 0.5).astype(np.float32)
    for causal, window, S_ in ATTN_CASES:
        r = np.random.default_rng(S_ + window)
        inp["attn", S_, window] = tuple(
            r.standard_normal(shape).astype(np.float32)
            for shape in ((2, S_, 2, 3, 8), (2, S_, 2, 8), (2, S_, 2, 8)))
    inp["attn_w"] = _np_tree(jax.jit(
        lambda k: j_attn.init_attn(k, 16, 6, 2, 8, jnp.float32))(
            jax.random.PRNGKey(2)))
    inp["attn_x"] = rng.standard_normal((2, 24, 16)).astype(np.float32)
    inp["gc"] = [{"a": np.random.default_rng(10 + r).standard_normal(
        (3, 5)).astype(np.float32), "b": np.random.default_rng(20 + r)
        .standard_normal((7,)).astype(np.float32)} for r in range(4)]
    return inp


def _naive(q, k, v, causal, window):
    B, Sq, K, G, d = q.shape
    s = np.einsum("bqkgd,bskd->bkgqs", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(d)
    qpos, kpos = np.arange(Sq)[:, None], np.arange(k.shape[1])[None, :]
    mask = np.ones((Sq, k.shape[1]), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = np.where(mask[None, None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bkgqs,bskd->bqkgd", p, v.astype(np.float64))


def _reference(inp):
    ref = {}
    for arch in ARCHS:
        jm = j_build_model(small(j_get_config(arch)))
        for n_mb in MBS:
            opt = JAdamW(lr=LR, warmup=2, total_steps=3)
            p = jax.tree_util.tree_map(jnp.asarray, inp["params"][arch])
            s = opt.init(p)
            step = jax.jit(j_local_step(jm, opt, n_mb))
            rec = {"loss": [], "gnorm": []}
            for b in inp["batches"][arch, n_mb]:
                p, s, m = step(p, s, {k: jnp.asarray(v)
                                      for k, v in b.items()})
                rec["loss"].append(float(m["loss"]))
                rec["gnorm"].append(float(m["grad_norm"]))
            rec["params"] = _np_tree(p)
            ref[f"train/{arch}/{n_mb}"] = rec
    x = jnp.asarray(inp["moe_x"])
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for mode in ("ep", "tp"):
        cfg = JMoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                         capacity_factor=4.0, parallel_mode=mode)
        p = jax.tree_util.tree_map(jnp.asarray, inp["moe_params"][mode])
        ref[f"moe_ref/{mode}"] = np.asarray(j_moe.moe_ref(
            p, x, cfg=cfg, act="swiglu"))
        ref[f"moe_1x1/{mode}"] = np.asarray(jax.jit(
            lambda p, x, cfg=cfg: j_moe.moe_forward(
                p, x, cfg=cfg, act="swiglu", mesh=mesh,
                batch_axes=("data",)))(p, x))
    sp = jax.tree_util.tree_map(jnp.asarray, inp["slstm_params"])

    def loss_plain(p, x):
        return jnp.sum(j_xlstm.slstm_forward(p, x, n_heads=2) ** 2)

    sl, sg = jax.jit(jax.value_and_grad(loss_plain))(
        sp, jnp.asarray(inp["slstm_x"]))
    ref["slstm"] = {"loss": float(sl), "grads": _np_tree(sg)}
    for causal, window, S_ in ATTN_CASES:
        q, k, v = inp["attn", S_, window]
        ref[f"qblock/{causal}/{window}/{S_}"] = (
            np.asarray(jax.jit(lambda q, k, v, c=causal, w=window:
                               j_attn.qblock_attention(
                                   q, k, v, causal=c, window=w, block_q=8,
                                   block_kv=8))(q, k, v)),
            _naive(q, k, v, causal, window))
    w = jax.tree_util.tree_map(jnp.asarray, inp["attn_w"])
    kw = dict(n_heads=6, n_kv_heads=2, head_dim=8, rope_theta=10000.0,
              window=0, block_q=8, block_kv=8)
    ref["expand"] = tuple(
        np.asarray(jax.jit(lambda w, x, lay=lay: j_attn.attn_forward(
            w, x, layout=lay, **kw)[0])(w, jnp.asarray(inp["attn_x"])))
        for lay in ("expand", "grouped"))
    # allreduce_compressed: the reference's compress on each rank's grads,
    # then its psum arithmetic over each data group ({0, 2} and {1, 3})
    states = [j_gc.init(g) for g in inp["gc"]]
    calls = []
    for _ in range(2):
        comp = [j_gc.compress(jax.tree_util.tree_map(jnp.asarray, g), st)
                for g, st in zip(inp["gc"], states)]
        states = [c[2] for c in comp]
        res = []
        for r in range(4):
            grp = (r % 2, r % 2 + 2)
            q_sum = {k: sum(np.asarray(comp[i][0][k], np.int32) for i in grp)
                     for k in ("a", "b")}
            s_mean = {k: sum(np.asarray(comp[i][1][k], np.float32)
                             for i in grp) / 2 for k in ("a", "b")}
            res.append({k: q_sum[k].astype(np.float32) * s_mean[k] / 2
                        for k in ("a", "b")})
        calls.append(res)
    ref["gc"] = calls
    return ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(rank outputs, reference). The ranks run while the parent computes
    the reference."""
    tmp = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.start_processes(worker, args=(str(tmp),), nprocs=4,
                             join=False, start_method="spawn")
    try:
        ref = _reference(inp)
    finally:
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("the ranks did not finish in 300 s")
    outs = []
    for r in range(4):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs, ref, inp


def _ok(out, name):
    err = out.get(f"error/{name}")
    assert err is None, err


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_mb", MBS)
def test_sharded_train_step_matches_reference(results, arch, n_mb):
    from repro_torch.convert import params_from_numpy
    from repro_torch.train.optimizer import tree_leaves
    outs, ref, _ = results
    _ok(outs[0], "train")
    got, want = outs[0][f"train/{arch}/{n_mb}"], ref[f"train/{arch}/{n_mb}"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], atol=1e-5,
                               rtol=1e-5)
    cfg = small(get_config(arch))
    want_p = [t.numpy() for t in tree_leaves(params_from_numpy(
        want["params"], cfg, device="cpu"))]
    for g, w, tiny in zip(got["params"], want_p, got["tiny"]):
        err = np.abs(g - w)
        assert float(np.max(np.where(tiny, 0.0, err), initial=0)) <= 1e-5
        assert float(np.max(err, initial=0)) <= 4 * LR


@pytest.mark.parametrize("mode,ws", MOE_CASES)
def test_moe_forward_over_mesh(results, mode, ws):
    outs, ref, _ = results
    _ok(outs[0], "moe")
    got = outs[0][f"moe/{mode}/{ws}"]
    np.testing.assert_allclose(got, ref[f"moe_ref/{mode}"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got, ref[f"moe_1x1/{mode}"], rtol=2e-4,
                               atol=2e-4)


def test_slstm_sharded_grads_one_allreduce(results):
    outs, ref, _ = results
    _ok(outs[0], "slstm")
    got = outs[0]["slstm"]
    assert abs(got["loss"] - ref["slstm"]["loss"]) < 1e-5 * max(
        1.0, abs(ref["slstm"]["loss"]))
    for k, g in ref["slstm"]["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=1e-5, atol=1e-6)
    reduces = {k: v for k, v in got["comms"].items() if "all_reduce" in k}
    assert sum(reduces.values()) == 1, got["comms"]


@pytest.mark.parametrize("causal,window,S_", ATTN_CASES)
def test_qblock_attention_over_mesh(results, causal, window, S_):
    outs, ref, _ = results
    _ok(outs[0], "attention")
    got = outs[0][f"qblock/{causal}/{window}/{S_}"]
    j_out, naive = ref[f"qblock/{causal}/{window}/{S_}"]
    np.testing.assert_allclose(got, j_out, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, naive, rtol=3e-4, atol=3e-4)


def test_expand_attention_over_mesh(results):
    outs, ref, _ = results
    _ok(outs[0], "attention")
    for want in ref["expand"]:
        np.testing.assert_allclose(outs[0]["expand"], want, rtol=3e-4,
                                   atol=3e-4)


def test_allreduce_compressed_matches_reference(results):
    outs, ref, _ = results
    for r in range(4):
        _ok(outs[r], "compress")
        for got, want in zip(outs[r][f"gc/{r}"], (c[r] for c in ref["gc"])):
            for k in ("a", "b"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-6)


def test_restore_onto_another_mesh(results):
    outs, _, _ = results
    _ok(outs[0], "restore")
    assert outs[0]["restore"] == {"placed": True, "equal": True}


def test_replica_device_groups_partition_mesh(results):
    outs, _, _ = results
    _ok(outs[0], "serve")
    assert outs[0]["serve"]["groups"] == [2, 2]
    assert outs[0]["serve"]["raised"]


def test_mesh_replicas_bit_identical_on_two_devices(results):
    outs, _, _ = results
    _ok(outs[0], "serve")
    assert outs[0]["serve"]["replicas"] == 2
    assert outs[0]["serve"]["equal"]
