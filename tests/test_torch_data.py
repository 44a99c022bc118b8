"""The port's synthetic data pipeline and int8 gradient compression
(``repro_torch.data.pipeline``, ``repro_torch.train.grad_compress``)
against the JAX package's on the CPU.

Batches are byte-equal (the same numpy arithmetic). Compression: int8
payloads equal, scales and residuals within ``atol = 1e-7`` (float32
max-abs and division; ``torch.round`` and ``jnp.round`` both round half to
even).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import ShardSpec as JShardSpec
from repro.data.pipeline import synth_batch as j_synth_batch
from repro.train import grad_compress as j_gc
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import Prefetcher, ShardSpec, synth_batch
from repro_torch.train import grad_compress as gc


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hubert-xlarge",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("shard_id", [0, 1])
def test_synth_batch_byte_equal(arch, shard_id):
    cfg, j_cfg = get_config(arch).reduced(), j_get_config(arch).reduced()
    for step in (0, 1, 7, 1000):
        got = synth_batch(cfg, step, 8, 24, seed=3,
                          shard=ShardSpec(shard_id, 2))
        want = j_synth_batch(j_cfg, step, 8, 24, seed=3,
                             shard=JShardSpec(shard_id, 2))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), (k, step)


def test_synth_batch_full_width_vocab():
    """The full config's vocabulary (128,256 ids) at one step."""
    got = synth_batch(get_config("llama3.2-3b"), 5, 2, 64)
    want = j_synth_batch(j_get_config("llama3.2-3b"), 5, 2, 64)
    assert got["tokens"].tobytes() == want["tokens"].tobytes()
    assert int(got["tokens"].max()) < 128_256


def test_prefetcher_order_and_start_step():
    cfg, j_cfg = get_config("gemma3-1b").reduced(), \
        j_get_config("gemma3-1b").reduced()
    pf = Prefetcher(cfg, 4, 16, seed=1, start_step=3, depth=2)
    jpf = JPrefetcher(j_cfg, 4, 16, seed=1, start_step=3, depth=2)
    try:
        for want_step in range(3, 9):
            step, b = pf.next()
            j_step, jb = jpf.next()
            assert step == j_step == want_step
            assert b["tokens"].tobytes() == jb["tokens"].tobytes()
            direct = synth_batch(cfg, want_step, 4, 16, seed=1)
            assert b["tokens"].tobytes() == direct["tokens"].tobytes()
    finally:
        pf.close()
        jpf.close()


def test_grad_compress_matches_reference():
    rng = np.random.default_rng(0)
    grads = {"w": rng.standard_normal((64, 32)).astype(np.float32),
             "b": [rng.standard_normal((7,)).astype(np.float32) * 1e-3,
                   np.zeros((3,), np.float32)]}
    t = {"w": torch.tensor(grads["w"]),
         "b": [torch.tensor(g) for g in grads["b"]]}
    j = {"w": jnp.asarray(grads["w"]), "b": [jnp.asarray(g)
                                            for g in grads["b"]]}
    st, j_st = gc.init(t), j_gc.init(j)
    for _ in range(3):                    # error feedback over rounds
        q, s, st = gc.compress(t, st)
        jq, js, j_st = j_gc.compress(j, j_st)
        for a, b in ((q["w"], jq["w"]), (q["b"][0], jq["b"][0]),
                     (q["b"][1], jq["b"][1])):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in ((s["w"], js["w"]), (s["b"][0], js["b"][0]),
                     (st.residual["w"], j_st.residual["w"]),
                     (st.residual["b"][0], j_st.residual["b"][0])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)
        back = gc.decompress(q, s)
        j_back = j_gc.decompress(jq, js)
        np.testing.assert_allclose(back["w"].numpy(),
                                   np.asarray(j_back["w"]), atol=1e-7)


def test_allreduce_compressed_names_the_roadmap(tmp_path):
    """``allreduce_compressed`` over a one-rank axis: the reference's
    quantise / sum / mean-scale arithmetic with n = 1, and its error
    feedback (4 ranks: ``tests/test_torch_dist.py``)."""
    import jax
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    rng = np.random.default_rng(5)
    g_np = {"w": rng.standard_normal((3, 5)).astype(np.float32)}
    init_distributed("cpu", init_method=f"file://{tmp_path}/store")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        g = {"w": torch.tensor(g_np["w"])}
        st, j_st = gc.init(g), j_gc.init(g_np)
        for _ in range(2):
            out, st = gc.allreduce_compressed(g, st, mesh, "data")
            jq, js, j_st = j_gc.compress(
                jax.tree_util.tree_map(jnp.asarray, g_np), j_st)
            want = np.asarray(jq["w"], np.int32).astype(np.float32) \
                * np.asarray(js["w"], np.float32)
            np.testing.assert_allclose(out["w"].numpy(), want, rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(st.residual["w"].numpy(),
                                       np.asarray(j_st.residual["w"]),
                                       atol=1e-7)
    finally:
        dist.destroy_process_group()
