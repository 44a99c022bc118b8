"""The port's checkpoint store (``repro_torch.checkpoint.store``): the cases
of tests/test_checkpoint.py against the port, and plain trees crossing
between the two packages in both directions (the same layout, names and
bfloat16 bit patterns). Restored tensors are compared exactly.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro_torch.checkpoint import store


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.standard_normal((4, 8)), dtype=torch.float32),
            "b": {"c": torch.tensor(rng.integers(0, 9, (3,)),
                                    dtype=torch.int32),
                  "d": [torch.ones((2, 2), dtype=torch.bfloat16),
                        torch.zeros((5,), dtype=torch.float32)]}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _assert_equal_trees(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    t = _tree()
    store.save(tmp_path, 7, t)
    assert store.latest_step(tmp_path) == 7
    target = {
        "a": torch.empty((4, 8), device="meta"),
        "b": {"c": torch.empty((3,), dtype=torch.int32, device="meta"),
              "d": [torch.empty((2, 2), dtype=torch.bfloat16, device="meta"),
                    torch.empty((5,), device="meta")]}}
    restored = store.restore(tmp_path, 7, target)
    _assert_equal_trees(restored, t)


def test_gc_keeps_last_k(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        store.save(tmp_path, s, t, keep=2)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [4, 5]


def test_latest_pointer_ignores_missing_dir(tmp_path):
    t = _tree()
    store.save(tmp_path, 3, t)
    (tmp_path / "LATEST").write_text("99")
    assert store.latest_step(tmp_path) is None


def test_shape_mismatch_raises(tmp_path):
    store.save(tmp_path, 1, {"a": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        store.restore(tmp_path, 1, {"a": torch.empty((3, 3), device="meta")})


def test_async_checkpointer(tmp_path):
    ck = store.AsyncCheckpointer(tmp_path, keep=2)
    t = _tree()
    ck.save(10, t)
    ck.wait()
    assert store.latest_step(tmp_path) == 10
    ck.save(20, t)
    ck.save(30, t)   # waits for 20 first
    ck.wait()
    assert store.latest_step(tmp_path) == 30
    assert 10 not in [int(p.name.split("_")[1])
                      for p in tmp_path.glob("step_*")]


def test_async_snapshot_is_taken_before_return(tmp_path, monkeypatch):
    """An in-place update right after ``save`` returns does not reach the
    checkpoint (the train loop updates its tensors in place)."""
    t = _tree()
    want = {"a": t["a"].clone(), "b": {"c": t["b"]["c"].clone(),
                                       "d": [x.clone() for x in t["b"]["d"]]}}
    ck = store.AsyncCheckpointer(tmp_path)
    gate = threading.Event()
    orig = store.save

    def slow_save(*a, **k):
        gate.wait(timeout=10)
        return orig(*a, **k)

    monkeypatch.setattr(store, "save", slow_save)
    ck.save(1, t)
    t["a"].add_(1.0)
    t["b"]["d"][0].mul_(3)
    gate.set()
    ck.wait()
    monkeypatch.undo()
    _assert_equal_trees(store.restore(tmp_path, 1, want), want)


def test_restore_with_shardings_names_the_roadmap(tmp_path):
    """``restore(shardings=...)``: each leaf comes back a DTensor laid out
    as its sharding, on a one-rank (1, 1) mesh here (4 ranks and a re-mesh:
    ``tests/test_torch_dist.py``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.sharding.specs import NamedSharding, P
    t = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(4)]}
    store.save(tmp_path / "ck", 1, t)
    init_distributed("cpu", init_method=f"file://{tmp_path}/store")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        sh = {"a": NamedSharding(mesh, P("data", "model")),
              "b": [NamedSharding(mesh, P(None))]}
        r = store.restore(tmp_path / "ck", 1, t, shardings=sh)
        assert isinstance(r["a"], DTensor) and isinstance(r["b"][0], DTensor)
        assert list(r["a"].placements) == sh["a"].placements
        assert torch.equal(r["a"].full_tensor(), t["a"])
        assert torch.equal(r["b"][0].full_tensor(), t["b"][0])
    finally:
        dist.destroy_process_group()


def test_optimizer_state_keys_follow_the_reference(tmp_path):
    """A NamedTuple's fields are saved as "." + name, as the reference's
    key path names them."""
    from repro_torch.train.optimizer import AdamW
    p = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    tree = {"params": p, "opt": AdamW().init(p)}
    assert list(store._flatten(tree)) == list(j_store._flatten(
        jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)))
    store.save(tmp_path, 2, tree)
    restored = store.restore(tmp_path, 2, tree)
    assert int(restored["opt"].step) == 0
    assert type(restored["opt"]).__name__ == "AdamWState"


def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": jnp.asarray(rng.standard_normal((4, 8)), jnp.float32),
            "b": {"c": jnp.asarray(rng.integers(0, 9, (3,)), jnp.int32),
                  "d": [jnp.asarray(rng.standard_normal((2, 3)),
                                    jnp.bfloat16),
                        jnp.zeros((5,), jnp.float32)]}}


def _as_torch(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(x)


def test_reference_checkpoint_restores_in_port(tmp_path):
    jt = _jax_tree()
    j_store.save(tmp_path, 4, jt)
    want = jax.tree_util.tree_map(_as_torch, jt)
    target = jax.tree_util.tree_map(lambda t: torch.empty_like(
        t, device="meta"), want)
    assert store.latest_step(tmp_path) == 4
    _assert_equal_trees(store.restore(tmp_path, 4, target), want)


def test_port_checkpoint_restores_in_reference(tmp_path):
    jt = _jax_tree(1)
    t = jax.tree_util.tree_map(_as_torch, jt)
    store.save(tmp_path, 9, t)
    assert j_store.latest_step(tmp_path) == 9
    restored = j_store.restore(tmp_path, 9, jax.eval_shape(lambda: jt))
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(jt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
