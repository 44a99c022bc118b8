"""Sharding policy parity: the port's ``repro_torch.sharding.specs`` and
``repro_torch.launch.steps`` against the JAX package's, for all ten archs at
full size on the production meshes (16x16 and 2x16x16).

The reference side runs on ``jax.eval_shape`` parameters and a
``jax.sharding.AbstractMesh`` (its ``ShardCtx`` reads only ``mesh.shape``);
the port side on meta-device parameters and a mesh of PyTorch's ``fake``
process-group backend (one process standing for rank 0), started here for
each mesh and destroyed after. The reference stacks layers along leading
axes, the port holds them in lists: each port leaf's spec must equal the
reference leaf's spec with the stack dims dropped. All comparisons are
exact.

The stack dims are unsharded in the reference's specs but for one kind of
leaf: a norm scale ``w`` of shape (layers, D). The reference's rule, keyed
on the leaf's name, reads it as a (d_in, d_out) weight (``w`` is also the
sLSTM input weight's name) and splits the layer dim over FSDP where the
layer count divides it. A per-layer leaf has no layer dim, so the port's
per-device parameter bytes equal the reference's counted with the stack
dims unsplit; the test also states by how much the reference's own count
differs, and that only norm scales make the difference.
"""
import os

import jax
import jax.numpy as jnp
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs.base import ASSIGNED_ARCHS as J_ARCHS
from repro.configs.base import all_cells as j_all_cells
from repro.configs.base import get_config as j_get_config
from repro.launch.mesh import batch_axes_of as j_batch_axes_of
from repro.launch.steps import make_ctx as j_make_ctx
from repro.launch.steps import microbatches_for as j_microbatches_for
from repro.models.registry import build_model as j_build_model
from repro.sharding.specs import ShardCtx as JShardCtx
from repro.sharding.specs import cache_shardings as j_cache_shardings
from repro.sharding.specs import param_specs as j_param_specs
from repro_torch.configs.base import ASSIGNED_ARCHS, all_cells, get_config
from repro_torch.launch.dryrun import analytic_param_bytes
from repro_torch.launch.mesh import (batch_axes_of, init_distributed,
                                     make_production_mesh)
from repro_torch.launch.steps import (abstract_params, make_ctx,
                                      microbatches_for)
from repro_torch.models.registry import build_model
from repro_torch.sharding.specs import (ShardCtx, cache_shardings,
                                        param_specs, replica_device_groups)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _j_analytic_param_bytes():
    """The reference's ``_analytic_param_bytes``. Importing its dry-run
    module sets XLA_FLAGS for a 512-device fleet; the import restores it,
    so that no later subprocess of this worker inherits it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _analytic_param_bytes
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _analytic_param_bytes


def _flat(tree, path=()):
    """(path without list indices, leaf) pairs of a nested dict / list."""
    if isinstance(tree, dict):
        return [x for k, v in sorted(tree.items())
                for x in _flat(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields") \
            and not type(tree).__name__ in ("P", "PartitionSpec"):
        return [x for v in tree for x in _flat(v, path)]
    return [("/".join(path), tree)]


def _norm(spec):
    """A spec as a tuple, a one-axis tuple entry as the axis (JAX's
    PartitionSpec normalises ('model',) to 'model')."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _by_path(pairs):
    out = {}
    for p, v in pairs:
        out.setdefault(p, []).append(v)
    return out


def _port_side(kind):
    """Everything the tests compare, computed on the port with a fake
    mesh, as plain data."""
    dims, axes = MESHES[kind]
    n = 1
    for d in dims:
        n *= d
    init_distributed("fake", world_size=n)
    try:
        mesh = make_production_mesh(multi_pod=kind == "multi",
                                    device_type="cpu")
        out = {"groups": {a: [len(g) for g in replica_device_groups(mesh, a)]
                          for a in axes}}
        try:
            replica_device_groups(mesh, "expert")
            out["raised"] = False
        except ValueError as e:
            out["raised"] = "axis" in str(e)
        for arch in ASSIGNED_ARCHS:
            cfg = get_config(arch)
            ctx = ShardCtx(mesh=mesh, batch_axes=batch_axes_of(mesh))
            p = abstract_params(build_model(cfg))
            specs = param_specs(p, cfg, ctx)
            rec = {"specs": _by_path(
                (k, (_norm(s), tuple(t.shape)))
                for (k, s), (_, t) in zip(_flat(specs), _flat(p))),
                "bytes": analytic_param_bytes(p, cfg, ctx),
                "layout": (ctx.attn_layout(cfg.n_heads, cfg.n_kv_heads),
                           ShardCtx(mesh, batch_axes_of(mesh),
                                    attn_qblock=True).attn_layout(
                                        cfg.n_heads, cfg.n_kv_heads)),
                "cells": {}}
            for cell in cfg.shape_cells():
                c = make_ctx(mesh, cell, cfg)
                r = {"seq_axes": c.cache_seq_axes}
                if cell.kind == "train":
                    r["microbatches"] = microbatches_for(cfg, cell, mesh)
                if cell.kind == "decode":
                    cs = build_model(cfg).cache_struct(cell.global_batch,
                                                       cell.seq_len)
                    r["cache"] = [(k, _norm(s.spec)) for k, s in
                                  _flat(cache_shardings(cs, cfg, c))]
                rec["cells"][cell.name] = r
            out[arch] = rec
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=sorted(MESHES))
def sides(request):
    kind = request.param
    port = _port_side(kind)
    dims, axes = MESHES[kind]
    return kind, port, AbstractMesh(dims, axes)


def _j_params(arch):
    m = j_build_model(j_get_config(arch))
    return jax.eval_shape(m.init, jax.ShapeDtypeStruct((2,), jnp.uint32))


def test_assigned_archs_and_cells_match_reference():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert [(a, c.name, c.seq_len, c.global_batch, c.kind)
            for a, c in all_cells()] == \
        [(a, c.name, c.seq_len, c.global_batch, c.kind)
         for a, c in j_all_cells()]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_shape_cell_assignment(arch):
    """The counterpart of ``test_models_smoke.py::test_shape_cell_
    assignment``, and the same cells and skips as the reference's."""
    cfg = get_config(arch)
    cells = {c.name for c in cfg.shape_cells()}
    assert "train_4k" in cells and "prefill_32k" in cells
    if cfg.encoder_only:
        assert "decode_32k" not in cells
    if not cfg.supports_long_context:
        assert "long_500k" not in cells
    skips = dict(cfg.skipped_cells())
    assert cells.isdisjoint(skips)
    assert cells == {c.name for c in j_get_config(arch).shape_cells()}
    assert skips == dict(j_get_config(arch).skipped_cells())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(sides, arch):
    kind, port, amesh = sides
    cfg = j_get_config(arch)
    ctx = JShardCtx(mesh=amesh, batch_axes=j_batch_axes_of(amesh))
    p = _j_params(arch)
    ref = _by_path((k, (_norm(s), tuple(t.shape))) for (k, s), (_, t) in
                   zip(_flat(j_param_specs(p, cfg, ctx)), _flat(p)))
    got = port[arch]["specs"]
    assert sorted(got) == sorted(ref)
    sizes = dict(zip(amesh.axis_names, amesh.axis_sizes))

    def nbytes(spec, shape):
        n, shards = 1, 1
        for d in shape:
            n *= d
        for ax in spec:
            for a in (() if ax is None else
                      ax if isinstance(ax, tuple) else (ax,)):
                shards *= sizes[a]
        return n * jnp.dtype(cfg.param_dtype).itemsize / shards

    unstacked = stack_split = 0.0
    for path, leaves in got.items():
        want = set()
        for (spec, shape), (_, sds) in zip(ref[path], (
                x for x in _flat(p) if x[0] == path)):
            n_stack = len(shape) - len(leaves[0][1])
            if any(s is not None for s in spec[:n_stack]):
                assert path.split("/")[-1] == "w" and len(leaves[0][1]) == 1
            want.add((spec[n_stack:], shape[n_stack:]))
            b = nbytes(spec[n_stack:], shape) * sds.dtype.itemsize \
                / jnp.dtype(cfg.param_dtype).itemsize
            unstacked += b
            stack_split += b - nbytes(spec, shape) * sds.dtype.itemsize \
                / jnp.dtype(cfg.param_dtype).itemsize
        assert set(leaves) == want, path
    assert port[arch]["bytes"] == pytest.approx(unstacked, rel=1e-12)
    j_bytes = _j_analytic_param_bytes()(p, cfg, ctx)
    assert j_bytes == pytest.approx(unstacked - stack_split, rel=1e-12)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_ctx_cells_and_cache_shardings_match_reference(sides, arch):
    kind, port, amesh = sides
    cfg = j_get_config(arch)
    m = j_build_model(cfg)
    base = JShardCtx(mesh=amesh, batch_axes=j_batch_axes_of(amesh))
    assert port[arch]["layout"] == (
        base.attn_layout(cfg.n_heads, cfg.n_kv_heads),
        JShardCtx(mesh=amesh, batch_axes=j_batch_axes_of(amesh),
                  attn_qblock=True).attn_layout(cfg.n_heads, cfg.n_kv_heads))
    for cell in cfg.shape_cells():
        got = port[arch]["cells"][cell.name]
        ctx = j_make_ctx(amesh, cell, cfg)
        assert got["seq_axes"] == ctx.cache_seq_axes
        if cell.kind == "train":
            assert got["microbatches"] == j_microbatches_for(cfg, cell,
                                                             amesh)
        if cell.kind == "decode":
            cs = m.cache_struct(cell.global_batch, cell.seq_len)
            want = [(k, _norm(s.spec))
                    for k, s in _flat(j_cache_shardings(cs, cfg, ctx))]
            assert got["cache"] == want


def test_replica_device_groups(sides):
    kind, port, _ = sides
    dims, axes = MESHES[kind]
    n = 1
    for d in dims:
        n *= d
    for a, size in zip(axes, dims):
        assert port["groups"][a] == [n // size] * size
    assert port["raised"]
