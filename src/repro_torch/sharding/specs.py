"""Sharding policy: mesh-axis assignment for parameters, activations, caches.

Port of ``repro.sharding.specs``. GSPMD's shardings map to DTensor:

- a PartitionSpec is the port's :class:`P`, one entry a tensor dim (a mesh
  axis name, a tuple of names, or None); :func:`placements` turns it into
  DTensor placements on a ``torch.distributed.device_mesh.DeviceMesh``
  with the same axis names;
- ``with_sharding_constraint`` is ``redistribute`` on a DTensor
  (``ShardCtx._c``); on a plain tensor it does nothing, so every path
  without a context runs as it did.

Policy (MaxText-style hybrid):
- ``pod``   — pure data parallelism across pods: batch only.
- ``data``  — within-pod data parallelism + FSDP (ZeRO-3): batch AND the
  d_model dim of every weight matrix.
- ``model`` — tensor parallelism: attention heads / d_ff / experts / vocab.

Dims that do not divide the axis size are left unsharded (e.g. hymba's 25
heads stay replicated over ``model`` while its d_ff=5504 is sharded
16-way). Long-context decode cells shard the KV-cache *sequence* dim
instead (``cache_seq_axes``).

The port's per-layer parameter leaves carry the reference's spec without
its leading stack dims: the reference stacks layers along leading axes
(always unsharded), the port holds them in lists
(``convert.params_from_numpy``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import \
    implicit_replication as _implicit_replication
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig


class P(tuple):
    """PartitionSpec: for each tensor dim, the mesh axis it is split over
    (a name, a tuple of names split major first, or None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


@contextlib.contextmanager
def implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``
    (plain tensors act as replicated DTensors), safe to nest: PyTorch's
    resets the flag on exit even inside an outer one."""
    if DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with _implicit_replication():
        yield


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(mesh, spec: Sequence, shape=None) -> List:
    """DTensor placements, one per mesh dim, of a :class:`P`: a tensor dim
    split over a tuple of axes is ``Shard(d)`` on each of those mesh dims,
    which DTensor splits in mesh-dim order (major first). Given the
    tensor's ``shape``, a dim of size 1 stays whole: the policy splits it
    only over axes of size 1, the same layout, and DTensor's view rules
    refuse to reshape a split dim of size 1."""
    out: List[Any] = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[d] == 1):
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`P` over its axis names (the reference's
    ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> List:
        return placements(self.mesh, self.spec)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: Any                             # torch DeviceMesh
    batch_axes: Tuple[str, ...]           # ('data',) or ('pod','data')
    fsdp_axis: Optional[str] = "data"
    model_axis: Optional[str] = "model"
    # decode-cache sequence sharding (e.g. ('model',) or ('data','model'))
    cache_seq_axes: Optional[Tuple[str, ...]] = None
    # decode-optimised MoE: never gather expert weights (see models/moe.py)
    moe_weight_stationary: bool = False
    # q-block-parallel attention when heads don't divide the model axis
    attn_qblock: bool = False
    # sLSTM: accumulate recurrent-weight grads locally, one trailing psum
    slstm_local_grad: bool = False

    # -- helpers ------------------------------------------------------------
    def _axsz(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        shape = axis_sizes(self.mesh)
        n = 1
        for a in axes:
            n *= shape[a]
        return n

    def div(self, n: int, axes) -> bool:
        s = self._axsz(axes)
        return s > 0 and n % s == 0

    def maybe(self, n: int, axes):
        """axes if n divides evenly over them, else None."""
        return axes if self.div(n, axes) else None

    def _c(self, x, spec):
        """Redistribute a DTensor to ``spec``; a plain tensor passes."""
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh,
                              placements(self.mesh, spec, x.shape))

    def attn_layout(self, n_heads: int, n_kv: int) -> str:
        """'grouped' when KV heads shard evenly; 'expand' (KV replication up
        to n_heads) when only Q heads do; else 'qblock' (query-block
        sharding) when enabled, or 'grouped' (replicated attention,
        documented imbalance)."""
        if self.model_axis is None:
            return "grouped"
        if self.div(n_kv, self.model_axis):
            return "grouped"
        if self.div(n_heads, self.model_axis):
            return "expand"
        return "qblock" if self.attn_qblock else "grouped"

    def act_qblocks(self, x):
        """(B, nb, Bq, K, G, d): shard the query-block dim over model."""
        b = self.maybe(x.shape[0], self.batch_axes)
        n = self.maybe(x.shape[1], self.model_axis)
        return self._c(x, P(b, n, None, None, None, None))

    # -- activation constraints ----------------------------------------------
    def act_btd(self, x):
        b = self.maybe(x.shape[0], self.batch_axes)
        return self._c(x, P(b, None, None))

    def act_ff(self, x):
        b = self.maybe(x.shape[0], self.batch_axes)
        f = self.maybe(x.shape[-1], self.model_axis)
        return self._c(x, P(b, None, f))

    def act_logits(self, x):
        b = self.maybe(x.shape[0], self.batch_axes)
        v = self.maybe(x.shape[-1], self.model_axis)
        return self._c(x, P(b, None, v))

    def act_kv(self, x):
        """(B, S, K, hd) KV tensors / caches, or grouped q (B,S,K,G,hd)."""
        b = self.maybe(x.shape[0], self.batch_axes)
        if x.ndim == 5:  # grouped q (B, S, K, G, hd): shard K if divisible
            kk = self.maybe(x.shape[2], self.model_axis)
            return self._c(x, P(b, None, kk, None, None))
        kk = self.maybe(x.shape[2], self.model_axis)
        if kk is None and self.cache_seq_axes is not None \
                and self.div(x.shape[1], self.cache_seq_axes):
            return self._c(x, P(b, self.cache_seq_axes, None, None))
        return self._c(x, P(b, None, kk, None))

    def batch_spec(self, batch_shape_tree):
        """Input-batch shardings (tokens/labels/embeds)."""
        def one(t):
            b = self.maybe(t.shape[0], self.batch_axes)
            return NamedSharding(self.mesh,
                                 P(*([b] + [None] * (t.ndim - 1))))
        return _map_with_path(lambda _, t: one(t), batch_shape_tree)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

_IN_OUT = {  # name -> shard the out dim on model (else the in dim)
    "wq": True, "wk": True, "wv": True, "wi": True, "wg": True, "w_in": True,
    "w": True, "wog": True, "wo": False, "w_out": False,
}


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, ctx: ShardCtx) -> P:
    """PartitionSpec for one parameter leaf, prefixing any leading dims
    beyond the policy's with None."""
    name = path[-1]
    fs, mx = ctx.fsdp_axis, ctx.model_axis
    moe = "moe" in path
    nd = len(shape)

    def pad(spec_tail):
        return P(*([None] * (nd - len(spec_tail)) + list(spec_tail)))

    if name in ("embed", "unembed"):
        v = ctx.maybe(shape[0], mx)
        d = ctx.maybe(shape[1], fs) if fs else None
        return P(v, d)
    if name == "router":
        return pad([ctx.maybe(shape[-2], fs), None])
    if moe and name in ("wi", "wg"):
        if cfg.moe.parallel_mode == "ep" and \
                ctx.div(cfg.moe.num_experts, mx):
            return pad([mx, ctx.maybe(shape[-2], fs), None])
        return pad([None, ctx.maybe(shape[-2], fs),
                    ctx.maybe(shape[-1], mx)])
    if moe and name == "wo":
        if cfg.moe.parallel_mode == "ep" and \
                ctx.div(cfg.moe.num_experts, mx):
            return pad([mx, None, ctx.maybe(shape[-1], fs)])
        return pad([None, ctx.maybe(shape[-2], mx),
                    ctx.maybe(shape[-1], fs)])
    if nd == 1 and name == "w" and any(k.isdigit() for k in path):
        # a layer's norm scale: the reference's rule, keyed on the name
        # "w" (the sLSTM input weight's), reads its stacked (layers, D)
        # leaf as a weight matrix and splits D over model (and the layer
        # dim over FSDP, a dim the port's per-layer leaf does not have)
        return P(ctx.maybe(shape[-1], mx))
    if nd >= 2 and name in _IN_OUT:
        if _IN_OUT[name]:   # (..., D_in, D_out): FSDP in, TP out
            return pad([ctx.maybe(shape[-2], fs), ctx.maybe(shape[-1], mx)])
        return pad([ctx.maybe(shape[-2], mx), ctx.maybe(shape[-1], fs)])
    if name == "a_log":
        return pad([ctx.maybe(shape[-2], mx), None])
    if name == "conv_w":
        return pad([None, ctx.maybe(shape[-1], mx)])
    if name == "r":      # slstm recurrent (4, H, dh, dh)
        return pad([None, None, None])
    # norms, biases, gates, scalars
    return P(*([None] * nd))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params_tree, cfg: ModelConfig, ctx: ShardCtx):
    """A :class:`P` for each leaf of a parameter tree (tensors, meta
    tensors will do), in the tree's structure."""
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path, tuple(leaf.shape), cfg, ctx),
        params_tree)


def param_shardings(params_tree, cfg: ModelConfig, ctx: ShardCtx):
    """A :class:`NamedSharding` for each leaf of a parameter tree."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(
            ctx.mesh, _leaf_spec(path, tuple(leaf.shape), cfg, ctx)),
        params_tree)


def replica_device_groups(mesh, axis: str = "data"):
    """Split a mesh's device grid into per-replica device groups along one
    named axis: replica ``i`` gets the (flattened) devices of slice ``i``.

    A mesh rank is a device of the mesh's type: ``cuda:<rank mod the
    cards this host has>`` on a CUDA mesh, the CPU on a CPU mesh. Serving
    maps one engine replica per slice
    (``repro_torch.serve.EngineGroup.from_mesh``); the remaining axes stay
    available for intra-replica parallelism, and a replica whose slice
    holds several devices round-robins batches within it.
    """
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    grid = torch.movedim(mesh.mesh, names.index(axis), 0)
    n_cards = torch.cuda.device_count() if mesh.device_type == "cuda" else 0

    def device(rank: int) -> torch.device:
        if mesh.device_type == "cuda":
            return torch.device("cuda", rank % max(n_cards, 1))
        return torch.device(mesh.device_type)

    return [[device(int(r)) for r in grid[i].reshape(-1)]
            for i in range(grid.shape[0])]


def cache_shardings(cache_tree, cfg: ModelConfig, ctx: ShardCtx):
    """Shardings for the decode cache tree."""
    mx = ctx.model_axis

    def one(sds):
        shp = tuple(sds.shape)
        nd = len(shp)
        # attention caches: (..., B, S, K, hd)
        if nd >= 4 and shp[-1] == cfg.head_dim and shp[-2] == cfg.n_kv_heads:
            b = ctx.maybe(shp[-4], ctx.batch_axes)
            k = ctx.maybe(cfg.n_kv_heads, mx)
            s = None
            if k is None and ctx.cache_seq_axes is not None and \
                    ctx.div(shp[-3], ctx.cache_seq_axes):
                s = ctx.cache_seq_axes
            return NamedSharding(
                ctx.mesh, P(*([None] * (nd - 4) + [b, s, k, None])))
        # ssm / xlstm states: shard the widest trailing dim if divisible
        tail = ctx.maybe(shp[-1], mx) if shp[-1] >= 128 else None
        spec = [None] * nd
        spec[-1] = tail
        return NamedSharding(ctx.mesh, P(*spec))

    return _map_with_path(lambda _, t: one(t), cache_tree)


# ---------------------------------------------------------------------------
# shard_map bodies: local shards and the collectives over named axes
# ---------------------------------------------------------------------------


def done(t: torch.Tensor) -> torch.Tensor:
    """The result of a functional collective, waited for (under fake
    tensors it is already a plain tensor)."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def group(mesh, axis: str):
    """The (mesh, dim) group of one named axis, for the functional
    collectives."""
    return (mesh, list(mesh.mesh_dim_names).index(axis))


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over one mesh axis into a value every rank of the
    axis holds; the backward passes the gradient through unchanged."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return done(funcol.all_reduce(t, "sum", group(mesh, axis)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``jax.lax.psum`` over one mesh axis or a tuple of them."""
    for a in ((axes,) if isinstance(axes, str) else axes):
        if axis_sizes(mesh)[a] > 1:
            t = _SumOver.apply(t, mesh, a)
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``; its gradient is the
    reduce-scatter."""
    if axis_sizes(mesh)[axis] == 1:
        return t
    return funcol.all_gather_tensor_autograd(t.contiguous(), dim,
                                             group(mesh, axis))


def to_local(t: torch.Tensor, mesh, spec: P, partial_grad: bool = True
             ) -> torch.Tensor:
    """The local shard of ``t`` laid out as ``spec`` (a plain tensor is
    taken as replicated): a ``shard_map`` input. With ``partial_grad`` its
    gradient is marked partial over the mesh axes the spec leaves
    replicated (ranks along them compute different parts of it); else it
    keeps the spec's layout (the body has reduced it already)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    pl = placements(mesh, spec)
    grad_pl = [p if isinstance(p, Shard) or not partial_grad else Partial()
               for p in pl]
    return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)


def on_batch_head_shards(fn, *ts: torch.Tensor, **kw) -> torch.Tensor:
    """``fn(*ts, **kw)`` for work independent across batch rows (dim 0)
    and heads (dim 2) of every input: attention, the mLSTM. Where the
    inputs are DTensors it runs on each rank's shards (``local_map``), as
    GSPMD partitions such work with no collective: each input keeps its
    split of dim 0 or dim 2 along a mesh dim where all inputs split alike,
    and is gathered along every other mesh dim. The output is laid out
    as the first input."""
    if not isinstance(ts[0], DTensor):
        return fn(*ts, **kw)
    keep = [ps[0] if (isinstance(ps[0], Shard) and ps[0].dim in (0, 2)
                      and all(p == ps[0] for p in ps)) else Replicate()
            for ps in zip(*(t.placements for t in ts))]
    run = local_map(functools.partial(fn, **kw), out_placements=keep,
                    in_placements=tuple(keep for _ in ts),
                    device_mesh=ts[0].device_mesh, redistribute_inputs=True)
    if not torch.is_grad_enabled():
        return run(*ts)
    return _ContiguousGrad.apply(run(*map(_ContiguousGrad.apply, ts)))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: DTensor's
    backward of a head split views it, and a redistributed gradient may
    come strided."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], *sizes)``. On a DTensor whose last dim is
    split over mesh axes that ``sizes[0]`` does not divide, that dim is
    gathered first: DTensor's view rules split a sharded dim only along
    its leading part (GSPMD reshards such a reshape itself)."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        split = [i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == last]
        n = 1
        for i in split:
            n *= x.device_mesh.size(i)
        if sizes[0] % n:
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in split else p
                for i, p in enumerate(x.placements)])
    return x.reshape(*x.shape[:-1], *sizes)


class _MergeLast(torch.autograd.Function):
    """Merge the last k dims; the backward splits them with
    :func:`split_last` (DTensor's own backward of the merge would split a
    gradient whose last dim is sharded unevenly for the split)."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.sizes = tuple(x.shape[-k:])
        return x.reshape(*x.shape[:-k], -1)

    @staticmethod
    def backward(ctx, g):
        return split_last(g, *ctx.sizes), None


def merge_last(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` with its last ``k`` dims merged into one (heads back into the
    model width), differentiable on DTensors whatever their layout."""
    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-k], -1)
    return _MergeLast.apply(x, k)
