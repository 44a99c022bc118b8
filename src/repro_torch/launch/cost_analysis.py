"""Per-device cost of one step, counted from the ops PyTorch dispatches.

Counterpart of ``repro.launch.hlo_analysis``: there is no HLO text in the
port, so the step itself runs (under fake tensors in the dry run) inside
:class:`CostMode`, a dispatch mode that sees every op on the LOCAL shards
(it lets DTensor run first and sees what DTensor dispatches):

- FLOPs: ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` uses) on each local op's own shapes, so a rank's
  FLOPs are those of its shards, replicated work included. (Above DTensor,
  ``FlopCounterMode`` would see the global shapes.) DTensor's own
  shape-inference runs are not counted.
- bytes: the inputs plus the outputs of every op that is not a view —
  what eager execution moves through memory, one op at a time (no fusion).
- collectives: counts by kind, the bytes each moves, and per-device wire
  bytes under the ring model of ``hlo_analysis.py``: all-reduce
  ``2 * in * (n-1)/n``, all-gather ``out * (n-1)/n``, reduce-scatter and
  all-to-all ``in * (n-1)/n``.

``analyze`` returns the keys ``roofline.from_record`` reads.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_C10D = torch.ops._c10d_functional
_COLLECTIVES = {  # op -> kind
    _C10D.all_reduce.default: "all-reduce",
    _C10D.all_reduce_.default: "all-reduce",
    _C10D.all_gather_into_tensor.default: "all-gather",
    _C10D.reduce_scatter_tensor.default: "reduce-scatter",
    _C10D.all_to_all_single.default: "all-to-all",
}
_GROUP_ARG = {"all-reduce": 2, "all-gather": 2, "reduce-scatter": 3,
              "all-to-all": 3}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts per-device FLOPs, bytes and collectives of what runs inside
    it (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_wire = 0.0
        self.by_cat: Dict[str, float] = defaultdict(float)
        self._inferring = 0

    def __enter__(self):
        # DTensor infers an op's output shape by running it on fake
        # tensors once per new input layout: not work of the step
        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        self._saved = prop

        def counted_out(this, *a, **kw):
            self._inferring += 1
            try:
                return prop(this, *a, **kw)
            finally:
                self._inferring -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = counted_out
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._saved
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor dispatch its shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inferring or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        ins, _ = tree_flatten((args, kwargs))
        outs, _ = tree_flatten(out)
        kind = _COLLECTIVES.get(func)
        if kind is not None:
            n = dist.distributed_c10d._resolve_process_group(
                args[_GROUP_ARG[kind]]).size()
            in_b, out_b = _nbytes(args[:1]), _nbytes(outs)
            ring = (n - 1) / max(n, 1)
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += max(in_b, out_b)
            self.coll_wire += {"all-reduce": 2.0 * in_b * ring,
                               "all-gather": out_b * ring}.get(
                                   kind, in_b * ring)
            self.bytes += in_b + out_b
            self.by_cat["collective"] += max(in_b, out_b)
            return out
        if func.is_view or func.namespace == "_c10d_functional":
            return out
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            fl = float(f(*args, **kwargs, out_val=out))
            self.flops += fl
            self.by_cat["dot"] += fl
        self.bytes += _nbytes(ins) + _nbytes(outs)
        return out

    def result(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_counts": dict(self.coll_counts),
            "collective_bytes": dict(self.coll_bytes),
            "collective_wire_bytes": self.coll_wire,
            "by_category": dict(self.by_cat),
        }


def analyze(fn: Callable, *args, **kwargs):
    """(fn's result, its per-device cost) for one call of ``fn``."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    res = mode.result()
    res["num_partitions"] = dist.get_world_size() \
        if dist.is_initialized() else 1
    return out, res
