"""Checkpointing: atomic, async-capable.

Layout:  <dir>/step_<N>/   one .npy per tree leaf + manifest.json
         <dir>/LATEST      (atomic pointer file, written last)

Port of ``repro.checkpoint.store``, in the reference's layout and naming:
a leaf's key joins its path with "/" (a dict key as itself, a list index as
its number, a NamedTuple field as "." + its name), its file is the key with
"/" replaced by "__" plus ".npy", and bfloat16 is stored as its uint16 bit
pattern with "bfloat16" in the manifest. A plain tree of dicts and lists
saved by either package restores in the other; model checkpoints do not
cross, because the port's parameter tree is laid out per layer.

Fault-tolerance contract:
- writes go to step_<N>.tmp then a single atomic rename; a crash mid-save
  never corrupts the previous checkpoint;
- `AsyncCheckpointer` snapshots device tensors to host memory and writes in
  a background thread, so the train loop is blocked only for the
  device->host copy (checkpoint/compute overlap).

A DTensor leaf is saved whole: every rank of its mesh gathers it, and
under a process group rank 0 alone writes. ``restore(..., shardings=...)``
is the elastic re-mesh path: a checkpoint written from one mesh comes back
as DTensors laid out on another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _children(tree) -> Optional[Iterator[Tuple[str, Any]]]:
    """(key, child) pairs of a container in the reference's order (dict
    keys sorted, as ``jax.tree_util`` visits them), None for a leaf."""
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (("." + f, getattr(tree, f)) for f in tree._fields)
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in kids:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _rebuild(tree, leaf_of, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaf_of(key)``."""
    if _children(tree) is None:
        return leaf_of(prefix)
    sub = lambda k, v: _rebuild(v, leaf_of,  # noqa: E731
                                f"{prefix}/{k}" if prefix else k)
    if isinstance(tree, dict):
        return {k: sub(str(k), v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(sub("." + f, getattr(tree, f))
                            for f in tree._fields))
    return type(tree)(sub(str(i), v) for i, v in enumerate(tree))


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (every rank of its mesh must call)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _writes() -> bool:
    """Whether this process writes: rank 0 of a process group, or the one
    process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, logical dtype name) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = _whole(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory, step: int, tree, *, keep: int = 3) -> Path:
    d = Path(directory)
    tmp = d / f"step_{step}.tmp"
    final = d / f"step_{step}"
    arrays = {key: _to_numpy(leaf) for key, leaf in _flatten(tree).items()}
    if not _writes():
        return final
    d.mkdir(parents=True, exist_ok=True)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}, "time": time.time()}
    for key, (arr, logical) in arrays.items():
        fn = key.replace("/", "__") + ".npy"
        np.save(tmp / fn, arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": logical}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic
    latest = d / "LATEST"
    tmp_l = d / "LATEST.tmp"
    tmp_l.write_text(str(step))
    os.replace(tmp_l, latest)                   # atomic pointer
    _gc(d, keep)
    return final


def _gc(d: Path, keep: int):
    steps = sorted((int(p.name.split("_")[1]) for p in d.glob("step_*")
                    if p.name.split("_")[1].isdigit()))
    for s in steps[:-keep]:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)


def latest_step(directory) -> Optional[int]:
    p = Path(directory) / "LATEST"
    if not p.exists():
        return None
    try:
        step = int(p.read_text().strip())
    except ValueError:
        return None
    return step if (Path(directory) / f"step_{step}").exists() else None


def restore(directory, step: int, target_tree, shardings=None, *,
            device=None):
    """Restore into the structure of ``target_tree``, whose tensor leaves
    (meta tensors will do) give each leaf's shape and dtype; each restored
    tensor goes to ``device``, or else to its target's device (the CPU for
    a meta target). If ``shardings`` (a matching tree of
    ``sharding.specs.NamedSharding``) is given, each leaf becomes a DTensor
    with its sharding, on its mesh's device — this is the elastic-remesh
    path."""
    d = Path(directory) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_t = _flatten(target_tree)
    flat_s = _flatten(shardings) if shardings is not None else {}
    out = {}
    for key, struct in flat_t.items():
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(d / info["file"])
        if tuple(arr.shape) != tuple(struct.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(struct.shape)}")
        if info["dtype"] == "bfloat16" and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if key in flat_s:
            sh = flat_s[key]
            out[key] = distribute_tensor(
                t.to(sh.mesh.device_type, struct.dtype), sh.mesh,
                sh.placements, src_data_rank=None)
            continue
        dev = device
        if dev is None:
            dev = "cpu" if struct.device.type == "meta" else struct.device
        out[key] = t.to(dev, struct.dtype)
    return _rebuild(target_tree, out.__getitem__)


class AsyncCheckpointer:
    """Snapshot-to-host then background write; at most one pending save."""

    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self.saved_steps = []

    def save(self, step: int, tree):
        """Copy every tensor of ``tree`` to host memory on the caller's
        thread (the caller may then update its tensors in place), then
        write the copy in the background."""
        self.wait()
        flat = _flatten(tree)
        host = _rebuild(tree, lambda k: _host_copy(flat[k]))

        def _write():
            save(self.dir, step, host, keep=self.keep)
            self.saved_steps.append(step)

        self._pending = threading.Thread(target=_write, daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return _whole(leaf.detach()).to("cpu", copy=True)
    return np.array(leaf)
