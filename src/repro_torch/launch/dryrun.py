"""Multi-pod dry run: run every (architecture x input-shape) cell's step on
the production meshes (16x16 single-pod; 2x16x16 multi-pod) without the
devices, and record its per-device cost, memory and roofline inputs.

Port of ``repro.launch.dryrun``. One process stands for rank 0 of the
mesh: PyTorch's ``fake`` process-group backend answers every collective at
once, parameters are built on the meta device and every tensor of the step
is a fake tensor (shapes and dtypes, no storage), so the step runs in
seconds on a CPU. It records, per cell:

- ``cost``: ``launch.cost_analysis`` over the step (per-device FLOPs on the
  local shards, bytes moved, collectives and ring wire bytes);
- ``memory``: the per-device peak of live bytes that
  ``torch.distributed._tools.mem_tracker.MemTracker`` saw during the step
  (parameters, optimizer state, gradients, activations, temporaries);
- ``param_bytes_per_device``, ``model_flops``, ``n_params``,
  ``n_active_params`` as the reference computes them.

The step runs at a few shallow depths (and, for training, 1 and 2
microbatches), and the full cell's numbers are solved for from them: the
port's layer stacks are Python loops, so a full-depth run would dispatch
every layer's ops one by one (see :func:`run_cell`).

Run it as its own process (the fake group must not share a process with a
real one). Records land in ``artifacts/dryrun_torch/<cell>.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k \\
      --reduced --mesh-shape 2x2        # a small mesh and config (tests)

Perf variants (the reference's environment knobs, as flags of the same
names): --REPRO_ZERO1, --REPRO_MOE_WS, --REPRO_QBLOCK, --REPRO_SLSTM_LG,
--REPRO_DP_ONLY, --REPRO_SSM_CHUNK_LOCAL; --variant tags the record.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                           unset_fake_temporarily)
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.configs.base import (ASSIGNED_ARCHS, SHAPES_BY_NAME,
                                      ShapeCell, get_config)
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.launch.steps import (abstract_params, cell_batch_struct,
                                      make_ctx, microbatches_for, place,
                                      shard_decode, shard_prefill,
                                      shard_train_step)
from repro_torch.models.decode import init_cache
from repro_torch.models.registry import build_model
from repro_torch.sharding.specs import (axis_sizes, cache_shardings,
                                       param_shardings, param_specs)
from repro_torch.train.optimizer import AdamW, tree_leaves, tree_map

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
KNOBS = ("REPRO_ZERO1", "REPRO_MOE_WS", "REPRO_QBLOCK", "REPRO_SLSTM_LG",
         "REPRO_DP_ONLY", "REPRO_SSM_CHUNK_LOCAL")


def analytic_param_bytes(pstruct, cfg, ctx) -> float:
    """Per-device parameter bytes under the sharding policy."""
    sizes = axis_sizes(ctx.mesh)
    total = 0.0
    specs = param_specs(pstruct, cfg, ctx)
    for t, spec in zip(tree_leaves(pstruct), _spec_leaves(specs)):
        shards = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                shards *= sizes[a]
        total += t.numel() * t.element_size() / shards
    return total


def _spec_leaves(specs):
    """The :class:`P` leaves of a spec tree, in ``tree_leaves`` order."""
    if isinstance(specs, dict):
        return [p for v in specs.values() for p in _spec_leaves(v)]
    if isinstance(specs, list):
        return [p for v in specs for p in _spec_leaves(v)]
    return [specs]


def model_flops_for(cfg, cell: ShapeCell) -> float:
    n_act = cfg.n_active_params()
    if cell.kind == "train":
        return 6.0 * n_act * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_act * cell.global_batch * cell.seq_len
    return 2.0 * n_act * cell.global_batch  # decode: one token per sequence


def mesh_dims(multi_pod: bool, mesh_shape=None):
    """(dims, axis names) of the production mesh, or of ``mesh_shape``
    ("2x2", "2x2x2") for a small fleet."""
    if mesh_shape:
        dims = tuple(int(d) for d in mesh_shape.split("x"))
        return dims, ("pod", "data", "model")[-len(dims):]
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _fake_like(tree):
    """Fake tensors (in the active FakeTensorMode) shaped as a tree of meta
    tensors."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def _variant_ctx(ctx, cfg, knobs):
    if knobs.get("REPRO_MOE_WS"):
        ctx = dataclasses.replace(ctx, moe_weight_stationary=True)
    if knobs.get("REPRO_QBLOCK"):
        ctx = dataclasses.replace(ctx, attn_qblock=True)
    if knobs.get("REPRO_SLSTM_LG"):
        ctx = dataclasses.replace(ctx, slstm_local_grad=True)
    if knobs.get("REPRO_DP_ONLY"):
        # right-size parallelism: the model axis joins data parallelism —
        # no tensor sharding (small models on a fixed wide mesh)
        ctx = dataclasses.replace(
            ctx, batch_axes=tuple(ctx.batch_axes) + ("model",),
            model_axis=None)
    if knobs.get("REPRO_SSM_CHUNK_LOCAL") and cfg.ssm:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk_local=True))
    return ctx, cfg


def _layer_counts(cfg, n: int):
    """The features the step's cost is linear in, for ``n`` layers: 1 and
    the count of each kind of layer (a segment for the xLSTM and VLM
    stacks; a window of the attention pattern otherwise)."""
    if cfg.family == "ssm" or cfg.cross_attn_every:
        return [1.0, n / _segment(cfg)]
    return [1.0] + [float(sum(cfg.window_for_layer(i) == w
                              for i in range(n)))
                    for w in sorted(set(cfg.attn_pattern))]


def _segment(cfg) -> int:
    if cfg.family == "ssm":
        return cfg.slstm_every or cfg.n_layers
    return cfg.cross_attn_every


def depths_for(cfg):
    """The depths the dry run runs the step at: the fewest shallow ones
    whose layer counts determine the cost of the full depth (each layer of
    a kind costs the same, as each iteration of the reference's layer scan
    does), or the full depth where no shallower set does."""
    full = cfg.n_layers
    if cfg.family == "ssm" or cfg.cross_attn_every:
        cands = [k * _segment(cfg) for k in (1, 2)]
    else:
        g = cfg.remat_groups

        def grouped(n):        # _run_layers' two-level remat
            return bool(g and n % g == 0 and n > g)
        cands = [d for d in range(1, 2 * len(cfg.attn_pattern) * (g or 1)
                                  + 2 * (g or 0) + 1)
                 if grouped(d) == grouped(full)]
    depths, rank = [], 0
    for d in cands:
        if d >= full:
            break
        m = np.array([_layer_counts(cfg, x) for x in depths + [d]])
        if np.linalg.matrix_rank(m) > rank:
            depths, rank = depths + [d], rank + 1
    if rank < len(_layer_counts(cfg, full)):
        return [full]
    return depths


def _flat_cost(cost: dict, peak: dict) -> dict:
    """The numbers of one run's cost and memory, flat."""
    out = {"flops": cost["flops"], "bytes": cost["bytes"],
           "collective_wire_bytes": cost["collective_wire_bytes"]}
    for group in ("collective_counts", "collective_bytes", "by_category"):
        for k, v in cost[group].items():
            out[f"{group}/{k}"] = v
    for dev, d in peak.items():
        for k, v in d.items():
            out[f"memory/{dev}/{getattr(k, 'value', k)}"] = v
    return out


@contextlib.contextmanager
def _strided_offsets_on_real_tensors():
    """DTensor's redistribution planner finds a strided shard's offsets
    with an index tensor and ``tolist()``, which a fake tensor cannot
    answer: it runs on a real one (a few integers) here."""
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset

    def real(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)
    _StridedShard.local_shard_size_and_offset = real
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _run_once(cfg, cell, mesh, ctx, knobs, n_mb: int):
    """One fake-tensor run of the cell's step for ``cfg``; with ``n_mb``
    microbatches of the full cell's size (train). Returns its flat cost."""
    model = build_model(cfg, ctx)
    pstruct = abstract_params(model)
    # the mesh's own rank tensor is a real tensor
    with FakeTensorMode(allow_non_fake_inputs=True), \
            _strided_offsets_on_real_tensors():
        tracker = MemTracker()
        if cell.kind == "train":
            opt = AdamW(state_dtype=torch.bfloat16
                        if cfg.optimizer_dtype == "bfloat16"
                        else torch.float32, total_steps=10_000)
            bstruct = cell_batch_struct(cfg, cell)
            step, (_, ostruct, pshard, oshard) = shard_train_step(
                model, ctx, opt, bstruct, n_mb,
                zero1=bool(knobs.get("REPRO_ZERO1")))
            args = (place(_fake_like(pstruct), pshard),
                    place(_fake_like(ostruct), oshard), _fake_like(bstruct))
            tracker.track_external(*tree_leaves(args[:2]))
        elif cell.kind == "prefill":
            bstruct = cell_batch_struct(cfg, cell)
            step, (_, pshard) = shard_prefill(model, ctx, bstruct)
            args = (place(_fake_like(pstruct), pshard), _fake_like(bstruct))
            tracker.track_external(*tree_leaves(args[0]))
        else:
            step, (_, cstruct, tok, pos) = shard_decode(
                model, ctx, cell.global_batch, cell.seq_len)
            cache = init_cache(cfg, cell.global_batch, cell.seq_len,
                               device="cpu")
            args = (place(_fake_like(pstruct),
                          param_shardings(pstruct, cfg, ctx)),
                    place(cache, cache_shardings(cstruct, cfg, ctx)),
                    _fake_like(tok), pos)
            tracker.track_external(*tree_leaves(args[:2]))
        with tracker:
            _, cost = cost_analysis.analyze(step, *args)
        peak = tracker.get_tracker_snapshot("peak")
    return _flat_cost(cost, peak)


def _unflat(flat: dict) -> tuple:
    cost = {"flops": flat["flops"], "bytes": flat["bytes"],
            "collective_wire_bytes": flat["collective_wire_bytes"]}
    memory: dict = {}
    for k, v in flat.items():
        group, _, name = k.partition("/")
        if group in ("collective_counts", "collective_bytes",
                     "by_category"):
            if group == "collective_counts":
                v = int(round(v))
            cost.setdefault(group, {})[name] = v
        elif group == "memory":
            dev, _, kind = name.partition("/")
            memory.setdefault(dev, {})[kind] = int(round(v))
    for group in ("collective_counts", "collective_bytes", "by_category"):
        cost.setdefault(group, {})
    return cost, memory


def run_cell(arch: str, shape: str, multi_pod: bool, *, mesh_shape=None,
             reduced: bool = False, knobs=None, variant: str = "") -> dict:
    """Run one cell's step under the fake backend (started here: the
    process's first and only group) and return its record.

    The step runs at the depths of :func:`depths_for` and, for a train
    cell of M microbatches, with 1 and 2 microbatches of the cell's
    microbatch size; its cost is linear in the layer counts, in M and in
    their products, and is solved for at the full depth and M (the
    reference's HLO analysis multiplies its layer scan's body by the trip
    count the same way). The memory peak is linear in the layer counts
    (at 2 microbatches, which hold the accumulated gradients)."""
    knobs = knobs or {}
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cell = SHAPES_BY_NAME[shape]
    dims, axes = mesh_dims(multi_pod, mesh_shape)
    init_distributed("fake", world_size=int(np.prod(dims)))
    mesh = make_mesh(dims, axes, "cpu")
    ctx, cfg = _variant_ctx(make_ctx(mesh, cell, cfg), cfg, knobs)
    rec = {
        "arch": arch, "shape": shape,
        "mesh": "x".join(map(str, dims)),
        "n_devices": int(np.prod(dims)),
        "kind": cell.kind, "ok": False, "variant": variant,
    }
    depths = depths_for(cfg)
    mbs = [None]
    if cell.kind == "train":
        nmb = microbatches_for(cfg, cell, mesh, batch_axes=ctx.batch_axes)
        rec["microbatches"] = nmb
        mbs = [1, 2] if nmb > 2 else [nmb]
    t0 = time.time()
    rows, ys = [], []
    # a first run of the shallowest step, thrown away: DTensor infers each
    # op's output layout once, on fake tensors of the global shapes, which
    # the memory tracker would count as the step's
    first = cell if mbs[0] is None else dataclasses.replace(
        cell, global_batch=cell.global_batch // rec["microbatches"])
    _run_once(dataclasses.replace(cfg, n_layers=depths[0]), first, mesh,
              ctx, knobs, mbs[0] or 1)
    for d in depths:
        for m in mbs:
            c = cell if m is None else dataclasses.replace(
                cell, global_batch=cell.global_batch // rec["microbatches"]
                * m)
            ys.append(_run_once(dataclasses.replace(cfg, n_layers=d), c,
                                mesh, ctx, knobs, m or 1))
            f = _layer_counts(cfg, d)
            rows.append(f + ([m * x for x in f] if len(mbs) > 1 else []))
    rec["step_s"] = round(time.time() - t0, 2)
    rec["depths_run"], rec["microbatches_run"] = depths, mbs
    f = _layer_counts(cfg, cfg.n_layers)
    target = f + ([rec["microbatches"] * x for x in f] if len(mbs) > 1
                  else [])
    keys = sorted(set(k for y in ys for k in y))
    Y = np.array([[y.get(k, 0.0) for k in keys] for y in ys])
    W = np.linalg.solve(np.array(rows), Y)
    flat = dict(zip(keys, np.array(target) @ W))
    # the memory peak: linear in the layer counts, at the last M run
    last = [i for i, r in enumerate(rows) if len(mbs) == 1 or
            i % len(mbs) == len(mbs) - 1]
    mem_keys = [k for k in keys if k.startswith("memory/")]
    Wm = np.linalg.solve(np.array([rows[i][:len(f)] for i in last]),
                         np.array([[ys[i].get(k, 0.0) for k in mem_keys]
                                   for i in last]))
    flat.update(zip(mem_keys, np.array(f) @ Wm))
    rec["cost"], rec["memory"] = _unflat(flat)
    rec["cost"]["num_partitions"] = rec["n_devices"]
    rec["model_flops"] = model_flops_for(cfg, cell)
    rec["param_bytes_per_device"] = analytic_param_bytes(
        abstract_params(build_model(cfg, ctx)), cfg, ctx)
    rec["n_params"] = cfg.n_params()
    rec["n_active_params"] = cfg.n_active_params()
    rec["ok"] = True
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default=None,
                    help="a small mesh in place of the production one, "
                         "e.g. 2x2 or 2x2x2")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced() config")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ART))
    ap.add_argument("--variant", default="")
    for k in KNOBS:
        ap.add_argument(f"--{k}", action="store_true")
    args = ap.parse_args(argv)
    knobs = {k: getattr(args, k) for k in KNOBS}

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = []
    archs = ASSIGNED_ARCHS if args.all or not args.arch else [args.arch]
    for arch in archs:
        shapes = [c.name for c in get_config(arch).shape_cells()]
        if args.shape:
            shapes = [s for s in shapes if s == args.shape]
        for s in shapes:
            if args.mesh in ("single", "both"):
                cells.append((arch, s, False))
            if args.mesh in ("multi", "both"):
                cells.append((arch, s, True))
    if len(cells) != 1:
        # one fake group a process: run each cell in a process of its own
        return _run_each(cells, argv)

    arch, shape, mp = cells[0]
    suffix = f"__{args.variant}" if args.variant else ""
    tag = f"{arch}__{shape}__{'multi' if mp else 'single'}{suffix}"
    try:
        rec = run_cell(arch, shape, mp, mesh_shape=args.mesh_shape,
                       reduced=args.reduced, knobs=knobs,
                       variant=args.variant)
    except Exception as e:
        rec = {"arch": arch, "shape": shape,
               "mesh": "x".join(map(str, mesh_dims(mp, args.mesh_shape)[0])),
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    (out_dir / (tag + ".json")).write_text(json.dumps(rec, indent=1))
    if rec.get("ok"):
        print(f"[OK] {tag} step={rec['step_s']}s "
              f"flops={rec['cost']['flops']:.3e}", flush=True)
    else:
        print(f"[FAIL] {tag}: {rec.get('error', '')[:200]}", flush=True)
    print(f"dry-run: {int(bool(rec.get('ok')))}/1 cells OK")
    return 0 if rec.get("ok") else 1


def _run_each(cells, argv) -> int:
    """Each cell in a child process of its own."""
    import subprocess
    import sys
    base = [a for a in (argv if argv is not None else sys.argv[1:])
            if a != "--all"]
    base = _drop_opt(_drop_opt(_drop_opt(base, "--arch"), "--shape"),
                     "--mesh")
    n_ok = 0
    for arch, shape, mp in cells:
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            *base, "--arch", arch, "--shape", shape,
                            "--mesh", "multi" if mp else "single"])
        n_ok += r.returncode == 0
    print(f"dry-run: {n_ok}/{len(cells)} cells OK")
    return 0 if n_ok == len(cells) else 1


def _drop_opt(args, name):
    out, skip = [], False
    for a in args:
        if skip:
            skip = False
            continue
        if a == name:
            skip = True
            continue
        if a.startswith(name + "="):
            continue
        out.append(a)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
