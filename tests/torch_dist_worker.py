"""The ranks of ``tests/test_torch_dist.py``: every case of the multi-rank
parity tests, run by 4 gloo ranks on a (2, 2) ("data", "model") mesh.
This module imports only the port (and numpy); the test file builds the
inputs and the reference with the JAX package."""
import dataclasses
import os
import pickle
import traceback

import numpy as np
import torch

ARCHS = ("llama3.2-3b", "qwen3-moe-235b-a22b", "xlstm-1.3b")
MBS = (1, 2)
S = 8
LR = 1e-3
ATTN_CASES = [(True, 0, 33), (True, 7, 40), (False, 0, 24), (True, 12, 64)]
MOE_CASES = [(m, ws) for m in ("ep", "tp") for ws in (False, True)]


def small(cfg):
    """A reduced config in float32 with 2 layers, its gradients accumulated
    in float32 as ``_local_step`` accumulates them (qwen3-moe's
    ``optimizer_dtype`` is bf16); MoE with a capacity that drops no token,
    so that the capacity dispatch computes the dense ``moe_ref`` the
    unsharded step runs. ``cfg`` is either package's."""
    cfg = dataclasses.replace(cfg.reduced(), dtype="float32",
                              param_dtype="float32", n_layers=2,
                              optimizer_dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


def batch_rows(n_mb):
    return 4 * n_mb          # microbatches of 4 rows


def _port_cfg(arch):
    from repro_torch.configs.base import get_config
    return get_config(arch)


def _np(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _case_train(mesh, inp, out):
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import (_grads, build_train_step,
                                          make_ctx, place)
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.specs import param_shardings
    from repro_torch.train.loop import _local_step, batch_to_device
    from repro_torch.train.optimizer import AdamW, tree_leaves

    for arch in ARCHS:
        cfg = small(_port_cfg(arch))
        ctx = make_ctx(mesh, None, cfg)
        for n_mb in MBS:
            opt = AdamW(lr=LR, warmup=2, total_steps=3)
            p = params_from_numpy(inp["params"][arch], cfg, device="cpu")
            p = place(p, param_shardings(p, cfg, ctx))
            s = opt.init(p)
            # the unsharded trajectory, for the conditioning mask only
            local = params_from_numpy(inp["params"][arch], cfg,
                                      device="cpu")
            s_loc = opt.init(local)
            local_step = _local_step(build_model(cfg), opt, n_mb)
            step = build_train_step(build_model(cfg, ctx), ctx, opt, n_mb)
            rec = {"loss": [], "gnorm": [], "tiny": None}
            for i in range(2):
                b = batch_to_device(inp["batches"][arch, n_mb][i], "cpu")
                _, g = _grads(build_model(cfg), local, tree_leaves(local), b)
                tiny = [np.abs(x.numpy()) < 1e-6 for x in g]
                rec["tiny"] = tiny if rec["tiny"] is None else \
                    [a | c for a, c in zip(rec["tiny"], tiny)]
                local, s_loc, _ = local_step(local, s_loc, b)
                p, s, m = step(p, s, place(b, ctx.batch_spec(b)))
                rec["loss"].append(float(m["loss"]))
                rec["gnorm"].append(float(m["grad_norm"]))
            rec["params"] = [_np(x) for x in tree_leaves(p)]
            out[f"train/{arch}/{n_mb}"] = rec


def _case_moe(mesh, inp, out):
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.steps import make_ctx, place
    from repro_torch.models import moe as moe_mod
    from repro_torch.sharding.specs import NamedSharding, P, param_shardings

    base = _port_cfg("qwen3-moe-235b-a22b").reduced()
    for mode, ws in MOE_CASES:
        mcfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=16,
                         capacity_factor=4.0, parallel_mode=mode)
        cfg = dataclasses.replace(base, d_model=8, moe=mcfg)
        ctx = make_ctx(mesh, None, cfg)
        p = {k: torch.tensor(v) for k, v in inp["moe_params"][mode].items()}
        p = place({"moe": p}, param_shardings({"moe": p}, cfg, ctx))["moe"]
        x = torch.tensor(inp["moe_x"])
        x = place(x, NamedSharding(mesh, P("data", None, None)))
        y = moe_mod.moe_forward(p, x, cfg=mcfg, act="swiglu", mesh=mesh,
                                batch_axes=("data",), weight_stationary=ws)
        assert isinstance(y, DTensor)
        out[f"moe/{mode}/{ws}"] = _np(y)


def _case_slstm(mesh, inp, out):
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.steps import place
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.sharding.specs import NamedSharding, P

    rep = NamedSharding(mesh, P())
    p = {k: place(torch.tensor(v), rep).requires_grad_(True)
         for k, v in inp["slstm_params"].items()}
    x = place(torch.tensor(inp["slstm_x"]),
              NamedSharding(mesh, P("data", None, None)))
    y = xlstm_mod.slstm_forward_sharded(p, x, n_heads=2, mesh=mesh,
                                        batch_axes=("data",))
    loss = (y ** 2).sum()
    with CommDebugMode() as comm:
        g = torch.autograd.grad(loss, list(p.values()))
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    out["slstm"] = {"loss": float(loss.full_tensor()),
                    "grads": {k: _np(v) for k, v in zip(p, g)},
                    "comms": counts}


def _case_attention(mesh, inp, out):
    from repro_torch.launch.steps import make_ctx, place
    from repro_torch.models import attention as attn
    from repro_torch.sharding.specs import NamedSharding, P, \
        implicit_replication

    ctx = make_ctx(mesh, None, _port_cfg("llama3.2-3b").reduced())
    b5 = NamedSharding(mesh, P("data", None, None, None, None))
    b4 = NamedSharding(mesh, P("data", None, None, None))
    with implicit_replication():
        for causal, window, S_ in ATTN_CASES:
            q, k, v = (torch.tensor(a) for a in inp["attn", S_, window])
            o = attn.qblock_attention(
                place(q, b5), place(k, b4), place(v, b4), causal=causal,
                window=window, block_q=8, block_kv=8,
                shard_blocks=ctx.act_qblocks)
            out[f"qblock/{causal}/{window}/{S_}"] = _np(o)
        p = {n: torch.tensor(a) for n, a in inp["attn_w"].items()}
        x = place(torch.tensor(inp["attn_x"]),
                  NamedSharding(mesh, P("data", None, None)))
        o, _ = attn.attn_forward(p, x, n_heads=6, n_kv_heads=2, head_dim=8,
                                 rope_theta=10000.0, window=0, block_q=8,
                                 block_kv=8, shard=ctx.act_kv,
                                 layout="expand")
        out["expand"] = _np(o)


def _case_compress(mesh, inp, out, rank):
    from repro_torch.train import grad_compress as gc
    g = {k: torch.tensor(v) for k, v in inp["gc"][rank].items()}
    st = gc.init(g)
    res = []
    for _ in range(2):          # the second call carries the residual
        m, st = gc.allreduce_compressed(g, st, mesh, "data")
        res.append({k: v.numpy() for k, v in m.items()})
    out[f"gc/{rank}"] = res


def _case_restore(mesh, inp, out, tmp):
    import torch.distributed as dist
    from repro_torch.checkpoint import store
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_ctx, place
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.specs import param_shardings
    from repro_torch.train.optimizer import tree_leaves

    cfg = small(_port_cfg("llama3.2-3b"))
    p = build_model(cfg).init(torch.Generator().manual_seed(3),
                              device="cpu")
    p22 = place(p, param_shardings(p, cfg, make_ctx(mesh, None, cfg)))
    store.save(f"{tmp}/ckpt", 1, {"params": p22})
    dist.barrier()
    mesh41 = make_mesh((4, 1), ("data", "model"), "cpu")
    sh41 = param_shardings(p, cfg, make_ctx(mesh41, None, cfg))
    r = store.restore(f"{tmp}/ckpt", 1, {"params": p22},
                      {"params": sh41})["params"]
    want = [s.placements for s in tree_leaves(sh41)]
    out["restore"] = {
        "placed": all(t.device_mesh == mesh41 and list(t.placements) == w
                      for t, w in zip(tree_leaves(r), want)),
        "equal": all(torch.equal(t.full_tensor(), o)
                     for t, o in zip(tree_leaves(r), tree_leaves(p)))}


def _case_serve(mesh, out):
    from repro_torch.serve import EngineGroup, LMServer
    from repro_torch.serve.loadgen import OpenLoopGen, SyntheticWorkload
    from repro_torch.sharding.specs import replica_device_groups

    groups = replica_device_groups(mesh, axis="data")
    try:
        replica_device_groups(mesh, axis="pod")
        raised = False
    except ValueError as e:
        raised = "axis" in str(e)
    server = LMServer(_port_cfg("llama3.2-3b").reduced(), device="cpu",
                      max_seq=48)
    group = EngineGroup.from_mesh(server, mesh, axis="data")
    workload = SyntheticWorkload(vocab=server.cfg.vocab, prompt_len=6,
                                 max_new_tokens=3, seed=1)
    reqs = OpenLoopGen(workload, qps=200.0, n=10, seed=7).requests()
    batches = server.form_batches(reqs, target_batch=4, deadline=0.01)
    sync = {c.rid: c.tokens for rs in batches
            for c in server.generate_batch(rs)}
    sharded = {c.rid: c.tokens for c in group.run_groups(batches)}
    out["serve"] = {
        "groups": [len(g) for g in groups], "raised": raised,
        "replicas": len(group.replicas),
        "equal": sorted(sync) == sorted(sharded) and all(
            np.array_equal(sync[r], sharded[r]) for r in sync)}


def worker(rank, tmp):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh

    # one thread each, and below the other tests' processes in priority:
    # the suite's timing tests share the machine's cores with these ranks
    torch.set_num_threads(1)
    os.nice(10)
    init_distributed("cpu", world_size=4, rank=rank,
                     init_method=f"file://{tmp}/store", timeout_s=120)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    with open(f"{tmp}/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = {}
    cases = [("train", lambda: _case_train(mesh, inp, out)),
             ("moe", lambda: _case_moe(mesh, inp, out)),
             ("slstm", lambda: _case_slstm(mesh, inp, out)),
             ("attention", lambda: _case_attention(mesh, inp, out)),
             ("compress", lambda: _case_compress(mesh, inp, out, rank)),
             ("restore", lambda: _case_restore(mesh, inp, out, tmp))]
    for name, fn in cases:
        try:
            fn()
        except Exception:
            out[f"error/{name}"] = traceback.format_exc()
        dist.barrier()
    if rank == 0:
        try:
            _case_serve(mesh, out)
        except Exception:
            out["error/serve"] = traceback.format_exc()
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
