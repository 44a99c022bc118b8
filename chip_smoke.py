#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: name, count and `nvidia-smi` name + power limit;
  2. build: compile the rule-match kernel for sm_90a from the checkout and
     print ptxas's registers, spills and static shared memory per instance;
  3. kernel against its plain PyTorch versions, exact int32 equality, on
     random tables up to (B, R, C) = (4096, 160256, 31) through the Pallas
     signature (packing on the fly), a tie-break case, a no-match case,
     n_engines = 1, 2, 4, and the packed entry with a sorted batch at ragged
     R and B and C = 1..64;
  4. main path at the paper's scale: 160k v2 rules -> compile_rules ->
     ErbiumEngine (table packed once at upload) -> 16 user queries batched
     by paper_policy through MCTWrapper(n_workers=2), checked against the
     plain version on the card, cpu_match_numpy and the partitioned engine,
     plus one hot reload;
  5. kernel time (CUDA events) at 160k rules and B = 256, 1024, 4096: the
     main path's lane (sort, kernel, unsort) and its parts, the plain
     versions, the work the data needs in the compiler's and the kernel's
     criterion order, and the least time the card could take;
  6. the route scorer: LMServer on the full-width llama3.2-3b in bf16, its
     MCT filter on phase 4's engine, serving 16 requests in deadline-formed
     batches; checks (a) the dropped requests against cpu_match_numpy's
     decisions, (b) token counts and truncation, (c) prefill against
     token-by-token decode in bf16, (d) a 2-layer float32 copy on the card
     against the CPU; per-batch times, and one decode step's time and
     top device operations (torch.profiler);
  7. the paper's deployment analysis from this card's numbers, through
     benchmarks/torch_fig6_overheads.py, torch_fig7_10_parallel.py,
     torch_fig11_pareto.py and torch_table2_3_cost.py on phase 4's rule set
     and engine: fig 6's stage split at B = 64 to 8192, stage times at
     B = 256, 1024, 4096, the fig 7-10 series and the fig 11 Pareto front,
     tables 2 and 3 (table 2 within 3% of the paper), and the H100 cost
     balance from the measured host and card rates;
  8. the serving stack (repro_torch.serve): build() with two colocated
     replicas of the full-width llama3.2-3b behind phase 4's engine, cache
     and trace on; phase 6's requests served in sync mode, then pipelined
     through the replica threads, then again with fresh rids, then with new
     prompts live through a session; checks (e)
     pipelined tokens equal sync tokens, (f) the dropped set against
     cpu_match_numpy's decisions, (g) the cache's accounting and a second
     wave of hits, (h) one rule-match launch a filtered batch, from the
     replica threads, none for cache hits, (i) the trace against the run
     report; qps, latency by stage, per-replica device busy and idle, the
     BottleneckMonitor's class;
  9. the other model families at full width, one at a time through
     LMServer behind phase 4's engine: hymba-1.5b (hybrid), xlstm-1.3b
     (ssm), llama-3.2-vision-11b (vlm), gemma3-1b (dense, 5:1 local) and
     qwen3-moe-235b-a22b (moe, 4 of 94 layers), bf16 weights drawn on the
     card from seed 0; 8 of phase 6's requests each with 4 new tokens,
     checks (j) the dropped set against cpu_match_numpy's, (k) prefill
     against token-by-token decode, (l) the reduced float32 copy, card
     against CPU; one decode step at B = 8 timed, profiled and held against
     its bound by bytes; then one full-width forward of the encoder-only
     hubert-xlarge;
 10. training (repro_torch.train.loop.fit) on the full-width, full-depth
     llama3.2-3b: bf16 parameters drawn on the card from seed 0, float32
     AdamW moments updated in place, remat "dots", batches of 8 x 256 from
     the synthetic pipeline, 6 steps; step time, tokens/s, peak memory,
     launches and device busy share of one step (torch.profiler), the top
     device operations, the fwd/bwd and optimizer times, and the step's
     bound; checks (m) finite losses and grad norms, three steps on one
     repeated batch lower the loss, (n) a reduced float32 copy trained 3
     steps on the card and on the CPU agrees (TF32 off), (o) 2 steps, an
     AsyncCheckpointer save and a resume for 2 more equal 4 uninterrupted
     steps, the restored tensors equal to the saved ones bit for bit,
     (p) one full-width step at microbatches=2 has the first loss of
     microbatches=1 within 5e-2;
 11. sharding and launch (repro_torch.sharding, repro_torch.launch) on an
     NCCL group of one rank and a (1, 1) ("data", "model") mesh of the
     card, while the dry run runs in two processes of its own (the fake
     backend cannot share a process with NCCL): (q) fit(ctx=make_ctx(...))
     on phase 10's full-width llama3.2-3b, settings and batches, losses
     equal to phase 10's within 5e-2, step time, tokens/s, peak memory,
     launches and busy share of one step beside phase 10's, and one step at
     microbatches=2 through build_train_step; (r) shard_prefill and
     shard_decode on llama3.2-3b at B = 8, pos 40 against the unsharded
     prefill and decode_step (within phase 6's 5% of the largest logit),
     step time and launches beside phase 6's, and one qwen3-moe-235b-a22b
     decode step (phase 9's 4 layers) through moe_forward under the
     context, weight-stationary off and on, equal to each other; (s)
     build(ServeConfig(mesh=...)) at full width behind phase 4's engine:
     phase 6's requests give the sync baseline's tokens and drops through
     the mesh's replica; (t) the dry run of llama3.2-3b train_4k on 16x16
     and qwen3-moe-235b-a22b decode_32k on 2x16x16: each record ok, its
     per-device parameter bytes, FLOPs, collectives and roofline terms;
 12. the paper's figures on the card through benchmarks/torch_*.py: fig 4
     (queries/s against B = 256..8192, v1 and v2 at 160k rules, 1/2/4
     engines; 20 calls a point, with quartiles), fig 12 (cpu_match_numpy against the partitioned and the
     CUDA-kernel paths per user query, with the crossovers), fig 13's
     open-loop load sweep (each point's batch sizes; one more 4x point
     with 512 requests) and sync/pipelined inset on the full-width
     llama3.2-3b, and the roofline table over phase 11's two records;
     checks (u) every fig 4 point equals the plain version on the card and
     does not depend on n_engines, (v) fig 12's three paths agree and the
     kernel launches once a paper_policy batch, (w) the inset's pipelined
     tokens equal sync, (x) every suite ran and build/torch_bench.json has
     the reference's row names (h100_balance for tpu_balance).
It then prints JSON lines for phases 7, 6, 8, 9, 10, 11 and 12 and the
kernels and, last, the device line.
Nothing runs without a card: the port's CPU paths are the tests' business.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))    # the figure harnesses

N_RULES = 160_000
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/rule_match.cu"
REPLACES = "src/repro/kernels/rule_match.py:53"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT32_LANES_PER_SM = 64            # Hopper SM: 64 INT32 units, one op a clock
TIMED_BATCHES = (256, 1024, 4096)   # the summary line reports 1024
LANE_TURNS = 4                      # lane timings, 20 calls each
ARCH = "llama3.2-3b"                # the route scorer, at full width
LM_MAX_SEQ = 256
LM_REQUESTS = 16
LM_NEW_TOKENS = 8
# check (c): bf16 prefill against bf16 token-by-token decode; the two round
# to bf16 at other places (p @ v in fp32 against p rounded to bf16 first),
# about 1.1-1.2% of the largest logit at 4-8 layers and d_model 256-1024
BF16_REL_TOL = 0.05
# check (d): float32, TF32 off, card against CPU: another summation order
# over products of up to 8,192 terms and a 128,256-wide vocabulary
F32_TOL = 1e-3                      # atol = rtol
# phases 7 and 12: the paper's figures through benchmarks/torch_*.py, on
# generate_queries(seed 43) queries as the reference's harnesses; stage
# times for figs 7-11 are medians of 3 (the harness's default is 2)
FIG_QUERIES = 8_192
STAGE_REPEATS = 3
# phase 12 (figs 4, 12, 13 and the roofline). One cut of the harnesses'
# defaults, for the script's time: fig 12 runs the first 7 of its 10 user
# queries (1,844 of 3,271 MCT queries; the workload's first k user queries
# do not depend on k, and the 7th checks 402, above the paper's ~400).
# cpu_match_numpy scans 160k rules at ~17 ms a query: all 10 took 63 s of
# phase 12's 124 s on the card's machine
FIG12_USERS = 7
# fig 4 times a point as the median of 20 calls (the harness's default is
# the reference's 3): a call of 0.2-1 ms on the host's clock varies by up
# to 2x between runs. Fig 13 adds one 4x point of 512 requests to its
# sweep of 64 a point, a window in which the first and last batches weigh
# little
FIG4_REPEATS = 20
FIG13_LONG_N = 512
# phase 9: every other decoder family at full width behind the same filter,
# 8 of phase 6's requests a model with 4 new tokens; the one depth cut is
# qwen3's (94 layers would take 470 GB in bf16)
FAMILY_MODELS = (("hymba-1.5b", None), ("xlstm-1.3b", None),
                 ("llama-3.2-vision-11b", None), ("gemma3-1b", None),
                 ("qwen3-moe-235b-a22b", 4))
FAMILY_REQUESTS = 8
FAMILY_NEW_TOKENS = 4
FAMILY_MAX_SEQ = 128
FAMILY_STEP_POS = 40
# check (k) for xLSTM runs on a float32 copy: its chunkwise prefill and its
# recurrent steps drift apart in bf16 with depth, in the JAX package as in
# the port (about 9% of the largest logit at 16 layers, 38% at 48), while
# the float32 forms agree; its bf16 ratio is printed, not gated
F32_PREFILL_ARCHS = ("xlstm-1.3b",)
F32_PREFILL_REL_TOL = 1e-3
# check (l): the reduced float32 copy, card against CPU, TF32 off
FAMILY_F32_TOL = 1e-4               # atol = rtol
ENCODER_ARCH = "hubert-xlarge"      # encoder-only: one forward, no server
ENCODER_BATCH, ENCODER_SEQ = 2, 256
# phase 10: training at full width; (n) and (o) on the reduced float32 copy
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 6
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
BF16_FLOP_PER_S = 989e12            # H100 SXM data sheet, dense
F32_FLOP_PER_S = 67e12              # float32 outside the tensor cores
# check (n): float32, TF32 off, card against CPU over 3 steps: losses and
# grad norms within 1e-4; parameters within 1e-5 where the CPU's first
# gradient is at least 1e-6 in size (Adam's m / (sqrt(v) + eps) of a
# gradient within rounding of zero is ill-conditioned), and everywhere
# within the most 3 steps can move them, 2 * lr a step
TRAIN_F32_TOL = 1e-4
TRAIN_F32_PARAM_TOL = 1e-5
TRAIN_RESUME_RTOL = 1e-4            # check (o)
TRAIN_MB_TOL = 5e-2                 # check (p), tests/test_train_loop.py
TRAIN_CKPT_DIR = ROOT / "build" / "chip_smoke_train_ckpt"
# phase 11: the sharded paths on a (1, 1) mesh of the card; the dry run's
# two production cells, each in a process of its own
MESH_MOE_ARCH, MESH_MOE_LAYERS = "qwen3-moe-235b-a22b", 4
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", "single"),
                ("qwen3-moe-235b-a22b", "decode_32k", "multi"))
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT_S = 600
# phase 8: the second wave's rids and logical arrivals follow the first's;
# a filtered content stays remembered for a minute of logical time
SERVE_WAVE_RID = 1000
SERVE_WAVE_GAP_S = 1.0
SERVE_NEGATIVE_TTL = 60.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def random_tables(rng, B, R, C, weight_max=100):
    """The JAX package's kernel-test generator: half the criteria wildcards."""
    import numpy as np
    q = rng.integers(0, 50, (B, C)).astype(np.int32)
    mins = rng.integers(0, 50, (R, C)).astype(np.int32)
    maxs = mins + rng.integers(0, 30, (R, C)).astype(np.int32)
    wild = rng.random((R, C)) < 0.5
    mins = np.where(wild, 0, mins).astype(np.int32)
    maxs = np.where(wild, np.iinfo(np.int32).max - 1, maxs).astype(np.int32)
    w = rng.integers(0, weight_max, (R,)).astype(np.int32)
    return q, mins, maxs, w


def err_of(got, want) -> int:
    """Largest absolute difference over paired int32 tensors (0 == exact)."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def phase_kernel_vs_plain(dev) -> int:
    """Kernel against plain version on the card; returns the largest error."""
    import numpy as np
    import torch
    from types import SimpleNamespace
    from repro_torch.device import synchronize
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rule_match_ref
    from repro_torch.kernels.rule_match import rule_match

    def put(a):
        return torch.as_tensor(a, device=dev)

    worst = 0
    cases = [(64, 128, 8, 64, 128), (512, 1024, 26, 256, 512),
             (4096, 160256, 31, 256, 512)]
    for B, R, C, tb, tr in cases:
        q, mins, maxs, w = (put(a) for a in random_tables(
            np.random.default_rng(B + R + C), B, R, C))
        got = rule_match(q.T.contiguous(), mins.T.contiguous(),
                         maxs.T.contiguous(), w[None], tile_b=tb, tile_r=tr)
        want = rule_match_ref(q, mins, maxs, w)
        synchronize(dev)
        e = err_of((got[0][0], got[1][0]), want)
        hit = float((want[1] >= 0).float().mean())
        print(f"kernel vs plain (B, R, C) = ({B}, {R}, {C}): max_abs_err {e}, "
              f"matched share {hit:.4f}")
        worst = max(worst, e)

    # identical rules across rule tiles: index 0 must win everywhere
    C = 4
    q = put(np.zeros((8, C), np.int32))
    mins = put(np.zeros((256, C), np.int32))
    maxs = put(np.full((256, C), 10, np.int32))
    w = put(np.full((256,), 7, np.int32))
    bw, bi = rule_match(q.T.contiguous(), mins.T.contiguous(),
                        maxs.T.contiguous(), w[None], tile_b=8, tile_r=64)
    if not (bool((bi == 0).all()) and bool((bw == 7).all())):
        fail(f"tie-break: got w={bw.tolist()} i={bi.tolist()}")
    worst = max(worst, err_of((bw[0], bi[0]), rule_match_ref(q, mins, maxs, w)))

    # nothing matches: (-1, -1)
    C = 3
    q = put(np.full((16, C), 100, np.int32))
    mins = put(np.zeros((64, C), np.int32))
    maxs = put(np.full((64, C), 5, np.int32))
    w = put(np.full((64,), 3, np.int32))
    bw, bi = rule_match(q.T.contiguous(), mins.T.contiguous(),
                        maxs.T.contiguous(), w[None], tile_b=16, tile_r=64)
    if not (bool((bw == -1).all()) and bool((bi == -1).all())):
        fail(f"no-match: got w={bw.tolist()} i={bi.tolist()}")
    print("kernel tie-break and no-match cases: ok")

    # engine lanes: the split of the batch changes nothing
    rng = np.random.default_rng(7)
    qn, mn, mx, wn = random_tables(rng, 1000, 20_000, 31)
    table = SimpleNamespace(
        mins=mn, maxs=mx, weights=wn, n_rules=len(wn),
        decisions=rng.integers(20, 120, len(wn)).astype(np.int32),
        rule_ids=np.arange(len(wn), dtype=np.int32))
    dt = ops.device_table(table, tile_r=512, device=dev)
    qd = put(qn)
    want = ops.match_rules(qd, dt, backend="ref")
    for n_eng in (1, 2, 4):
        got = ops.match_rules(qd, dt, n_engines=n_eng)
        e = err_of(got, want)
        print(f"match_rules n_engines={n_eng}: max_abs_err {e}")
        worst = max(worst, e)
    synchronize(dev)
    return max(worst, phase_packed_vs_plain(dev))


# (B, R, C) of the packed-entry checks: the random shapes above, R that the
# 64-rule stage does not divide (999 is padded to 1000 by pack), ragged B,
# a batch too large for the launch's own sort, and every criterion-count
# instance of the kernel
PACKED_CASES = ([(64, 128, 8), (512, 1024, 26), (4096, 160256, 31),
                 (300, 1000, 31), (256, 4102, 31), (77, 999, 13),
                 (9000, 3000, 31)]   # above SORT_MAX: argsort sorts
                + [(512, 3000, C) for C in (1, 8, 31, 32, 33, 64)])


def phase_packed_vs_plain(dev) -> int:
    """The packed entry, batch sorted by the leading criterion, against the
    packed plain version and rule_match_ref; returns the largest error."""
    import numpy as np
    import torch
    from repro_torch.device import synchronize
    from repro_torch.kernels import rule_match as rm
    from repro_torch.kernels.ref import rule_match_packed_ref, rule_match_ref

    worst = 0
    for B, R, C in PACKED_CASES:
        q, mins, maxs, w = (torch.as_tensor(a, device=dev) for a in
                            random_tables(np.random.default_rng(B + R + C),
                                          B, R, C))
        crit = rm.criterion_order(mins.T, maxs.T)
        bounds, wk = rm.pack(mins.T, maxs.T, w, crit)
        lead = int(crit[0])
        order = torch.argsort(q[:, lead])
        want = rule_match_packed_ref(q, bounds, wk, crit)
        e_ref = err_of(want, rule_match_ref(q, mins, maxs, w))
        errs = [e_ref]
        for kw in (dict(sort_col=lead), dict(order=order)):
            got = rm.rule_match_packed(q, bounds, wk, crit, **kw)
            synchronize(dev)
            errs.append(err_of(got, want))
        e = max(errs)
        print(f"packed kernel vs plain (B, R, C) = ({B}, {R}, {C}), sorted "
              f"in the launch and by argsort: max_abs_err {e}")
        worst = max(worst, e)
    return worst


def pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def phase_main_path(dev, n_rules: int, n_users: int, n_check: int):
    """Paper-scale MCT main path through MCTWrapper; returns what phase 5
    and the summary need."""
    import numpy as np
    import torch
    from repro_torch.core.aggregator import batch_stats, paper_policy
    from repro_torch.core.compiler import compile_rules
    from repro_torch.core.encoder import queries_to_arrays
    from repro_torch.core.engine import ErbiumEngine, cpu_match_numpy
    from repro_torch.core.rules import generate_rules
    from repro_torch.core.workload import generate_workload, workload_stats
    from repro_torch.core.wrapper import MCTWrapper
    from repro_torch.device import synchronize
    from repro_torch.kernels import ops
    from repro_torch.kernels.rule_match import rule_match

    packs = []
    pack = ops.pack

    def counted_pack(*a, **k):
        packs.append(1)
        return pack(*a, **k)
    ops.pack = counted_pack         # the table is packed at upload only

    t0 = time.perf_counter()
    ruleset = generate_rules(n_rules, version=2, seed=42)
    t1 = time.perf_counter()
    table = compile_rules(ruleset)
    t2 = time.perf_counter()
    engine = ErbiumEngine(table, device=dev)
    ref_engine = ErbiumEngine(table, device=dev, backend="ref")
    synchronize(dev)
    t3 = time.perf_counter()
    print(f"rules: {n_rules} v2 -> table R={table.n_rules} C={table.n_cols} "
          f"({(table.mins.nbytes + table.maxs.nbytes) / 1e6:.1f} MB of bounds);"
          f" generate {t1 - t0:.1f} s, compile {t2 - t1:.1f} s, "
          f"upload {t3 - t2:.2f} s")

    wl = generate_workload(ruleset, n_users, seed=3)
    batches = [b for uq in wl for b in paper_policy(uq)]
    encs = [engine.encode(queries_to_arrays(b.queries)) for b in batches]
    print(f"workload: {workload_stats(wl)}")
    print(f"batches: {batch_stats(batches)}")
    engine.match(encs[0])                 # first launch loads the module
    synchronize(dev)

    n_packs = len(packs)
    rule_match.launches = 0
    wrap = MCTWrapper([engine], n_workers=2)
    wrap.start()
    t0 = time.perf_counter()
    for b in batches:
        wrap.submit(b)
    results = wrap.drain(len(batches), timeout=300)
    wall = time.perf_counter() - t0
    wrap.stop()
    launches = rule_match.launches
    n_q = sum(len(r.decisions) for r in results)
    print(f"main path: {n_q} queries in {len(batches)} batches, {wall:.4f} s "
          f"-> {n_q / wall:.1f} queries/s (2 workers); kernel launches "
          f"{launches}")
    if launches <= 0 or launches != len(batches):
        fail(f"kernel launches {launches} != batches {len(batches)}")
    if len(packs) != n_packs:
        fail(f"the table was packed {len(packs) - n_packs} times on the "
             "main path; it is packed once, at upload")
    print(f"packed tables: {n_packs} at upload (dense + plain engines), "
          "0 on the main path")

    # every result equals the plain version's on one batch of its user query
    # and size (results come back in completion order)
    pending = {}
    for b, enc in zip(batches, encs):
        d, w, r = (x.cpu().numpy() for x in ref_engine.match(enc))
        pending.setdefault((b.uid, len(b.queries)), []).append((d, w, r))
    for res in results:
        cands = pending.get((res.uid, len(res.decisions)), [])
        hit = next((i for i, (d, w, r) in enumerate(cands)
                    if np.array_equal(d, res.decisions)
                    and np.array_equal(w, res.weights)
                    and np.array_equal(r, res.rule_ids)), None)
        if hit is None:
            fail(f"MCTWrapper result for uid {res.uid} (batch of "
                 f"{len(res.decisions)}) differs from the plain version")
        cands.pop(hit)
    print(f"MCTWrapper vs plain version on the card: {len(results)} batches "
          "exact")

    all_enc = np.concatenate(encs)
    sub = all_enc[:n_check]
    got = [x.cpu().numpy() for x in engine.match(sub)]
    want = cpu_match_numpy(table, sub, block=128)
    for name, g, w in zip(("decision", "weight", "rule_id"), got, want):
        if not np.array_equal(g, w.astype(np.int32)):
            fail(f"kernel vs cpu_match_numpy: {name} differs")
    print(f"kernel vs cpu_match_numpy on {len(sub)} queries: exact "
          f"(matched share {float((got[1] >= 0).mean()):.4f})")

    part = ErbiumEngine(table, device=dev, partitioned=True)
    pgot = [x.cpu().numpy() for x in part.match(sub)]
    for name, g, w in zip(("decision", "weight", "rule_id"), pgot, got):
        if not np.array_equal(g, w):
            fail(f"partitioned vs dense engine: {name} differs")
    print(f"partitioned engine (Pmax={part.dt.part_w.shape[1]}, "
          f"NP={part.dt.part_w.shape[0]}) vs dense on {len(sub)} queries: "
          "exact")
    del part
    torch.cuda.empty_cache()

    buckets = {}
    for r in results:
        buckets.setdefault(pow2(r.times.batch), []).append(r.times)
    for size in sorted(buckets):
        ts = buckets[size]
        med = {k: float(np.median([getattr(t, k) for t in ts]))
               for k in ("queue_us", "encode_us", "dispatch_us", "kernel_us",
                         "collect_us")}
        print(f"stage medians, batch <= {size} ({len(ts)} batches): "
              + ", ".join(f"{k} {v:.1f}" for k, v in med.items()))

    n_packs = len(packs)
    us = engine.reload(ruleset)
    again = [x.cpu().numpy() for x in engine.match(sub)]
    if not all(np.array_equal(a, g) for a, g in zip(again, got)):
        fail("results changed across a reload of the same rule set")
    if len(packs) != n_packs + 1:
        fail(f"reload packed the table {len(packs) - n_packs} times, not once")
    ops.pack = pack
    print(f"reload: {us:.1f} us device swap (table packed once), results "
          "unchanged")
    queries = [q for b in batches for q in b.queries]
    return ruleset, engine, all_enc, queries, launches, n_q / wall


def count_work(q, mins, maxs, crit_order=None, groups=()):
    """int32 compares these inputs need with the criteria tested in
    ``crit_order`` (default: the compiler's column order). A criterion's
    test ``v < min || v > max`` is two compares, or one when the first is
    true. Returns (per_pair, shared, steps):

    - per_pair tests every (query, rule) pair on its own, up to its first
      failing criterion;
    - shared tests the leading criterion once per (distinct leading code of
      the batch, rule), since queries with one code pass or fail it
      together, and the other criteria, up to the first failing one, only
      for the pairs that pass the leading one: the least any mapping needs;
    - steps[g], for each group of g consecutive queries (a warp's 32 *
      queries a thread), sums over (group, rule) the criterion tests of the
      group's deepest query: a warp walks a rule until all its queries have
      failed."""
    import torch
    from repro_torch.kernels.ref import MAX_ELEMS
    if crit_order is not None:
        idx = crit_order.long()
        q, mins, maxs = q[:, idx], mins[:, idx], maxs[:, idx]
    B, C = q.shape
    R = mins.shape[0]
    chunk = max(1, MAX_ELEMS // (B * C))
    per_pair = shared = 0
    steps = dict.fromkeys(groups, 0)
    qb = q[:, None, :]
    for s in range(0, R, chunk):
        lo = qb >= mins[None, s:s + chunk]
        bad = ~(lo & (qb <= maxs[None, s:s + chunk]))
        first = bad.int().argmax(dim=-1)                    # (B, n)
        any_bad = bad.any(dim=-1)
        lo_first = lo.gather(-1, first[..., None])[..., 0]
        n = torch.where(any_bad, 2 * first + torch.where(lo_first, 2, 1),
                        2 * C)
        per_pair += int(n.sum(dtype=torch.int64))
        past_lead = ~any_bad | (first > 0)      # passed the leading test: 2
        shared += int(torch.where(past_lead, n - 2, 0).sum(dtype=torch.int64))
        depth = torch.where(any_bad, first + 1, C)
        for g in groups:
            steps[g] += int(depth.view(B // g, g, -1).amax(dim=1)
                            .sum(dtype=torch.int64))
    codes = torch.unique(q[:, 0])
    step = max(1, MAX_ELEMS // len(codes))
    for s in range(0, R, step):
        lo = codes[:, None] >= mins[None, s:s + step, 0]
        shared += int(torch.where(lo, 2, 1).sum(dtype=torch.int64))
    return per_pair, shared, steps


def cuda_ms(fn, reps: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_times(fn, reps: int = 10) -> dict:
    """Device time a call spends in each kernel (torch.profiler, CUPTI),
    and the wall time of the same calls, in ms a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"wall": wall * 1e3 / reps}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us and evt.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("rule_match_sort", "rule_match_runs",
                                     "rule_match_reduce") if k in evt.key),
                        "other")
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    out["device"] = sum(v for k, v in out.items() if k != "wall")
    return out


def phase_kernel_time(dev, engine, all_enc):
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rule_match as rm
    from repro_torch.kernels.ref import rule_match_packed_ref, rule_match_ref

    props = torch.cuda.get_device_properties(dev)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int32_per_s = props.multi_processor_count * INT32_LANES_PER_SM \
        * clock_mhz * 1e6
    dt = engine.dt
    C, Rp = dt.mins_t.shape
    Rk = dt.bounds.shape[1]
    mins, maxs, w = dt.mins_t.T, dt.maxs_t.T, dt.weights[0]
    crit = dt.crit_order
    lead = dt.lead_col
    print(f"kernel criterion order: {crit.tolist()}")
    rows = []
    for B in TIMED_BATCHES:
        enc = np.resize(all_enc, (B, C))
        q = torch.as_tensor(enc, device=dev)
        order = torch.argsort(q[:, lead])
        q_sorted = q[order].contiguous()

        def packed(qq):
            return lambda: rm.rule_match_packed(qq, dt.bounds, dt.weights_k,
                                                crit)
        runs = {   # "lane" is the main path's call: sort, kernel, unsort
            "lane": lambda: ops.match_lane(q, dt),
            "argsort": lambda: torch.argsort(q[:, lead]),
            "lane_argsort": lambda: rm.rule_match_packed(
                q, dt.bounds, dt.weights_k, crit, torch.argsort(q[:, lead])),
            "kernel_presorted": packed(q_sorted),
            "kernel_unsorted": packed(q),
        }
        plain = lambda: rule_match_ref(q, mins, maxs, w)
        plain_packed = lambda: rule_match_packed_ref(q, dt.bounds,
                                                     dt.weights_k, crit)
        want = plain()
        errs = {k: err_of(runs[k](), want) for k in
                ("lane", "lane_argsort", "kernel_unsorted")}
        errs["kernel_presorted"] = err_of(runs["kernel_presorted"](),
                                          (want[0][order], want[1][order]))
        errs["plain_packed"] = err_of(plain_packed(), want)
        err = max(errs.values())
        for f in runs.values():
            for _ in range(3):
                f()
        torch.cuda.synchronize(dev)
        lane_turns = []
        ms = {}
        for _ in range(LANE_TURNS):   # lane turns between the other runs
            lane_turns.append(cuda_ms(runs["lane"], 20))
            for k, f in runs.items():
                if k != "lane":
                    ms.setdefault(k, []).append(cuda_ms(f, 20))
        ms = {k: float(np.median(v)) for k, v in ms.items()}
        ms["lane_turns"] = lane_turns
        ms["plain"] = cuda_ms(plain, 3)
        ms["plain_packed"] = cuda_ms(plain_packed, 3)
        lane_ms = float(np.median(lane_turns))
        dev_ms = device_times(runs["lane"])
        per_pair_compiler, _, _ = count_work(q, mins, maxs)
        per_pair, shared, steps = count_work(q_sorted, mins, maxs, crit,
                                             groups=(32, 64))
        _, _, steps_unsorted = count_work(q, mins, maxs, crit,
                                          groups=(32, 64))
        pairs = B * Rp
        n_bytes = 8 * C * Rk + 4 * Rk + 4 * B * C + 8 * B
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = shared / int32_per_s * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        plan = rm.plan(dev, C, B, Rk)
        row = dict(B=B, R=Rp, C=C, ms=lane_ms, plain_ms=ms["plain"],
                   plain_packed_ms=ms["plain_packed"], bound_ms=bound_ms,
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   bytes=n_bytes, int32_compares=shared,
                   compares_per_pair=shared / pairs,
                   compares_per_pair_each_pair=per_pair / pairs,
                   compares_per_pair_compiler_order=per_pair_compiler / pairs,
                   distinct_lead_codes=int(torch.unique(q[:, lead]).numel()),
                   int32_ops_per_s=int32_per_s, max_abs_err=err,
                   warp_tests_per_pair={
                       "sorted_qpt1": steps[32] * 32 / pairs,
                       "sorted_qpt2": steps[64] * 32 / pairs,
                       "unsorted_qpt1": steps_unsorted[32] * 32 / pairs,
                       "unsorted_qpt2": steps_unsorted[64] * 32 / pairs},
                   times_ms=ms, device_ms=dev_ms, plan=plan)
        print(f"kernel time (B, R, C) = ({B}, {Rp}, {C}): lane (sort + "
              f"kernel + unsort, as the main path calls it) median "
              f"{lane_ms:.4f} ms of {LANE_TURNS} turns ("
              + " / ".join(f"{t:.4f}" for t in lane_turns)
              + f" ms); with torch.argsort for the sort "
              f"{ms['lane_argsort']:.4f} ms (argsort alone "
              f"{ms['argsort']:.4f} ms); presorted copy, no sort or unsort "
              f"{ms['kernel_presorted']:.4f} ms; unsorted batch "
              f"{ms['kernel_unsorted']:.4f} ms; plain (rule_match_ref) "
              f"{ms['plain']:.4f} ms; packed plain (rule_match_packed_ref) "
              f"{ms['plain_packed']:.4f} ms")
        print("  device time a lane call (torch.profiler): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms.items())
              + f"; device busy {dev_ms['device'] / dev_ms['wall']:.1%} of "
              "the wall time")
        print(f"  bound {bound_ms:.4f} ms by {row['bound_by']} (bytes "
              f"{bytes_ms:.4f} ms; int32 compares these inputs need "
              f"{ops_ms:.4f} ms: {shared} at {int32_per_s:.4g}/s, "
              f"{shared / pairs:.3f} a query-rule pair with the leading "
              f"criterion tested once per ({row['distinct_lead_codes']} "
              f"distinct leading codes) x rule; each pair on its own "
              f"{per_pair / pairs:.3f} a pair in kernel order, "
              f"{per_pair_compiler / pairs:.3f} in the compiler's order); "
              f"lane at {bound_ms / lane_ms:.1%} of it; max_abs_err {err}")
        print("  tests a warp executes per 32 pairs: "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          row["warp_tests_per_pair"].items()))
        print(f"  grid: {plan['n_runs']} rule runs of {plan['run']} x "
              f"{plan['n_btiles']} batch tiles of {plan['threads']} threads "
              f"({plan['qpt']} queries a thread), {plan['blocks_per_sm']} "
              f"blocks/SM on {plan['sms']} SMs, {plan['smem']} B dynamic "
              "shared memory a block")
        rows.append(row)
    return rows


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def top_device_ops(fn, n: int = 8):
    """Device time (torch.profiler) of one call of ``fn``: the n operators
    and the n kernels with the most, as (name, ms, calls), the total, and
    the number of kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, kernels = [], []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if not us:
            continue
        row = (evt.key, us / 1e3, evt.count)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append(row)
        else:
            ops.append(row)
    total = sum(r[1] for r in kernels)
    launches = sum(r[2] for r in kernels)
    by_time = lambda rows: sorted(rows, key=lambda r: -r[1])[:n]  # noqa
    return by_time(ops), by_time(kernels), total, launches


def scorer_requests(engine, queries, vocab: int):
    """Phase 6's requests: LM_REQUESTS of 16-48 prompt tokens and
    LM_NEW_TOKENS new ones, 2-6 MCT queries each from phase 4's workload,
    arrivals 2 ms apart. Connect times come from the host's decisions: each
    connection gets its MCT + 30 minutes, and about half the requests one
    connection of 0 minutes. Returns the requests and the rids that
    ``cpu_match_numpy``'s decisions make infeasible."""
    import numpy as np
    from repro_torch.core.engine import cpu_match_numpy
    from repro_torch.serve import Request

    rng = np.random.default_rng(11)
    reqs = []
    for i in range(LM_REQUESTS):
        plen = int(rng.integers(16, 49))
        nq = int(rng.integers(2, 7))
        reqs.append(Request(
            rid=i, tokens=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=LM_NEW_TOKENS, arrival=i * 0.002,
            mct_queries=[queries[j] for j in
                         rng.integers(0, len(queries), nq)]))
    flat = [q for r in reqs for q in r.mct_queries]
    dec = cpu_match_numpy(engine.table, engine.encode_queries_host(flat),
                          block=128)[0]
    mct = np.where(dec >= 0, dec, engine.table.default_decision)
    expect_drop, j = set(), 0
    for r in reqs:
        n = len(r.mct_queries)
        need = mct[j:j + n]
        j += n
        have = need + 30
        if rng.random() < 0.5:
            have[rng.integers(0, n)] = 0
        r.connect_minutes = [int(x) for x in have]
        if (have < need).any():
            expect_drop.add(r.rid)
    return reqs, expect_drop


def serve_groups(srv, groups, label: str):
    """``generate_batch`` on each batch group, one printed row a batch;
    returns the completions and the rows."""
    comps, batches = [], []
    for g in groups:
        t0 = time.perf_counter()
        out = srv.generate_batch(g)
        wall = (time.perf_counter() - t0) * 1e3
        comps.extend(out)
        n_tok = sum(len(c.tokens) for c in out)
        row = dict(requests=len(g), kept=len(out), wall_ms=wall,
                   tokens=n_tok)
        if out:
            pre, dec_ms = out[0].prefill_ms, out[0].decode_ms
            row.update(prefill_ms=pre, decode_ms=dec_ms,
                       tokens_per_s=n_tok / ((pre + dec_ms) / 1e3),
                       prompt_steps=max(len(r.tokens) for r in g
                                        if r.rid in {c.rid for c in out}))
        batches.append(row)
        print(f"{label}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
    return comps, batches


def phase_route_scorer(dev, engine, queries, card: str):
    """LMServer on the full-width llama3.2-3b in bf16, its MCT filter on
    phase 4's engine (the CUDA rule-match kernel); checks (a)-(d).
    ``card`` is nvidia-smi's name and power limit, printed beside times."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.device import synchronize
    from repro_torch.kernels.rule_match import rule_match
    from repro_torch.serve import LMServer, Request, form_batch_groups

    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = LMServer(cfg, device=dev, max_seq=LM_MAX_SEQ, seed=0,
                   rule_filter=engine)
    synchronize(dev)
    t_init = time.perf_counter() - t0
    p_bytes = tree_bytes(srv.params)
    kv_tok = tree_bytes(list(leaves(srv.model.cache_struct(1, 1))))
    print(f"route scorer: {ARCH}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads "
          f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_dtype}: {cfg.n_params()} parameters "
          f"(ModelConfig.n_params), {p_bytes} bytes on the card; drawn on "
          f"the card in {t_init:.2f} s; KV cache {kv_tok} bytes a token a "
          f"sequence ({kv_tok * 8 * LM_MAX_SEQ} bytes at B = 8, S = "
          f"{LM_MAX_SEQ})")

    reqs, expect_drop = scorer_requests(engine, queries, cfg.vocab)

    srv.warmup((1, 2, 4, 8))
    groups = form_batch_groups(reqs, target_batch=8, deadline=0.01)
    rule_match.launches = 0
    comps, batches = serve_groups(srv, groups, f"route scorer batch ({card})")
    launches = rule_match.launches
    if launches != len(groups):
        fail(f"rule-match launches {launches} on the route-scorer path, "
             f"{len(groups)} filtered batches")
    dropped = {r.rid for r in reqs} - {c.rid for c in comps}
    print(f"route scorer: {len(groups)} batches of sizes "
          f"{[len(g) for g in groups]}, {len(comps)} served, dropped "
          f"{sorted(dropped)}; rule-match launches {launches}")
    if dropped != expect_drop:                                     # (a)
        fail(f"(a) dropped {sorted(dropped)}, cpu_match_numpy's decisions "
             f"drop {sorted(expect_drop)}")
    for c in comps:                                                # (b)
        if len(c.tokens) != LM_NEW_TOKENS or c.truncated \
                or not ((c.tokens >= 0) & (c.tokens < cfg.vocab)).all():
            fail(f"(b) request {c.rid}: {len(c.tokens)} tokens, truncated "
                 f"{c.truncated}")
    print(f"check (a): dropped set equals cpu_match_numpy's "
          f"({len(expect_drop)} of {len(reqs)}); check (b): "
          f"{len(comps)} completions of {LM_NEW_TOKENS} tokens, none "
          "truncated")

    # (c) full width, bf16: prefill's last-token logits against decode
    prompt = torch.as_tensor(reqs[0].tokens, dtype=torch.long,
                             device=dev)[None]
    r = prefill_vs_decode(srv.model, srv.params, {"tokens": prompt}, dev)
    diff, scale = r["diff"], r["scale"]
    print(f"check (c): bf16 prefill vs {prompt.shape[1]} decode steps, "
          f"last-token logits: max abs diff {diff:.5f}, largest logit "
          f"{scale:.4f}, ratio {r['ratio']:.5f} (limit {BF16_REL_TOL}); "
          f"top-2 gap {r['gap']:.5f}, same argmax {r['same_top']}")
    if not (r["finite"] and r["ratio"] <= BF16_REL_TOL
            and (r["same_top"] or r["gap"] <= 2 * diff)):
        fail("(c) prefill and token-by-token decode disagree")

    # one decode step at B = 8: time and the operators that take it
    cache = srv.model.init_cache(8, LM_MAX_SEQ, device=dev)
    tok = torch.zeros((8, 1), dtype=torch.long, device=dev)

    def step():
        with torch.inference_mode():
            srv.model.decode_step(srv.params, cache, tok, 40)
    step()
    step_ms = cuda_ms(step, 10)
    step_bound = p_bytes / HBM_BYTES_PER_S * 1e3
    ops, kernels, dev_ms, n_launch = top_device_ops(step)
    print(f"decode step ({card}), B = 8, pos 40: {step_ms:.4f} ms (CUDA "
          f"events, 10 steps); weights read once {step_bound:.4f} ms by "
          f"bytes; under the profiler {n_launch} kernel launches, device "
          f"time {dev_ms:.4f} ms")
    for name, ms, n in ops:
        print(f"  op {name}: {ms:.4f} ms device, {n} calls")
    for name, ms, n in kernels:
        print(f"  kernel {name[:90]}: {ms:.4f} ms, {n} launches")
    peak = torch.cuda.max_memory_allocated(dev)
    del cache, srv
    torch.cuda.empty_cache()

    # (d) 2 layers, full width, float32, TF32 off: the card against the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               param_dtype="float32")
    with no_tf32():
        gpu = LMServer(cfg2, device=dev, max_seq=64, seed=0)
        cpu = LMServer(cfg2, gpu._params_on(torch.device("cpu")),
                       device="cpu", max_seq=64)
        toks = np.stack([reqs[1].tokens[:16], reqs[2].tokens[:16]])
        with torch.inference_mode():
            lg_gpu = gpu.model.logits(gpu.params, {"tokens": torch.as_tensor(
                toks, dtype=torch.long, device=dev)}).cpu()
            lg_cpu = cpu.model.logits(cpu.params, {"tokens": torch.as_tensor(
                toks, dtype=torch.long)})
        d_err = float((lg_gpu - lg_cpu).abs().max())
        close = bool(torch.allclose(lg_gpu, lg_cpu, atol=F32_TOL,
                                    rtol=F32_TOL))
        pair = [Request(rid=0, tokens=reqs[1].tokens[:20], max_new_tokens=8),
                Request(rid=1, tokens=reqs[2].tokens[:13], max_new_tokens=8)]
        t_gpu = [c.tokens for c in gpu.generate_batch(pair)]
        t_cpu = [c.tokens for c in cpu.generate_batch(pair)]
        same = all(np.array_equal(x, y) for x, y in zip(t_gpu, t_cpu))
    print(f"check (d): 2-layer float32 copy, card vs CPU: logits (2, 16, "
          f"{cfg.vocab}) max abs diff {d_err:.3g} (atol = rtol = "
          f"{F32_TOL}: {close}); greedy tokens equal {same}")
    if not (close and same):
        fail("(d) the card and the CPU disagree on the float32 model")
    del gpu, cpu
    torch.cuda.empty_cache()

    served = [b for b in batches if b["kept"]]
    n_tok = sum(b["tokens"] for b in served)
    t_s = sum(b["prefill_ms"] + b["decode_ms"] for b in served) / 1e3
    return dict(batches=len(groups), requests=len(reqs),
                dropped=len(dropped), served=len(comps),
                tokens_per_s=n_tok / t_s, decode_step_ms_b8=step_ms,
                decode_step_launches=n_launch, decode_step_device_ms=dev_ms,
                decode_step_bound_ms=step_bound, peak_bytes=peak,
                launches=launches, batch_rows=batches,
                checks={"a": True, "b": True, "c": True, "d": True},
                c_ratio=diff / scale, d_max_abs=d_err)


def phase_serving(dev, engine, queries, card: str):
    """The serving stack on the card: ``build()`` + ``Server.serve`` with
    two colocated replicas of the full-width llama3.2-3b behind phase 4's
    engine; phase 6's requests in sync mode (a cache-free facade over the
    same replicas), then pipelined through the replica threads, then again
    with fresh rids (all cache hits), and last, with new prompts, live
    through a session (bounded admission, arrivals in real time). Checks
    (e)-(i)."""
    import dataclasses
    import threading
    import numpy as np
    import torch
    from repro_torch.kernels.rule_match import rule_match
    from repro_torch.serve import (BottleneckMonitor, CapacitySignals,
                                   ServeConfig, Server, build)

    t_phase = time.perf_counter()
    cfg = ServeConfig(model=ARCH, reduced=False, device=dev,
                      rule_filter=engine, replicas=2, target_batch=8,
                      deadline=0.01, max_seq=LM_MAX_SEQ,
                      cache={"negative_ttl": SERVE_NEGATIVE_TTL}, trace=True,
                      warmup=(1, 2, 4, 8))
    t0 = time.perf_counter()
    srv = build(cfg)
    t_build = time.perf_counter() - t0
    vocab = srv.engine.cfg.vocab
    wave1, expect_drop = scorer_requests(engine, queries, vocab)
    wave2 = [dataclasses.replace(r, rid=r.rid + SERVE_WAVE_RID,
                                 arrival=r.arrival + SERVE_WAVE_GAP_S)
             for r in wave1]
    print(f"serving ({card}): build() of {ARCH} at full width with 2 "
          f"colocated replicas and warmup (1, 2, 4, 8) in {t_build:.2f} s")

    # which threads call the filter: the replica workers in pipelined mode
    callers = {}
    match = engine.match

    def counted_match(encoded):
        name = threading.current_thread().name
        callers[name] = callers.get(name, 0) + 1
        return match(encoded)
    engine.match = counted_match
    try:
        sync_srv = Server(srv.group, dataclasses.replace(cfg, cache=None,
                                                         trace=None))
        rule_match.launches = 0
        t0 = time.perf_counter()
        sync_out = sync_srv.serve(wave1, mode="sync")
        sync_s = time.perf_counter() - t0
        sync_launches = rule_match.launches
        sync_callers = dict(callers)
        sync_rep = sync_srv.report()
        callers.clear()

        rule_match.launches = 0
        t0 = time.perf_counter()
        pipe_out = srv.serve(wave1, mode="pipelined")
        pipe_s = time.perf_counter() - t0
        pipe_launches = rule_match.launches
        pipe_callers = dict(callers)
        rep1 = srv.report()
        n_dev1 = len(rep1.batch_sizes)
        t0 = time.perf_counter()
        hit_out = srv.serve(wave2, mode="pipelined")
        hit_s = time.perf_counter() - t0
        wave2_launches = rule_match.launches - pipe_launches
        rep, trep = srv.report(), srv.trace_report()

        # live: new prompts (so no cache hits), the same connections, each
        # request submitted at its arrival time
        wave3 = [dataclasses.replace(r, rid=r.rid + 2 * SERVE_WAVE_RID,
                                     tokens=(r.tokens + 1) % vocab)
                 for r in wave1]
        sched = srv.session(policy="block")
        callers.clear()
        before = rule_match.launches
        snap0 = sched.metrics.snapshot(time.perf_counter())
        t0 = time.perf_counter()
        for r in wave3:
            wait = t0 + r.arrival - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sched.submit(r)
        live_out = sched.result()
        live_s = time.perf_counter() - t0
        snap1 = sched.metrics.snapshot(time.perf_counter())
        live_launches = rule_match.launches - before
        live_callers = dict(callers)
        live_rep = sched.report()
    finally:
        engine.match = match

    sync_by = {c.rid: c for c in sync_out}
    pipe_by = {c.rid: c for c in pipe_out}
    served = sorted(sync_by)
    bad = [rid for rid in served if rid not in pipe_by
           or not np.array_equal(pipe_by[rid].tokens, sync_by[rid].tokens)
           or pipe_by[rid].batch_size != sync_by[rid].batch_size]
    print(f"check (e): pipelined against sync, {len(served)} served "
          f"requests: tokens and batch sizes equal for "
          f"{len(served) - len(bad)}, served sets equal "
          f"{sorted(pipe_by) == served}")
    if bad or sorted(pipe_by) != served:                           # (e)
        fail(f"(e) pipelined and sync disagree on requests {bad}")

    ids = {r.rid for r in wave1}
    sync_drop, pipe_drop = ids - set(sync_by), ids - set(pipe_by)
    print(f"check (f): dropped sync {sorted(sync_drop)}, pipelined "
          f"{sorted(pipe_drop)}, cpu_match_numpy {sorted(expect_drop)}")
    if not sync_drop == pipe_drop == expect_drop:                  # (f)
        fail("(f) the serving stack's filter drops other requests than "
             "cpu_match_numpy's decisions")

    c = rep.cache
    n_sub = len(wave1) + len(wave2)
    acct = c["hits"] + c["misses"] + c["coalesced"] \
        + c.get("negative_hits", 0)
    wave2_hits = c["hits"] - rep1.cache["hits"]
    wave2_neg = c.get("negative_hits", 0) - rep1.cache.get("negative_hits",
                                                             0)
    hit_by = {x.rid - SERVE_WAVE_RID: x for x in hit_out}
    minted_ok = sorted(hit_by) == served and all(
        np.array_equal(hit_by[rid].tokens, sync_by[rid].tokens)
        for rid in served)
    print(f"check (g): cache {c}; hits + misses + coalesced + negative hits "
          f"= {acct}, submitted {n_sub}; second wave {wave2_hits} hits + "
          f"{wave2_neg} negative hits of {len(wave2)}, minted tokens equal "
          f"{minted_ok}")
    if acct != n_sub or wave2_hits + wave2_neg != len(wave2) \
            or wave2_hits != len(served) or not minted_ok:         # (g)
        fail("(g) the cache's accounting or the second wave's hits are off")

    n_sync_batches = len(sync_rep.batch_sizes)
    worker_calls = sum(n for name, n in pipe_callers.items()
                       if name != threading.main_thread().name)
    print(f"check (h): rule-match launches sync {sync_launches} for "
          f"{n_sync_batches} filtered batches (callers {sync_callers}), "
          f"pipelined {pipe_launches} for {n_dev1} (callers {pipe_callers}),"
          f" cached wave {wave2_launches}")
    if sync_launches != n_sync_batches or pipe_launches != n_dev1 \
            or wave2_launches != 0 or worker_calls != pipe_launches:  # (h)
        fail("(h) rule-match launches do not follow the filtered batches")

    # a replay has no submit-side stages: encode, device and the counts
    # reconcile (spans reuse the clock readings handed to the metrics)
    mism = []
    for stage, part in (("encode", "encode"), ("device_execute", "device")):
        a, b = trep.stages[stage].as_dict(), rep.breakdown[part].as_dict()
        if a["n"] != b["n"] or any(abs(a[k] - b[k]) > 1e-6 * max(1.0, b[k])
                                   for k in a if k != "n"):
            mism.append(stage)
    if trep.counts.get("complete", 0) != rep.n_completed:
        mism.append("complete")
    for r, rs in rep.per_replica.items():
        ts = trep.per_replica.get(r)
        if rs.n_batches and (ts is None or ts.n_batches != rs.n_batches
                             or ts.n_requests != rs.n_requests):
            mism.append(f"replica {r}")
    print(f"check (i): trace counts {dict(sorted(trep.counts.items()))}; "
          f"run report: {rep.n_completed} completed, {len(rep.batch_sizes)} "
          f"batches; disagreements {mism}")
    if mism:                                                       # (i)
        fail(f"(i) the trace and the run report disagree on {mism}")

    live_by = {x.rid - 2 * SERVE_WAVE_RID: x for x in live_out}
    lc = live_rep.cache
    live_acct = lc["hits"] + lc["misses"] + lc["coalesced"] \
        + lc.get("negative_hits", 0)
    n_live = len(live_rep.batch_sizes)
    live_workers = sum(n for name, n in live_callers.items()
                       if name != threading.main_thread().name)
    print(f"live session: {len(live_out)} served, dropped "
          f"{sorted(ids - set(live_by))}; cache {lc}, submitted "
          f"{sched.n_submitted}; {n_live} batches of "
          f"{live_rep.batch_sizes}, rule-match launches {live_launches} "
          f"(callers {live_callers})")
    if ids - set(live_by) != expect_drop or live_acct != sched.n_submitted \
            or live_launches != n_live or live_workers != n_live:
        fail("(f)-(h) the live session's drops, accounting or launches "
             "are off")

    # the capacity monitor's class for the live window (arrivals recorded)
    sig = CapacitySignals.between(snap0, snap1, queue_depth=0,
                                  admission_limit=cfg.max_queue,
                                  n_active_replicas=2)
    diagnosis = BottleneckMonitor(confirm=1).observe(sig)

    def pct(report, part):
        b = report.breakdown[part]
        return f"p50 {b.p50_ms:.3f} / p95 {b.p95_ms:.3f} / p99 " \
               f"{b.p99_ms:.3f} ms (n {b.n})"
    print(f"serving qps ({card}), completed requests a second: sync "
          f"{sync_rep.achieved_qps:.4f} ({sync_s:.3f} s for {len(wave1)} "
          f"requests), pipelined {rep1.achieved_qps:.4f} ({pipe_s:.3f} s), "
          f"live {live_rep.achieved_qps:.4f} ({live_s:.3f} s); cached wave "
          f"{len(wave2) / hit_s:.1f} requests a second "
          f"({hit_s * 1e3:.3f} ms)")
    for name, report in (("pipelined", rep1), ("live", live_rep)):
        print(f"serving latency by stage ({card}), {name}: queue "
              f"{pct(report, 'queue_wait')}; encode "
              f"{pct(report, 'encode')}; device {pct(report, 'device')}")
        for r, st in sorted(report.per_replica.items()):
            print(f"serving replica {r} ({card}), {name}: {st.n_batches} "
                  f"batches, {st.n_requests} requests, device busy "
                  f"{st.busy_s:.4f} s, idle fraction "
                  f"{st.idle_fraction:.4f} of {report.span_s:.4f} s")
    print(f"serving bottleneck (live window): {diagnosis} (arrivals "
          f"{sig.arrival_rate:.2f}/s, host busy {sig.host_busy_fraction:.4f},"
          f" device idle {sig.device_idle_fraction:.4f} a replica over "
          f"{sig.window_s:.4f} s)")
    print(f"serving launches: sync {sync_launches}, pipelined "
          f"{pipe_launches}, cached wave {wave2_launches}, live "
          f"{live_launches}")
    wall = time.perf_counter() - t_phase
    print(f"phase 8 took {wall:.1f} s")
    del srv, sync_srv, sched
    torch.cuda.empty_cache()
    return dict(
        sync_s=sync_s, pipelined_s=pipe_s, cached_s=hit_s, live_s=live_s,
        sync_qps=sync_rep.achieved_qps, pipelined_qps=rep1.achieved_qps,
        live_qps=live_rep.achieved_qps,
        launches=sync_launches + pipe_launches + wave2_launches
        + live_launches,
        launches_sync=sync_launches, launches_pipelined=pipe_launches,
        launches_cached=wave2_launches, launches_live=live_launches,
        batches=n_dev1, live_batches=live_rep.batch_sizes,
        served=len(served), dropped=len(expect_drop),
        breakdown={k: v.as_dict() for k, v in rep1.breakdown.items()},
        live_breakdown={k: v.as_dict()
                        for k, v in live_rep.breakdown.items()},
        per_replica={r: st.as_dict() for r, st in rep1.per_replica.items()},
        live_per_replica={r: st.as_dict()
                          for r, st in live_rep.per_replica.items()},
        diagnosis=str(diagnosis), cache=c, build_s=t_build, wall_s=wall,
        checks={k: True for k in "efghi"})


def phase_deployment(bench, timed, card: str):
    """Phase 7: the paper's deployment analysis through the figure
    harnesses on phase 4's engine (``bench``): fig 6's stage split, the
    stage times of figs 7-11 and their series and Pareto front, tables 2
    and 3, and the H100 cost balance from this card's host encode rate and
    phase 5's lane time."""
    import torch_fig6_overheads as fig6
    import torch_fig7_10_parallel as fig7_10
    import torch_fig11_pareto as fig11
    import torch_table2_3_cost as table2_3
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels.rule_match import rule_match

    rule_match.launches = 0
    split = fig6.run(bench)
    fig6_launches = rule_match.launches
    rule_match.launches = 0
    st = fig7_10.measure(bench, repeats=STAGE_REPEATS)
    stage_launches = rule_match.launches
    for t in st:
        print(f"stage times ({card}; median of 3), B = {t.batch}: encode_us "
              f"{t.encode_us:.1f}, dispatch_us {t.dispatch_us:.1f}, "
              f"kernel_us {t.kernel_us:.1f}, collect_us {t.collect_us:.1f}")
    fig7_10.run(bench, stage_times=st)
    front = fig11.run(bench, stage_times=st)

    enc_us = next(t.encode_us for t in st if t.batch == 1024)
    lane_ms = next(r["ms"] for r in timed if r["B"] == 4096)
    params = cm.H100CostParams(host_qps_per_vcpu=1024 / (enc_us * 1e-6),
                               accel_qps_per_chip=4096 / (lane_ms * 1e-3))
    print(f"H100 cost parameters ({card}): host "
          f"{params.host_qps_per_vcpu:.6g} "
          f"queries/s a vCPU (one encode worker, B = 1024), card "
          f"{params.accel_qps_per_chip:.6g} queries/s (phase 5 lane, B = "
          f"4096); {params.host_vcpus_per_gpu:g} vCPUs and "
          f"${params.gpu_usd_per_hour:.2f}/h a GPU (p5.48xlarge)")
    costs = table2_3.run(bench, params=params)
    if costs["worst"] > table2_3.TABLE2_TOL:
        fail(f"table 2 is {costs['worst']:.1%} off the paper's totals "
             f"(limit {table2_3.TABLE2_TOL:.0%})")
    print(f"table 2 within {costs['worst']:.2%} of the paper's totals "
          f"(limit {table2_3.TABLE2_TOL:.0%}); fig 6 launches "
          f"{fig6_launches}, stage times launches {stage_launches}")
    return dict(stage_times=[vars(t) for t in st],
                fig6_stage_times=[vars(t) for t in split],
                host_qps_per_vcpu=params.host_qps_per_vcpu,
                accel_qps_per_chip=params.accel_qps_per_chip,
                balance=costs["balance"], table2_worst=costs["worst"],
                pareto=[(pf.config.label(), pf.latency_us, pf.throughput_qps)
                        for pf in front],
                launches_fig6=fig6_launches,
                launches_stage_times=stage_launches)


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 on the card (TF32 off)."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def tree_cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def prefill_vs_decode(model, params, batch, dev) -> dict:
    """``model.prefill``'s last-token logits against those of decoding the
    prompt token by token from an empty cache."""
    import torch
    prompt = batch["tokens"]
    S = prompt.shape[1]
    with torch.inference_mode():
        last, _ = model.prefill(params, batch)
        cache = model.init_cache(1, S, device=dev)
        for t in range(S):
            lg, cache = model.decode_step(params, cache, prompt[:, t:t + 1],
                                          t)
    a, b = lg.float()[0, 0], last.float()[0, 0]
    diff = float((a - b).abs().max())
    scale = float(b.abs().max())
    return dict(diff=diff, scale=scale, ratio=diff / scale,
                gap=float(b.topk(2).values.diff().abs()[0]),
                same_top=int(a.argmax()) == int(b.argmax()),
                finite=bool(torch.isfinite(a).all()))


def decode_step_bytes(cfg, params, cache, batch: int, pos: int) -> int:
    """Bytes one decode step at ``pos`` must move: every weight it reads
    once (an untied embedding only the batch's rows; the VLM's cross
    attention keys and values come from the cache, so not its ``wk`` and
    ``wv``), the keys and values of positions 0..pos, the vision keys and
    values, and each recurrent state read once and written once."""
    emb = params["embed"]
    n = tree_bytes(params)
    if not cfg.tie_embeddings:
        n -= emb.numel() * emb.element_size() \
            - batch * cfg.d_model * emb.element_size()
    for c in params.get("cross", []):
        n -= tree_bytes([c["attn"]["wk"], c["attn"]["wv"]])
    runs = cache["runs"] if "runs" in cache else [cache]
    for leaves_ in runs:
        for name, t in leaves_.items():
            b = t.numel() * t.element_size()
            if name in ("k", "v"):
                n += b // t.shape[-3] * (pos + 1)       # (..., S, K, hd)
            elif name in ("xk", "xv"):
                n += b
            else:
                n += 2 * b
    return n


def phase_families(dev, engine, queries, card: str):
    """Every other decoder family at full width through ``LMServer`` behind
    phase 4's engine, one model at a time: 8 of phase 6's requests with 4
    new tokens, then one decode step at B = 8 timed and profiled, with
    checks (j) the dropped set against cpu_match_numpy's, (k) bf16 prefill
    against token-by-token decode, (l) the reduced float32 copy on the card
    against the CPU; then one full-width forward of the encoder-only
    hubert-xlarge."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.device import synchronize
    from repro_torch.kernels.rule_match import rule_match
    from repro_torch.models.registry import build_model, make_inputs
    from repro_torch.serve import LMServer, form_batch_groups

    t_phase = time.perf_counter()
    rows = {}
    for arch, depth in FAMILY_MODELS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        gc.collect()                    # the previous model's cycles
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        srv = LMServer(cfg, device=dev, max_seq=FAMILY_MAX_SEQ, seed=0,
                       rule_filter=engine)
        synchronize(dev)
        t_init = time.perf_counter() - t0
        # the peak from here on: weights resident, serving and the checks
        torch.cuda.reset_peak_memory_stats(dev)
        p_bytes = tree_bytes(srv.params)
        print(f"family {arch} ({cfg.family}): {cfg.n_layers} layers"
              f"{f' of {get_config(arch).n_layers}' if depth else ''}, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.param_dtype}:"
              f" {p_bytes} bytes of weights drawn on the card in "
              f"{t_init:.2f} s")

        reqs, expect_drop = scorer_requests(engine, queries, cfg.vocab)
        reqs = reqs[:FAMILY_REQUESTS]
        for r in reqs:
            r.max_new_tokens = FAMILY_NEW_TOKENS
        expect_drop &= {r.rid for r in reqs}
        srv.warmup((8,))
        groups = form_batch_groups(reqs, target_batch=8, deadline=0.01)
        rule_match.launches = 0
        comps, batches = serve_groups(srv, groups, f"{arch} batch ({card})")
        launches = rule_match.launches
        if launches != len(groups):
            fail(f"{arch}: rule-match launches {launches}, {len(groups)} "
                 "filtered batches")
        dropped = {r.rid for r in reqs} - {c.rid for c in comps}
        if dropped != expect_drop:                                 # (j)
            fail(f"(j) {arch}: dropped {sorted(dropped)}, cpu_match_numpy's"
                 f" decisions drop {sorted(expect_drop)}")
        for c in comps:
            if len(c.tokens) != FAMILY_NEW_TOKENS or c.truncated or not (
                    (c.tokens >= 0) & (c.tokens < cfg.vocab)).all():
                fail(f"{arch}: request {c.rid}: {len(c.tokens)} tokens, "
                     f"truncated {c.truncated}")

        # (k) prefill against token-by-token decode on one prompt; the
        # VLM's vision embeddings are zeros, as its decode cache holds them
        prompt = torch.as_tensor(reqs[0].tokens, dtype=torch.long,
                                 device=dev)[None]
        batch = {"tokens": prompt}
        if cfg.cross_attn_every:
            batch["vision_embeds"] = torch.zeros(
                (1, cfg.n_vision_tokens, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        k_bf16 = prefill_vs_decode(srv.model, srv.params, batch, dev)
        k_row = {"bf16": k_bf16}
        if arch in F32_PREFILL_ARCHS:
            cfg32 = dataclasses.replace(cfg, dtype="float32",
                                        param_dtype="float32")
            with no_tf32():
                k_row["float32"] = prefill_vs_decode(
                    build_model(cfg32), tree_cast(srv.params, torch.float32),
                    batch, dev)
            gated, limit = "float32", F32_PREFILL_REL_TOL
        else:
            gated, limit = "bf16", BF16_REL_TOL
        for name, r in k_row.items():
            print(f"check (k) {arch}, {name}: prefill vs {prompt.shape[1]} "
                  f"decode steps: max abs diff {r['diff']:.5f}, largest "
                  f"logit {r['scale']:.4f}, ratio {r['ratio']:.5f} ("
                  + (f"limit {limit}" if name == gated else "not gated")
                  + f"); same argmax {r['same_top']}, top-2 gap "
                  f"{r['gap']:.5f}")
        r = k_row[gated]
        if not (r["finite"] and r["ratio"] <= limit
                and (r["same_top"] or r["gap"] <= 2 * r["diff"])):
            fail(f"(k) {arch}: prefill and token-by-token decode disagree")

        # one decode step at B = 8
        cache = srv.model.init_cache(8, FAMILY_MAX_SEQ, device=dev)
        tok = torch.zeros((8, 1), dtype=torch.long, device=dev)

        def step():
            with torch.inference_mode():
                srv.model.decode_step(srv.params, cache, tok,
                                      FAMILY_STEP_POS)
        step()
        step_ms = cuda_ms(step, 5)
        moved = decode_step_bytes(cfg, srv.params, cache, 8, FAMILY_STEP_POS)
        bound = moved / HBM_BYTES_PER_S * 1e3
        ops, kernels, dev_ms, n_launch = top_device_ops(step, n=5)
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"{arch} decode step ({card}), B = 8, pos {FAMILY_STEP_POS}: "
              f"{step_ms:.4f} ms (CUDA events, 5 steps); {n_launch} kernel "
              f"launches, device time {dev_ms:.4f} ms (busy "
              f"{dev_ms / step_ms:.3f}); bound {bound:.4f} ms by bytes "
              f"({moved} bytes at 3.35 TB/s); peak memory {peak} bytes "
              "since the weights were drawn")
        for name, ms, n in ops:
            print(f"  op {name}: {ms:.4f} ms device, {n} calls")
        del cache, srv
        torch.cuda.empty_cache()

        # (l) the reduced float32 copy: card against CPU
        cfg_r = dataclasses.replace(get_config(arch).reduced(),
                                    dtype="float32", param_dtype="float32")
        with no_tf32(), torch.inference_mode():
            gpu = LMServer(cfg_r, device=dev, max_seq=32, seed=0)
            cpu = LMServer(cfg_r, gpu._params_on(torch.device("cpu")),
                           device="cpu", max_seq=32)
            inp = make_inputs(cfg_r, 2, 16, np.random.default_rng(0),
                              device="cpu")
            lg_cpu = cpu.model.logits(cpu.params, inp)
            lg_gpu = gpu.model.logits(gpu.params, {
                k: v.to(dev) for k, v in inp.items()}).cpu()
            l_err = float((lg_gpu - lg_cpu).abs().max())
            close = bool(torch.allclose(lg_gpu, lg_cpu, atol=FAMILY_F32_TOL,
                                        rtol=FAMILY_F32_TOL))
            pair = [dataclasses.replace(reqs[1], rid=0, mct_queries=[]),
                    dataclasses.replace(reqs[2], rid=1, mct_queries=[])]
            for r in pair:
                r.tokens = r.tokens[:12] % cfg_r.vocab
            same = all(np.array_equal(x.tokens, y.tokens) for x, y in zip(
                gpu.generate_batch(pair), cpu.generate_batch(pair)))
        print(f"check (l) {arch}: reduced float32 copy, card vs CPU: logits "
              f"max abs diff {l_err:.3g} (atol = rtol = {FAMILY_F32_TOL}: "
              f"{close}); greedy tokens equal {same}")
        if not (close and same):
            fail(f"(l) {arch}: the card and the CPU disagree")
        del gpu, cpu
        torch.cuda.empty_cache()

        served = [b for b in batches if b["kept"]]
        rows[arch] = dict(
            family=cfg.family, layers=cfg.n_layers, weight_bytes=p_bytes,
            batches=len(groups), served=len(comps), dropped=len(dropped),
            launches=launches,
            prefill_ms=[b["prefill_ms"] for b in served],
            decode_ms=[b["decode_ms"] for b in served],
            decode_step_ms_b8=step_ms, decode_step_launches=n_launch,
            decode_step_device_ms=dev_ms, decode_step_bound_ms=bound,
            decode_step_bytes=moved, peak_bytes=peak,
            k_ratio={n: r["ratio"] for n, r in k_row.items()},
            l_max_abs=l_err, checks={"j": True, "k": True, "l": True})

    # the encoder-only family: one full-width forward from make_inputs
    cfg = get_config(ENCODER_ARCH)
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    inp = make_inputs(cfg, ENCODER_BATCH, ENCODER_SEQ,
                      np.random.default_rng(0), device=dev)
    out = {}

    def fwd():
        with torch.inference_mode():
            out["logits"] = model.logits(params, inp)
    fwd()
    fwd_ms = cuda_ms(fwd, 3)
    lg = out["logits"]
    if tuple(lg.shape) != (ENCODER_BATCH, ENCODER_SEQ, cfg.vocab) \
            or not bool(torch.isfinite(lg.float()).all()):
        fail(f"{ENCODER_ARCH}: logits {tuple(lg.shape)}, finite "
             f"{bool(torch.isfinite(lg.float()).all())}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"family {ENCODER_ARCH} ({cfg.family}, encoder-only) ({card}): "
          f"{cfg.n_layers} layers, {tree_bytes(params)} bytes of weights; "
          f"forward at (B, S) = ({ENCODER_BATCH}, {ENCODER_SEQ}) "
          f"{fwd_ms:.4f} ms (CUDA events, 3 calls), logits finite; peak "
          f"memory {peak} bytes")
    rows[ENCODER_ARCH] = dict(family=cfg.family, layers=cfg.n_layers,
                              weight_bytes=tree_bytes(params),
                              forward_ms=fwd_ms, peak_bytes=peak)
    del params, out, lg, inp
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"phase 9 took {wall:.1f} s")
    return dict(models=rows, seconds=wall)


def train_step_work(cfg, params, batch: int, seq: int) -> dict:
    """The work one train step must do, from the model's shapes: the
    operations of forward and backward (3x the forward's; weight products
    in bf16 on the tensor cores, the attention's two products in float32,
    causal pairs only), and the bytes it must move (parameters, AdamW's mu
    and nu read once and written once). The optimizer pass as coded also
    reads the float32 grads: 24 bytes a parameter in all."""
    n = sum(t.numel() for t in leaves(params))
    p_bytes = tree_bytes(params)
    D, L, T = cfg.d_model, cfg.n_layers, batch * seq
    per_layer = D * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * D \
        + 3 * D * cfg.d_ff
    mm = 3 * 2 * (T * L * per_layer + batch * (seq - 1) * cfg.vocab * D)
    pairs = seq * (seq + 1) // 2
    attn = 3 * 2 * 2 * batch * cfg.n_heads * cfg.head_dim * pairs * L
    ops_ms = (mm / BF16_FLOP_PER_S + attn / F32_FLOP_PER_S) * 1e3
    state = 2 * 4 * n                               # mu, nu in float32
    io_bytes = 2 * (p_bytes + state)
    opt_bytes = io_bytes + 4 * n                    # + the float32 grads
    return dict(params=n, matmul_flops=mm, attention_flops=attn,
                ops_ms=ops_ms, io_bytes=io_bytes,
                bytes_ms=io_bytes / HBM_BYTES_PER_S * 1e3,
                optimizer_bytes=opt_bytes,
                optimizer_bytes_ms=opt_bytes / HBM_BYTES_PER_S * 1e3)


def phase_training(dev, card: str):
    """Training on the card through ``fit``; checks (m)-(p)."""
    import dataclasses
    import shutil
    import statistics
    import numpy as np
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import (TrainConfig, _grads, _local_step,
                                        batch_to_device, fit,
                                        make_optimizer)
    from repro_torch.train.optimizer import tree_leaves, tree_map

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    left = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tc = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     lr=TRAIN_LR, warmup=TRAIN_WARMUP, log_every=TRAIN_STEPS)
    res = fit(cfg, tc, device=dev)
    peak = torch.cuda.max_memory_allocated(dev)
    params, state = res.params, res.opt_state
    work = train_step_work(cfg, params, TRAIN_BATCH, TRAIN_SEQ)
    step_ms = statistics.median(res.step_times[1:]) * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"training ({card}): {TRAIN_ARCH}, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, {work['params']} "
          f"parameters ({tree_bytes(params)} bytes, {cfg.param_dtype}), "
          f"AdamW moments {cfg.optimizer_dtype}, remat {cfg.remat}; batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps: losses "
          f"{[round(x, 4) for x in res.losses]}, grad norms "
          f"{[round(x, 4) for x in res.grad_norms]}; step times "
          f"{[round(t * 1e3, 2) for t in res.step_times]} ms (host clock, "
          f"each ending in the loss's read); median after the first "
          f"{step_ms:.2f} ms, {tok_s:.1f} tokens/s; peak memory {peak} "
          f"bytes ({left} bytes held before the phase)")
    if not (all(np.isfinite(res.losses)) and all(np.isfinite(res.grad_norms))
            and len(res.losses) == TRAIN_STEPS):               # (m)
        fail(f"(m) losses {res.losses}, grad norms {res.grad_norms}")

    # (m) three steps on one repeated batch lower the loss
    model = build_model(cfg)
    opt = make_optimizer(cfg, tc)
    step = _local_step(model, opt, 1)
    batch = batch_to_device(synth_batch(cfg, TRAIN_STEPS, TRAIN_BATCH,
                                        TRAIN_SEQ), dev)
    rep = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        rep.append(float(m["loss"]))
    print(f"check (m): losses and grad norms finite; three steps on one "
          f"batch: losses {rep}")
    if not (all(np.isfinite(rep)) and rep[-1] < rep[0]):
        fail(f"(m) repeated batch did not lower the loss: {rep}")

    # one step under the profiler; fwd/bwd and the optimizer apart
    holder = {"state": state}

    def one_step():
        _, holder["state"], _ = step(params, holder["state"], batch)
    ops, kernels, dev_ms, n_launch = top_device_ops(one_step)
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    leaves_ = tree_leaves(params)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, grads = _grads(model, params, leaves_, batch)
    torch.cuda.synchronize(dev)
    fb_ms = (time.perf_counter() - t0) * 1e3
    flat = iter(grads)
    g_tree = tree_map(lambda _: next(flat), params)
    t0 = time.perf_counter()
    _, holder["state"], _ = opt.update(g_tree, holder["state"], params)
    torch.cuda.synchronize(dev)
    opt_ms = (time.perf_counter() - t0) * 1e3

    def opt_step():        # on the same (already clipped) grads
        _, holder["state"], _ = opt.update(g_tree, holder["state"], params)
    _, _, opt_dev_ms, opt_launch = top_device_ops(opt_step)
    del grads, g_tree, flat
    bound = max(work["ops_ms"], work["bytes_ms"])
    phase_bound = work["ops_ms"] + work["optimizer_bytes_ms"]
    busy = dev_ms / wall_ms
    print(f"train step ({card}): {wall_ms:.2f} ms (host clock, synchronised)"
          f"; under the profiler {n_launch} kernel launches, device time "
          f"{dev_ms:.2f} ms (busy share {busy:.3f} of the step); forward + "
          f"backward {fb_ms:.2f} ms, optimizer {opt_ms:.2f} ms (host clock, "
          f"each synchronised); the optimizer alone under the profiler: "
          f"{opt_launch} launches, {opt_dev_ms:.2f} ms device")
    for name, ms, n in ops:
        print(f"  op {name}: {ms:.4f} ms device, {n} calls")
    for name, ms, n in kernels:
        print(f"  kernel {name[:90]}: {ms:.4f} ms, {n} launches")
    print(f"train step bound: {work['matmul_flops']:.4g} bf16 FLOP of "
          f"weight products over {BF16_FLOP_PER_S:.4g} FLOP/s + "
          f"{work['attention_flops']:.4g} float32 FLOP of attention over "
          f"{F32_FLOP_PER_S:.4g} = {work['ops_ms']:.3f} ms; {work['io_bytes']}"
          f" bytes (parameters, mu and nu read and written once) = "
          f"{work['bytes_ms']:.3f} ms; bound {bound:.3f} ms by "
          f"{'operations' if work['ops_ms'] >= work['bytes_ms'] else 'bytes'}"
          f", {bound / step_ms:.4f} of the median step; fwd/bwd by "
          f"operations + the optimizer's pass by bytes as coded "
          f"({work['optimizer_bytes']} bytes, {work['optimizer_bytes_ms']:.3f}"
          f" ms) = {phase_bound:.3f} ms, {phase_bound / step_ms:.4f} of the "
          f"median step")
    train_losses, train_norms = res.losses, res.grad_norms
    first_loss = train_losses[0]
    del params, state, holder, res, batch, step, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (p) one full-width step at microbatches=2 against microbatches=1
    tc2 = dataclasses.replace(tc, steps=1, microbatches=2)
    res2 = fit(cfg, tc2, device=dev, log=lambda s: None)
    peak_mb2 = torch.cuda.max_memory_allocated(dev)
    d_mb = abs(res2.losses[0] - first_loss)
    print(f"check (p): first loss at microbatches=2 {res2.losses[0]:.6f}, "
          f"at 1 {first_loss:.6f}, difference {d_mb:.3g} (limit "
          f"{TRAIN_MB_TOL})")
    if not d_mb < TRAIN_MB_TOL:
        fail(f"(p) microbatched first loss differs by {d_mb}")
    del res2
    gc.collect()
    torch.cuda.empty_cache()

    # (n) reduced float32 copy, 3 steps, card against CPU, TF32 off
    small = dataclasses.replace(cfg.reduced(), dtype="float32",
                                param_dtype="float32")
    s_tc = TrainConfig(steps=3, batch=4, seq_len=32, lr=1e-3, warmup=2,
                       log_every=100)
    s_model = build_model(small)
    p_cpu = s_model.init(torch.Generator().manual_seed(0), device="cpu")
    p_gpu = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
    runs = {}
    with no_tf32():
        for name, p, d in (("cpu", p_cpu, torch.device("cpu")),
                           ("gpu", p_gpu, dev)):
            s_opt = make_optimizer(small, s_tc)
            st = s_opt.init(p)
            s_step = _local_step(s_model, s_opt, 1)
            losses, norms = [], []
            for i in range(3):
                b = batch_to_device(synth_batch(small, i, 4, 32), d)
                if i == 0 and name == "cpu":
                    g0 = _grads(s_model, p, tree_leaves(p), b)[1]
                p, st, m = s_step(p, st, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            runs[name] = (losses, norms, p)
    (l_c, n_c, p_c), (l_g, n_g, p_g) = runs["cpu"], runs["gpu"]
    lr_max = s_tc.lr
    p_err, p_all = 0.0, 0.0
    for a, b, g in zip(tree_leaves(p_g), tree_leaves(p_c), g0):
        d = (a.detach().cpu() - b.detach()).abs()
        p_all = max(p_all, float(d.max()))
        p_err = max(p_err, float(torch.where(g.abs() >= 1e-6, d, 0).max()))
    ok_n = (np.allclose(l_g, l_c, rtol=TRAIN_F32_TOL, atol=TRAIN_F32_TOL)
            and np.allclose(n_g, n_c, rtol=TRAIN_F32_TOL, atol=TRAIN_F32_TOL)
            and p_err <= TRAIN_F32_PARAM_TOL and p_all <= 2 * lr_max * 3)
    print(f"check (n): reduced float32 copy, 3 steps, card vs CPU (TF32 "
          f"off): losses {l_g} vs {l_c}, grad norms {n_g} vs {n_c} (atol = "
          f"rtol = {TRAIN_F32_TOL}); parameters max abs diff {p_err:.3g} "
          f"where |g| >= 1e-6 (limit {TRAIN_F32_PARAM_TOL}), {p_all:.3g} "
          f"anywhere (limit {2 * lr_max * 3:.3g}): {ok_n}")
    if not ok_n:
        fail("(n) the card and the CPU disagree on the float32 train steps")

    # (o) 2 steps + AsyncCheckpointer save + resume 2 == 4 uninterrupted
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    common = dict(batch=4, seq_len=32, lr=1e-3, warmup=2, log_every=100,
                  schedule_steps=4, ckpt_every=100)
    quiet = lambda s: None  # noqa: E731
    try:
        full = fit(small, TrainConfig(steps=4, **common), device=dev,
                   log=quiet)
        first = fit(small, TrainConfig(steps=2, ckpt_dir=str(TRAIN_CKPT_DIR),
                                       **common), device=dev, log=quiet)
        saved = {"params": first.params, "opt": first.opt_state}
        back = store.restore(TRAIN_CKPT_DIR, 2, saved)
        bitwise = all(a.dtype == b.dtype and torch.equal(a, b.detach())
                      for a, b in zip(tree_leaves(back), tree_leaves(saved)))
        second = fit(small, TrainConfig(steps=4, ckpt_dir=str(TRAIN_CKPT_DIR),
                                        **common), device=dev, log=quiet)
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    same = np.allclose(full.losses[2:], second.losses,
                       rtol=TRAIN_RESUME_RTOL, atol=0)
    print(f"check (o): 4 steps {full.losses}; 2 steps "
          f"{first.losses} + resumed {second.losses} (rtol "
          f"{TRAIN_RESUME_RTOL}: {same}); restored tensors equal to the "
          f"saved ones bit for bit: {bitwise}")
    if not (same and bitwise):
        fail("(o) the resumed run differs from the uninterrupted one")
    wall = time.perf_counter() - t_phase
    print(f"phase 10 took {wall:.1f} s")
    return dict(arch=TRAIN_ARCH, layers=cfg.n_layers, params=work["params"],
                batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
                losses=train_losses, grad_norms=train_norms,
                step_ms=step_ms,
                tokens_per_s=tok_s, peak_bytes=peak,
                peak_bytes_microbatches_2=peak_mb2,
                launches_per_step=n_launch, device_ms_per_step=dev_ms,
                profiled_step_ms=wall_ms, busy_share=busy,
                fwd_bwd_ms=fb_ms, optimizer_ms=opt_ms,
                optimizer_device_ms=opt_dev_ms,
                optimizer_launches=opt_launch,
                bound_ms=bound,
                bound_by="operations" if work["ops_ms"] >= work["bytes_ms"]
                else "bytes", bound_ratio=bound / step_ms,
                phase_bound_ms=phase_bound,
                phase_bound_ratio=phase_bound / step_ms,
                top_ops=[[n, ms, c] for n, ms, c in ops[:5]],
                repeated_batch_losses=rep, mb2_first_loss_diff=d_mb,
                n_max_abs=p_err, seconds=wall,
                checks={"m": True, "n": True, "o": True, "p": True})


def start_dryruns(extra=()):
    """The dry run of each of DRYRUN_CELLS in a process of its own, its
    output to a log beside its record."""
    import os
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = []
    for arch, shape, mesh in DRYRUN_CELLS:
        log = open(DRYRUN_DIR / f"{arch}__{shape}__{mesh}.log", "w")
        procs.append((arch, shape, mesh, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out",
             str(DRYRUN_DIR), *extra], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)))
    return procs


def stop_dryruns(procs) -> None:
    for *_, log, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def finish_dryruns(procs, card: str):
    """(t): wait for the dry runs and print what each record holds."""
    from repro_torch.launch import roofline
    out = {}
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    for arch, shape, mesh, log, p in procs:
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            fail(f"(t) the dry run of {arch} {shape} {mesh} took over "
                 f"{DRYRUN_TIMEOUT_S} s")
        log.flush()
        path = DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if rc != 0 or not rec.get("ok"):
            tail = (DRYRUN_DIR / f"{arch}__{shape}__{mesh}.log").read_text()
            fail(f"(t) dry run {arch} {shape} {mesh}: rc {rc}, "
                 f"{rec.get('error', '')}\n{rec.get('traceback', '')}\n"
                 f"{tail[-3000:]}")
        r = roofline.from_record(rec)
        c = rec["cost"]
        print(f"check (t): dry run {arch} {shape} on {rec['mesh']} "
              f"({rec['n_devices']} ranks, fake backend, run on this "
              f"machine's CPU in {rec['step_s']} s at depths "
              f"{rec['depths_run']}, microbatches {rec['microbatches_run']}"
              f"): ok {rec['ok']}; per device: parameters "
              f"{rec['param_bytes_per_device']:.6g} bytes, {c['flops']:.6g} "
              f"FLOPs, {c['bytes']:.6g} bytes moved, collectives "
              f"{c['collective_counts']} ({c['collective_wire_bytes']:.6g} "
              f"wire bytes), memory peak {rec['memory']['cpu']['Total']} "
              f"bytes; roofline (H100 data sheet): compute {r.compute_s:.6g}"
              f" s, memory {r.memory_s:.6g} s, collective "
              f"{r.collective_s:.6g} s, dominant {r.dominant}, MODEL/counted"
              f" {r.usefulness:.4f}; model FLOPs {rec['model_flops']:.6g}")
        out[f"{arch}/{shape}/{mesh}"] = dict(
            ok=rec["ok"], mesh=rec["mesh"], seconds=rec["step_s"],
            param_bytes_per_device=rec["param_bytes_per_device"],
            flops=c["flops"], bytes=c["bytes"],
            collective_counts=c["collective_counts"],
            collective_wire_bytes=c["collective_wire_bytes"],
            memory_peak_bytes=rec["memory"]["cpu"]["Total"],
            compute_s=r.compute_s, memory_s=r.memory_s,
            collective_s=r.collective_s, dominant=r.dominant)
    return out


def mesh_training(dev, mesh, card: str, training: dict):
    """(q): phase 10's training through ``fit(ctx=...)`` on the mesh."""
    import statistics
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.launch.steps import build_train_step, make_ctx, place
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import (TrainConfig, batch_to_device, fit,
                                        make_optimizer)

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(TRAIN_ARCH)
    ctx = make_ctx(mesh, None, cfg)
    tc = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     lr=TRAIN_LR, warmup=TRAIN_WARMUP, log_every=TRAIN_STEPS)
    res = fit(cfg, tc, ctx=ctx, device=dev)
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = statistics.median(res.step_times[1:]) * 1e3
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    d_loss = max(abs(a - b) for a, b in zip(res.losses, training["losses"]))
    print(f"mesh training ({card}): fit(ctx) on a (1, 1) mesh, {TRAIN_ARCH}"
          f" at full width, phase 10's settings and batches: losses "
          f"{[round(x, 4) for x in res.losses]} against phase 10's "
          f"{[round(x, 4) for x in training['losses']]} (max diff "
          f"{d_loss:.3g}, limit {TRAIN_MB_TOL}); median step {step_ms:.2f} "
          f"ms (phase 10 {training['step_ms']:.2f}), {tok_s:.1f} tokens/s "
          f"(phase 10 {training['tokens_per_s']:.1f}), peak memory {peak} "
          f"bytes (phase 10 {training['peak_bytes']})")
    if not (all(np.isfinite(res.losses)) and d_loss <= TRAIN_MB_TOL):
        fail(f"(q) the sharded losses {res.losses} differ from phase 10's "
             f"{training['losses']}")

    model = build_model(cfg, ctx)
    opt = make_optimizer(cfg, tc)
    step1 = build_train_step(model, ctx, opt, 1)
    step2 = build_train_step(model, ctx, opt, 2)
    b = batch_to_device(synth_batch(cfg, TRAIN_STEPS, TRAIN_BATCH,
                                    TRAIN_SEQ), dev)
    batch = place(b, ctx.batch_spec(b))
    holder = {"p": res.params, "s": res.opt_state}
    losses = res.losses
    del res

    def one_step():
        holder["p"], holder["s"], holder["m"] = step1(holder["p"],
                                                      holder["s"], batch)
    ops, kernels, dev_ms, n_launch = top_device_ops(one_step)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy = dev_ms / wall_ms
    # microbatches=2 against microbatches=1 from the same parameters: the
    # loss at them, forward only, then the microbatched step's
    with torch.no_grad():
        l1 = float(model.loss(holder["p"], batch).full_tensor())
    holder["p"], holder["s"], m2 = step2(holder["p"], holder["s"], batch)
    l2 = float(m2["loss"])
    print(f"mesh train step ({card}): {wall_ms:.2f} ms (host clock, "
          f"synchronised; phase 10 {training['profiled_step_ms']:.2f}); "
          f"under the profiler {n_launch} kernel launches (phase 10 "
          f"{training['launches_per_step']}), device time {dev_ms:.2f} ms "
          f"(phase 10 {training['device_ms_per_step']:.2f}), busy share "
          f"{busy:.3f} (phase 10 {training['busy_share']:.3f})")
    for name, ms, n in ops[:5]:
        print(f"  op {name}: {ms:.4f} ms device, {n} calls")
    print(f"check (q): microbatches=2 through build_train_step: loss "
          f"{l2:.6f}; microbatches=1 at the same parameters {l1:.6f}, "
          f"difference {abs(l2 - l1):.3g} (limit {TRAIN_MB_TOL})")
    if not (np.isfinite(l2) and abs(l2 - l1) <= TRAIN_MB_TOL):
        fail(f"(q) the microbatched step's loss {l2} against {l1}")
    del holder, batch, b, m2
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, tokens_per_s=tok_s,
                peak_bytes=peak, launches_per_step=n_launch, device_ms_per_step=dev_ms,
                profiled_step_ms=wall_ms, busy_share=busy,
                max_loss_diff=d_loss, mb2_loss=l2, mb1_loss=l1)


def logit_ratio(got, want) -> float:
    """Largest difference over the largest reference logit."""
    from torch.distributed.tensor import DTensor
    if isinstance(got, DTensor):
        got = got.full_tensor()
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def mesh_decode(dev, mesh, card: str, scorer: dict):
    """(r): shard_prefill and shard_decode against the unsharded model, and
    the MoE decode step weight-stationary off and on."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch.steps import (make_ctx, place, shard_decode,
                                          shard_prefill)
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.specs import cache_shardings, param_shardings

    cfg = get_config(ARCH)
    ctx = make_ctx(mesh, None, cfg)
    model, sharded = build_model(cfg), build_model(cfg, ctx)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(3)
    B, pos = 8, FAMILY_STEP_POS
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, pos)),
                                       dtype=torch.long, device=dev)}
    out = {}
    with torch.inference_mode():
        lg_p, cache_p = model.prefill(params, batch)
        pre, (_, pshard) = shard_prefill(sharded, ctx, {
            k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()})
        psh = place(params, pshard)
        lg_ps, _ = pre(psh, batch)
        r_pre = logit_ratio(lg_ps, lg_p)
        cache = model.init_cache(B, LM_MAX_SEQ, device=dev)
        for run, got in zip(cache["runs"], cache_p):
            for k in run:
                run[k][:, :, :pos] = got[k]
        tok = lg_p.float().argmax(-1)
        want, _ = model.decode_step(params, {"runs": [
            {k: t.clone() for k, t in run.items()} for run in cache["runs"]]},
            tok, pos)
        dec, (_, cstruct, _, _) = shard_decode(sharded, ctx, B, LM_MAX_SEQ)
        csh = place(cache, cache_shardings(cstruct, cfg, ctx))
        got, _ = dec(psh, csh, tok, pos)
        r_dec = logit_ratio(got, want)
        step_ms = cuda_ms(lambda: dec(psh, csh, tok, pos), 10)
        _, _, dev_ms, n_launch = top_device_ops(
            lambda: dec(psh, csh, tok, pos))
    print(f"check (r): {ARCH} at full width, B = {B}: shard_prefill of "
          f"{pos} tokens against prefill, last-token logits within "
          f"{r_pre:.5f} of the largest; shard_decode at pos {pos} against "
          f"decode_step within {r_dec:.5f} (limit {BF16_REL_TOL})")
    print(f"mesh decode step ({card}), B = {B}, pos {pos}: {step_ms:.4f} ms "
          f"(CUDA events, 10 steps; phase 6 {scorer['decode_step_ms_b8']:.4f}"
          f"), {n_launch} kernel launches (phase 6 "
          f"{scorer['decode_step_launches']}), device time {dev_ms:.4f} ms "
          f"(phase 6 {scorer['decode_step_device_ms']:.4f})")
    if not (r_pre <= BF16_REL_TOL and r_dec <= BF16_REL_TOL):
        fail("(r) the sharded prefill or decode step disagrees")
    out.update(prefill_ratio=r_pre, decode_ratio=r_dec,
               decode_step_ms=step_ms, decode_step_launches=n_launch,
               decode_step_device_ms=dev_ms)
    del params, psh, cache, csh, cache_p, lg_p, lg_ps, want, got
    gc.collect()
    torch.cuda.empty_cache()

    # the MoE decode step through moe_forward, weight-stationary off and on
    mcfg = dataclasses.replace(get_config(MESH_MOE_ARCH),
                               n_layers=MESH_MOE_LAYERS)
    mctx = make_ctx(mesh, None, mcfg)
    p = build_model(mcfg).init(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    p = place(p, param_shardings(p, mcfg, mctx))
    tok = torch.as_tensor(rng.integers(0, mcfg.vocab, (B, 1)),
                          dtype=torch.long, device=dev)
    logits, times = {}, {}
    with torch.inference_mode():
        for ws in (False, True):
            c = dataclasses.replace(mctx, moe_weight_stationary=ws)
            m = build_model(mcfg, c)
            cache = place(m.init_cache(B, FAMILY_MAX_SEQ, device=dev),
                          cache_shardings(m.cache_struct(B, FAMILY_MAX_SEQ),
                                          mcfg, c))
            lg, _ = m.decode_step(p, cache, tok, pos)
            logits[ws] = lg.full_tensor()
            times[ws] = cuda_ms(lambda: m.decode_step(p, cache, tok, pos), 5)
            del cache
    same = torch.equal(logits[False], logits[True])
    d = float((logits[False].float() - logits[True].float()).abs().max())
    print(f"check (r): {MESH_MOE_ARCH} ({MESH_MOE_LAYERS} layers, full "
          f"width) decode step at B = {B}, pos {pos} through moe_forward: "
          f"weight-stationary off {times[False]:.4f} ms, on "
          f"{times[True]:.4f} ms (CUDA events, 5 steps); logits equal "
          f"{same} (max abs diff {d:.3g})")
    if not same:
        fail("(r) the weight-stationary MoE body disagrees with the other")
    del p, logits
    gc.collect()
    torch.cuda.empty_cache()
    out.update(moe_step_ms={"ws_off": times[False], "ws_on": times[True]},
               moe_equal=same)
    return out


def mesh_serving(dev, mesh, engine, queries, card: str):
    """(s): build(ServeConfig(mesh=...)) behind phase 4's engine."""
    import dataclasses
    import numpy as np
    from repro_torch.kernels.rule_match import rule_match
    from repro_torch.serve import ServeConfig, Server, build

    cfg = ServeConfig(model=ARCH, reduced=False, device=dev,
                      rule_filter=engine, mesh=mesh, target_batch=8,
                      deadline=0.01, max_seq=LM_MAX_SEQ,
                      warmup=(1, 2, 4, 8))
    srv = build(cfg)
    reqs, expect_drop = scorer_requests(engine, queries,
                                        srv.engine.cfg.vocab)
    sync = Server(srv.group, dataclasses.replace(cfg, cache=None,
                                                 trace=None))
    sync_out = sync.serve(reqs, mode="sync")
    rule_match.launches = 0
    t0 = time.perf_counter()
    mesh_out = srv.serve(reqs, mode="pipelined")
    wall = time.perf_counter() - t0
    launches = rule_match.launches
    by_sync = {c.rid: c.tokens for c in sync_out}
    by_mesh = {c.rid: c.tokens for c in mesh_out}
    ids = {r.rid for r in reqs}
    same = sorted(by_sync) == sorted(by_mesh) and all(
        np.array_equal(by_sync[r], by_mesh[r]) for r in by_sync)
    drops = ids - set(by_mesh)
    print(f"check (s): build(ServeConfig(mesh=(1, 1))) -> "
          f"{len(srv.group.replicas)} replica on "
          f"{[str(d) for d in srv.group.replicas[0].devices]}; "
          f"{len(mesh_out)} served in {wall:.3f} s ({card}), dropped "
          f"{sorted(drops)} (sync {sorted(ids - set(by_sync))}, "
          f"cpu_match_numpy {sorted(expect_drop)}); tokens equal to sync "
          f"{same}; rule-match launches {launches}")
    if not (same and drops == ids - set(by_sync) == expect_drop
            and launches > 0):
        fail("(s) the mesh-built group disagrees with the sync baseline")
    del srv, sync
    gc.collect()
    return dict(replicas=1, served=len(mesh_out), dropped=len(drops),
                seconds=wall, launches=launches)


def phase_mesh(dev, engine, queries, card: str, training: dict,
               scorer: dict):
    """Phase 11: checks (q)-(t); the dry runs run meanwhile."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh

    t_phase = time.perf_counter()
    procs = start_dryruns()
    try:
        init_distributed(dev.type)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), dev.type)
            print(f"phase 11: {dist.get_backend()} group of "
                  f"{dist.get_world_size()} rank, mesh {mesh}")
            q = mesh_training(dev, mesh, card, training)
            r = mesh_decode(dev, mesh, card, scorer)
            s = mesh_serving(dev, mesh, engine, queries, card)
        finally:
            dist.destroy_process_group()
        t = finish_dryruns(procs, card)
    finally:
        stop_dryruns(procs)
    wall = time.perf_counter() - t_phase
    print(f"phase 11 took {wall:.1f} s")
    return dict(training=q, decode=r, serving=s, dryrun=t, seconds=wall,
                checks={"q": True, "r": True, "s": True, "t": True})


def phase_figures(dev, bench, card: str, deploy: dict):
    """Phase 12: the paper's figures on the card through the harnesses:
    fig 4 on 160k v1 and v2 rules, fig 12 on phase 4's rule set, fig 13's
    load sweep and inset on the full-width route scorer, and the roofline
    table over phase 11's dry-run records; checks (u)-(x)."""
    import numpy as np
    import torch
    import torch_fig4_throughput as fig4
    import torch_fig12_cpu_accel as fig12
    import torch_fig13_endtoend as fig13
    import torch_roofline_table as roofline
    import torch_run
    from repro_torch.kernels import ops
    from repro_torch.kernels.rule_match import rule_match

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    v1 = bench.system(1)
    bench.engine(1)
    print(f"phase 12: v1 rule set, {N_RULES} rules -> R={v1.table.n_rules} "
          f"C={v1.table.n_cols}, {FIG_QUERIES} queries, built in "
          f"{time.perf_counter() - t0:.1f} s")

    rule_match.launches = 0
    qps, outputs = fig4.run(bench, repeats=FIG4_REPEATS)
    launches = {"fig4": rule_match.launches}
    bmax = max(fig4.BATCHES)
    for v in fig4.VERSIONS:                                       # (u)
        q = torch.as_tensor(bench.system(v).encoded[:bmax], device=dev)
        want = [x.cpu().numpy()
                for x in ops.match_rules(q, bench.engine(v).dt,
                                         backend="ref")]
        for (vv, e, b), got in outputs.items():
            if vv == v and not all(np.array_equal(g, w[:b])
                                   for g, w in zip(got, want)):
                fail(f"(u) fig 4 v{v} n_engines={e} B={b} differs from "
                     "the plain version on the card")
    if launches["fig4"] <= 0:
        fail("(u) fig 4 launched no kernel")
    ratio = next(r for r in bench.results
                 if r["name"] == "fig4/v2_vs_v1_saturated")
    print(f"check (u): fig 4's {len(outputs)} points equal the plain "
          f"version on the card and each other across n_engines "
          f"{fig4.ENGINES}; {launches['fig4']} kernel launches; v2/v1 "
          f"saturated {ratio['ratio']:.4f}, quartile range "
          f"{ratio['ratio_lo']:.4f}-{ratio['ratio_hi']:.4f} (paper 0.80)")

    rule_match.launches = 0
    f12 = fig12.run(bench, n_users=FIG12_USERS)
    launches["fig12"] = rule_match.launches
    bad = [r for r in f12["rows"] if r["kernel_launches"] != r["calls"]]
    if bad or not f12["rows"]:                                    # (v)
        fail(f"(v) fig 12: kernel launches differ from paper_policy's "
             f"calls on {bad}")
    print(f"check (v): fig 12's CUDA, partitioned and cpu_match_numpy "
          f"paths agree on {len(f12['rows'])} user queries; calls a user "
          f"query {[r['calls'] for r in f12['rows']]} (paper_policy), "
          f"crossover {f12['crossover']}; {launches['fig12']} launches")

    t0 = time.perf_counter()
    # (w): card_sections raises if the inset's pipelined tokens differ
    f13 = fig13.card_sections(bench, long_n=FIG13_LONG_N)
    gc.collect()
    torch.cuda.empty_cache()
    inset = f13["inset"]
    print(f"fig 13 ({card}): {fig13.ARCH} at full width in {f13['dtype']}, "
          f"{time.perf_counter() - t0:.1f} s; capacity "
          f"{f13['capacity_qps']:.4f} requests/s at batch 8")
    for pt in f13["load"]:
        print(f"  {pt['fraction']:g}x, {pt['n_offered']} requests: offered "
              f"{pt['offered_qps']:.4f}, achieved {pt['achieved_qps']:.4f} "
              f"requests/s over {pt['span_s']:.4f} s; execute_idle "
              f"{pt['execute_idle']:.4f}; {pt['n_batches']} batches, mean "
              f"{pt['mean_batch']:.4f}, sizes {pt['batch_hist']}, "
              f"{pt['batch_ms']:.4f} ms a batch; rejected "
              f"{pt['n_rejected']}")
    print(f"check (w): fig 13 inset, {len(inset['sync'])} requests, "
          f"pipelined tokens equal sync; sync {inset['sync_s']:.4f} s, "
          f"pipelined {inset['pipelined_s']:.4f} s")

    rows = roofline.run(bench, art_dir=DRYRUN_DIR)

    # (x): every suite ran and has the reference's row names (fig 13: its
    # load sweep and inset, the parts that run on the card)
    suites = ("fig4", "fig6", "fig7_10", "fig11", "fig12", "fig13",
              "table2", "roofline")
    path = torch_run.write_json(ROOT / "build" / "torch_bench.json", bench,
                                suites, [])
    results = json.loads(path.read_text())["results"]
    missing = []
    for suite in suites:
        names = torch_run.reference_rows(suite)
        if suite == "fig13":
            names = [n for n in names if n.startswith(("fig13_load_",
                                                       "fig13_pipeline"))]
        missing += torch_run.missing_rows(results, names)
    if missing or not rows:                                       # (x)
        fail(f"(x) rows missing from {path}: {missing}; roofline rows "
             f"{len(rows)}")
    print(f"check (x): {len(results)} rows of {len(suites)} suites in "
          f"{path.relative_to(ROOT)}, every reference row name present")
    wall = time.perf_counter() - t_phase
    print(f"phase 12 took {wall:.1f} s")
    return dict(
        card=card, seconds=wall, launches=launches,
        fig4_qps={f"v{v}_e{e}_b{b}": x for (v, e, b), x in qps.items()},
        fig4_v2_vs_v1_saturated=ratio["ratio"],
        fig4_v2_vs_v1_quartile_range=[ratio["ratio_lo"],
                                      ratio["ratio_hi"]],
        fig6_launches=deploy["launches_fig6"],
        fig12=[{k: r[k] for k in ("n_mct", "calls", "cpu_us",
                                  "partitioned_us", "kernel_us")}
               for r in f12["rows"]],
        fig12_crossover=f12["crossover"],
        fig13_capacity_qps=f13["capacity_qps"],
        # execute_idle: the replica's execute-stage idle share, which on
        # the card includes the host's launches; not the card's idle share
        fig13_load=[{k: pt[k] for k in (
            "fraction", "n_offered", "offered_qps", "achieved_qps",
            "span_s", "execute_idle", "n_batches", "mean_batch",
            "batch_hist", "batch_ms", "n_rejected", "p50_ms", "p99_ms")}
            for pt in f13["load"]],
        fig13_inset={k: inset[k] for k in ("sync_s", "pipelined_s",
                                           "tokens_equal")},
        roofline={f"{r.arch}/{r.shape}/{r.mesh}": r.dominant for r in rows},
        checks={k: True for k in "uvwx"})


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: chip_smoke.py drives the port on the card only")
    from repro_torch.kernels import rule_match as rm
    import torch_common as tc

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    card = nvidia_smi("name,power.limit")
    print(card)

    rm.build()
    print(f"build: {rm.build_info['seconds']:.1f} s -> {rm.build_info['path']}")
    for line in rm.build_info["log"].splitlines():
        if any(k in line for k in ("entry function", "registers", "spill",
                                   "smem")):
            print(f"  ptxas: {line.strip()}")

    worst = phase_kernel_vs_plain(dev)
    if worst != 0:
        fail(f"kernel disagrees with its plain version (max_abs_err {worst})")

    ruleset, engine, all_enc, queries, launches, qps = phase_main_path(
        dev, N_RULES, n_users=16, n_check=2048)
    timed = phase_kernel_time(dev, engine, all_enc)
    worst = max([worst] + [r["max_abs_err"] for r in timed])
    if worst != 0:
        fail(f"kernel disagrees with its plain version (max_abs_err {worst})")
    t0 = time.perf_counter()
    scorer = phase_route_scorer(dev, engine, queries, card)
    t1 = time.perf_counter()
    # the figure harnesses' bench: phase 4's rule set and engine, the
    # reference's generate_queries queries
    bench = tc.Bench(dev, N_RULES, FIG_QUERIES)
    bench.systems[2] = tc.with_queries(ruleset, engine.table, FIG_QUERIES)
    bench.engines[2] = engine
    deploy = phase_deployment(bench, timed, card)
    print(f"phase 6 took {t1 - t0:.1f} s, phase 7 "
          f"{time.perf_counter() - t1:.1f} s")
    serving = phase_serving(dev, engine, queries, card)
    families = phase_families(dev, engine, queries, card)
    training = phase_training(dev, card)
    mesh = phase_mesh(dev, engine, queries, card, training, scorer)
    figures = phase_figures(dev, bench, card, deploy)
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    family_launches = {f"family_{a}": r["launches"]
                       for a, r in families["models"].items()
                       if "launches" in r}
    print(json.dumps({"deployment": deploy}))
    print(json.dumps({"route_scorer": {"card": card, **{
        k: scorer[k] for k in ("batches", "requests", "served", "dropped",
                               "tokens_per_s", "decode_step_ms_b8",
                               "decode_step_launches",
                               "decode_step_device_ms",
                               "decode_step_bound_ms", "peak_bytes",
                               "checks")}}}))
    print(json.dumps({"serving": {"card": card, **serving}}))
    print(json.dumps({"families": {"card": card, **families}}))
    print(json.dumps({"training": {"card": card, **training}}))
    print(json.dumps({"mesh": {"card": card, **mesh}}))
    print(json.dumps({"figures": figures}))
    t = next(r for r in timed if r["B"] == 1024)
    print(json.dumps({"kernels": [{
        "name": "rule_match", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches + scorer["launches"] + serving["launches"]
        + sum(family_launches.values()) + mesh["serving"]["launches"]
        + deploy["launches_fig6"] + deploy["launches_stage_times"]
        + sum(figures["launches"].values()),
        "launches_by_path": {"mct_wrapper": launches,
                             "route_scorer": scorer["launches"],
                             "serving_sync": serving["launches_sync"],
                             "serving_pipelined":
                                 serving["launches_pipelined"],
                             "serving_cached": serving["launches_cached"],
                             "serving_live": serving["launches_live"],
                             **family_launches,
                             "serving_mesh": mesh["serving"]["launches"],
                             "fig6": deploy["launches_fig6"],
                             "fig7_11_stage_times":
                                 deploy["launches_stage_times"],
                             **figures["launches"]},
        "exact": True,
        "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "plain_packed_ms": t["plain_packed_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "shape": {"B": t["B"], "R": t["R"], "C": t["C"]},
        "ms_by_B": {str(r["B"]): r["ms"] for r in timed},
        "bound_ms_by_B": {str(r["B"]): r["bound_ms"] for r in timed},
        "main_path_queries_per_s": qps}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
