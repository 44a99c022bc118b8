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
  7. the paper's deployment analysis from this card's numbers: stage times
     at B = 256, 1024, 4096, the fig 7-10 series and the fig 11 Pareto
     front, tables 2 and 3 (table 2 within 3% of the paper), and the H100
     cost balance from the measured host and card rates;
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
     BottleneckMonitor's class.
It then prints JSON lines for phases 7, 6 and 8 and the kernels and, last,
the device line.
Nothing runs without a card: the port's CPU paths are the tests' business.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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
# phase 7: the paper's deployment series at the batch of fig 7-11
DEPLOY_BATCH = 4096
STAGE_BATCHES = (256, 1024, 4096)
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
    return engine, all_enc, queries, launches, n_q / wall


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
            pad = 1 << (len(out) - 1).bit_length()
            pre, dec_ms = out[0].prefill_ms, out[0].decode_ms
            row.update(padded=pad, prefill_ms=pre, decode_ms=dec_ms,
                       tokens_per_s=n_tok / ((pre + dec_ms) / 1e3),
                       prompt_steps=max(len(r.tokens) for r in g
                                        if r.rid in {c.rid for c in out}))
        batches.append(row)
        print(f"route scorer batch ({card}): " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()))
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
    S = prompt.shape[1]
    with torch.inference_mode():
        last, _ = srv.model.prefill(srv.params, {"tokens": prompt})
        cache = srv.model.init_cache(1, S, device=dev)
        for t in range(S):
            lg, cache = srv.model.decode_step(srv.params, cache,
                                              prompt[:, t:t + 1], t)
    a, b = lg.float()[0, 0], last.float()[0, 0]
    diff = float((a - b).abs().max())
    scale = float(b.abs().max())
    gap = float(b.topk(2).values.diff().abs()[0])
    same_top = int(a.argmax()) == int(b.argmax())
    ok_c = (bool(torch.isfinite(a).all()) and diff <= BF16_REL_TOL * scale
            and (same_top or gap <= 2 * diff))
    print(f"check (c): bf16 prefill vs {S} decode steps, last-token logits: "
          f"max abs diff {diff:.5f}, largest logit {scale:.4f}, ratio "
          f"{diff / scale:.5f} (limit {BF16_REL_TOL}); top-2 gap {gap:.5f}, "
          f"same argmax {same_top}")
    if not ok_c:
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
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
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
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
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


def phase_deployment(engine, queries, timed, card: str):
    """The paper's deployment analysis (figs 7-11, tables 2-3) and the H100
    cost balance, from this card's stage times and lane time."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.aggregator import Batch
    from repro_torch.core.deployment import Config, evaluate, pareto, sweep
    from repro_torch.core.wrapper import measure_stage_times

    def make_batch(n):
        return Batch(0, [queries[i % len(queries)] for i in range(n)],
                     [(0, -1)] * n)

    st = measure_stage_times(engine, make_batch, STAGE_BATCHES, repeats=3)
    for t in st:
        print(f"stage times ({card}; median of 3), B = {t.batch}: encode_us "
              f"{t.encode_us:.1f}, dispatch_us {t.dispatch_us:.1f}, "
              f"kernel_us {t.kernel_us:.1f}, collect_us {t.collect_us:.1f}")
    # the configurations of benchmarks/fig7_10_parallel.py and fig11_pareto.py
    series = {
        "fig7_engines": [Config(1, 1, 1, e) for e in (1, 2, 4)],
        "fig8_uniform": [Config(c, c, c, 1) for c in (1, 2, 4)],
        "fig9_workers_per_kernel": [Config(w, w, 1, 4)
                                    for w in (1, 2, 4, 8)],
        "fig10_procs_per_worker": [Config(p, 1, 1, 4)
                                   for p in (1, 2, 8, 16, 32)],
    }
    out = {}
    for name, cfgs in series.items():
        for c in cfgs:
            perf = evaluate(c, st, DEPLOY_BATCH)
            out[(name, c)] = perf
            print(f"{name} {c.label()}: latency {perf.latency_us:.1f} us, "
                  f"{perf.throughput_qps:.4g} queries/s")
    e1 = out[("fig7_engines", Config(1, 1, 1, 1))]
    e4 = out[("fig7_engines", Config(1, 1, 1, 4))]
    p16 = out[("fig10_procs_per_worker", Config(16, 1, 1, 4))]
    p32 = out[("fig10_procs_per_worker", Config(32, 1, 1, 4))]
    print(f"fig7: 4 engines cut latency {e1.latency_us / e4.latency_us:.2f}x;"
          f" fig10: 16 -> 32 processes a worker gain "
          f"{p32.throughput_qps / p16.throughput_qps:.2f}x")
    cfgs = [Config(p, w, k, e)
            for p in (1, 2, 4) for w in (1, 2, 4)
            for k in (1, 2, 4) for e in (1, 2, 4)
            if w >= k and p >= w and k * e <= 4]
    perfs = sweep(cfgs, st, [DEPLOY_BATCH])
    front = pareto(perfs)
    for pf in front:
        print(f"fig11 front {pf.config.label()}: latency "
              f"{pf.latency_us:.1f} us, {pf.throughput_qps:.4g} queries/s")
    top = max(q.throughput_qps for q in perfs)
    floor = min((q for q in perfs if q.throughput_qps >= 0.5 * top),
                key=lambda q: q.latency_us)
    print(f"fig11 best latency at >= half the top throughput: "
          f"{floor.config.label()}, {floor.latency_us:.1f} us, "
          f"{floor.throughput_qps:.4g} queries/s")

    worst = 0.0
    for d in cm.table2():
        want = cm.PAPER_TABLE2_TOTALS[d.name]
        worst = max(worst, abs(d.total_usd / want - 1))
        print(f"table 2 {d.name}: {d.units} x {d.element} = "
              f"${d.total_usd:,.0f} (paper ${want:,.0f})")
    for d in cm.table3():
        print(f"table 3 {d.name}: {d.units} x {d.element} = "
              f"${d.total_usd:,.0f}")
    if worst > 0.03:
        fail(f"table 2 is {worst:.1%} off the paper's totals (limit 3%)")
    print(f"table 2 within {worst:.2%} of the paper's totals (limit 3%)")

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
    balance = {}
    for q in (2e8, 2e9, 2e10):
        balance[f"{q:.0e}"] = r = cm.h100_balance(params, q)
        print(f"h100_balance at {q:.0e} queries/s: " + ", ".join(
            f"{k} {v:.6g}" for k, v in r.items()))
    return dict(stage_times=[vars(t) for t in st],
                host_qps_per_vcpu=params.host_qps_per_vcpu,
                accel_qps_per_chip=params.accel_qps_per_chip,
                balance=balance, table2_worst=worst,
                pareto=[(pf.config.label(), pf.latency_us, pf.throughput_qps)
                        for pf in front])


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card: chip_smoke.py drives the port on the card only")
    from repro_torch.kernels import rule_match as rm

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

    engine, all_enc, queries, launches, qps = phase_main_path(
        dev, N_RULES, n_users=16, n_check=2048)
    timed = phase_kernel_time(dev, engine, all_enc)
    worst = max([worst] + [r["max_abs_err"] for r in timed])
    if worst != 0:
        fail(f"kernel disagrees with its plain version (max_abs_err {worst})")
    t0 = time.perf_counter()
    scorer = phase_route_scorer(dev, engine, queries, card)
    t1 = time.perf_counter()
    deploy = phase_deployment(engine, queries, timed, card)
    print(f"phase 6 took {t1 - t0:.1f} s, phase 7 "
          f"{time.perf_counter() - t1:.1f} s")
    serving = phase_serving(dev, engine, queries, card)
    print(json.dumps({"deployment": deploy}))
    print(json.dumps({"route_scorer": {"card": card, **{
        k: scorer[k] for k in ("batches", "requests", "served", "dropped",
                               "tokens_per_s", "decode_step_ms_b8",
                               "decode_step_launches",
                               "decode_step_device_ms",
                               "decode_step_bound_ms", "peak_bytes",
                               "checks")}}}))
    print(json.dumps({"serving": {"card": card, **serving}}))
    t = next(r for r in timed if r["B"] == 1024)
    print(json.dumps({"kernels": [{
        "name": "rule_match", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches + scorer["launches"] + serving["launches"],
        "launches_by_path": {"mct_wrapper": launches,
                             "route_scorer": scorer["launches"],
                             "serving_sync": serving["launches_sync"],
                             "serving_pipelined":
                                 serving["launches_pipelined"],
                             "serving_cached": serving["launches_cached"],
                             "serving_live": serving["launches_live"]},
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
