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
     criterion order, and the least time the card could take.
It then prints one JSON line of kernel results and, last, the device line.
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
    return engine, all_enc, launches, n_q / wall


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
    print(nvidia_smi("name,power.limit"))

    rm.build()
    print(f"build: {rm.build_info['seconds']:.1f} s -> {rm.build_info['path']}")
    for line in rm.build_info["log"].splitlines():
        if any(k in line for k in ("entry function", "registers", "spill",
                                   "smem")):
            print(f"  ptxas: {line.strip()}")

    worst = phase_kernel_vs_plain(dev)
    if worst != 0:
        fail(f"kernel disagrees with its plain version (max_abs_err {worst})")

    engine, all_enc, launches, qps = phase_main_path(
        dev, N_RULES, n_users=16, n_check=2048)
    timed = phase_kernel_time(dev, engine, all_enc)
    worst = max([worst] + [r["max_abs_err"] for r in timed])
    if worst != 0:
        fail(f"kernel disagrees with its plain version (max_abs_err {worst})")
    t = next(r for r in timed if r["B"] == 1024)
    print(json.dumps({"kernels": [{
        "name": "rule_match", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "exact": True,
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
