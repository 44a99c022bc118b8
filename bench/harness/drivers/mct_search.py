"""Closed loop of Domain Explorer searches through ``MCTWrapper``.

Traffic parameters (``bench/traffic/<mix>.json``): ``searchers`` threads,
each taking the next user query, forming its ``paper_policy`` batches,
submitting them to one ``MCTWrapper(n_workers=workers)`` over one
``ErbiumEngine`` and waiting for all their answers; ``n_searches`` user
query shapes drawn once from ``shape_seed`` (``mean_ts``, ``direct_frac``,
``mct_per_ts``: the snapshot's statistics), the same for every seed and
taken in an order drawn from ``--seed``; their MCT queries drawn from
``--seed`` out of a pool of ``query_pool`` generated queries;
``warmup_s`` of load before the window; ``check_queries`` answers of the
window checked; ``profile_s`` seconds profiled with ``--trace 1``.

The end-to-end metric is the card's: MCT queries answered in the window
over the seconds in which the card ran any operation in it, from a device
trace of the whole window (``--trace 0``; the profiler starts after
set-up and before the window opens, so neither times its first start).
The host path's own rate and search tail are read per layer
(``bench/metrics/mct_queries_per_s.search.py`` and
``search_p95_ms.search.py``): they follow the host's speed, which on a
shared host swings by a fifth within a run and from run to run.

A router thread takes the wrapper's answers and hands each back to its
searcher by the batch's ``uid``, which the harness numbers.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List

import numpy as np

from bench.harness import gen, inputs
from bench.harness.core import TracedRun
from bench.harness.profile import Recorder, hold_window
from bench.reference import mct as ref

DRAIN_S = 60.0


class Driver:
    GAP_PRIORITY = ("wrapper.dispatch", "wrapper.collect", "wrapper.kernel",
                    "wrapper.encode", "wrapper.queue", "searcher.batching")

    def __init__(self, cell, config, traffic, seed, device, trace):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, \
            device
        self.trace = trace

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from repro_torch.core.compiler import compile_rules
        from repro_torch.core.engine import ErbiumEngine
        from repro_torch.core.wrapper import MCTWrapper
        t = self.tr
        self.rules = inputs.rule_set(self.cfg)
        self.engine = ErbiumEngine(compile_rules(self.rules),
                                   device=self.device)
        self.wrapper = MCTWrapper([self.engine], n_workers=int(t["workers"]))
        self.pool = inputs.query_pool(self.rules, int(t["query_pool"]),
                                      self.seed)
        shapes = gen.search_shapes(
            int(t["n_searches"]), seed=int(t["shape_seed"]),
            mean_ts=float(t["mean_ts"]), direct_frac=float(t["direct_frac"]),
            mean_mct_per_ts=float(t["mct_per_ts"]))
        rng = np.random.default_rng(self.seed)
        self.order = rng.permutation(len(shapes))
        picks = [rng.integers(0, len(self.pool), s.n_mct) for s in shapes]
        # the user queries are inputs: built here, so that the window's
        # interpreter time is the program's
        self.user_queries = [self._user_query(s, p)
                             for s, p in zip(shapes, picks)]
        # every kernel built and both sort paths run before the load starts
        for n in (256, int(t["warm_batch"])):
            enc = self.engine.encode_queries_host(self.pool[:n])
            [x.cpu() for x in self.engine.match(enc)]
        if self.device.type == "cuda" and self.trace:
            # the profiler's first start, which the traced sub-window
            # would otherwise pay inside the window
            with Recorder():
                [x.cpu() for x in self.engine.match(enc)]
        self._lock = threading.Lock()
        self._next = 0
        self._serial = 0
        self._stop = threading.Event()
        self._waiting: Dict[int, list] = {}   # batch uid -> [search, t_sub]
        self.searches: List[dict] = []
        self.batches: List[dict] = []
        self.wrapper.start()
        self._router = threading.Thread(target=self._route, daemon=True)
        self._router.start()
        self._threads = [threading.Thread(target=self._searcher, daemon=True)
                         for _ in range(int(t["searchers"]))]
        for th in self._threads:
            th.start()
        time.sleep(float(t["warmup_s"]))

    # -- the load -------------------------------------------------------------
    def _user_query(self, shape, pick):
        from repro_torch.core.workload import TravelSolution, UserQuery
        sols, off = [], 0
        for c in shape.connections:
            sols.append(TravelSolution(c, [self.pool[j]
                                           for j in pick[off:off + c]]))
            off += c
        return UserQuery(uid=0, required_ts=shape.required_ts,
                         solutions=sols)

    def _searcher(self):
        from repro_torch.core.aggregator import Batch, paper_policy
        while not self._stop.is_set():
            with self._lock:
                i = int(self.order[self._next % len(self.order)])
                self._next += 1
            t_pick = time.perf_counter()
            uq = self.user_queries[i]
            search = {"shape": i, "t_pick": t_pick, "left": 0,
                      "done": threading.Event(), "batches": []}
            plan = paper_policy(uq)
            search["left"] = len(plan)
            t_first = time.perf_counter()
            search["t_first"] = t_first
            with self._lock:
                self.searches.append(search)
            for b in plan:
                with self._lock:
                    uid = self._serial
                    self._serial += 1
                    rec = {"uid": uid, "search": search, "n": len(b.queries),
                           "queries": b.queries, "t_sub": None}
                    self._waiting[uid] = rec
                    self.batches.append(rec)
                    search["batches"].append(rec)
                rec["t_sub"] = time.perf_counter()
                self.wrapper.submit(Batch(uid, b.queries, b.ts_index))
            if not plan:
                search["t_done"] = t_first
                search["done"].set()
            search["done"].wait()

    def _route(self):
        while True:
            try:
                res = self.wrapper.drain(1, timeout=0.2)[0]
            except queue.Empty:
                if self._stop.is_set() and not self._waiting:
                    return
                continue
            t = time.perf_counter()
            with self._lock:
                rec = self._waiting.pop(res.uid)
            rec["t_recv"], rec["result"] = t, res
            s = rec["search"]
            with self._lock:
                s["left"] -= 1
                last = s["left"] == 0
            if last:
                s["t_done"] = t
                s["done"].set()

    def window(self, seconds: float, profile_at) -> TracedRun:
        # without --trace the whole window is profiled, for the card's busy
        # seconds; the profiler stops once no worker launches any more
        whole = Recorder() if profile_at is None \
            and self.device.type == "cuda" else None
        if whole is not None:
            whole.start()
        t0, t1, dev = hold_window(seconds, profile_at,
                                  float(self.tr["profile_s"]), self.device)
        self._stop.set()
        deadline = t1 + DRAIN_S
        for th in self._threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))
        self._router.join(timeout=max(0.0, deadline - time.perf_counter()))
        self.wrapper.stop()
        if whole is not None:
            whole.stop()
            dev = whole.collect()
            dev.t0, dev.t1 = t0, t1
        with self._lock:
            searches = list(self.searches)
            batches = list(self.batches)
        started = [s for s in searches if t0 <= s["t_first"] < t1]
        return TracedRun(t0, t1, device=dev, data={
            "searches": searches, "batches": batches,
            "attempted": len(started),
            "failed": sum(1 for s in started if "t_done" not in s)})

    # -- metrics --------------------------------------------------------------
    @staticmethod
    def answered(run: TracedRun) -> List[dict]:
        """Batches whose answers arrived inside the window."""
        return [b for b in run.data["batches"]
                if "t_recv" in b and run.t0 <= b["t_recv"] < run.t1]

    @staticmethod
    def search_ms(run: TracedRun) -> List[float]:
        """First batch submitted to last answer, of each search finished
        inside the window."""
        return [(s["t_done"] - s["t_first"]) * 1e3
                for s in run.data["searches"]
                if "t_done" in s and run.t0 <= s["t_done"] < run.t1]

    def end_to_end(self, run: TracedRun) -> dict:
        """Queries answered in the window per second of the card's busy
        time in it (the union of its kernels, copies and sets)."""
        dev = run.device
        if dev is None or not dev.aligned:
            return {}
        busy = dev.busy_s()
        n = sum(b["n"] for b in self.answered(run))
        return {"mct_queries_per_busy_s": n / busy} if busy > 0 and n \
            else {}

    def host_spans(self, run: TracedRun):
        out = []
        for b in run.data["batches"]:
            if "result" not in b:
                continue
            st, t = b["result"].times, b["t_recv"]
            for name, us in (("collect", st.collect_us),
                             ("kernel", st.kernel_us),
                             ("dispatch", st.dispatch_us),
                             ("encode", st.encode_us),
                             ("queue", st.queue_us)):
                out.append((f"wrapper.{name}", t - us * 1e-6, t))
                t -= us * 1e-6
        for s in run.data["searches"]:
            out.append(("searcher.batching", s["t_pick"], s["t_first"]))
        return out

    # -- correctness ----------------------------------------------------------
    def release(self):
        del self.engine, self.wrapper

    def check(self, run: TracedRun) -> dict:
        started = [s for s in run.data["searches"]
                   if run.t0 <= s["t_first"] < run.t1]
        missing = sum(1 for s in started if "t_done" not in s)
        due = [b for b in run.data["batches"] if "result" in b
               and run.t0 <= b["t_recv"] < run.t1 + DRAIN_S]
        rng = np.random.default_rng([self.seed, 1])
        rows = [(bi, j) for bi, b in enumerate(due) for j in range(b["n"])]
        n = min(int(self.tr["check_queries"]), len(rows))
        pick = sorted(rng.choice(len(rows), n, replace=False)) if n else []
        queries, dec, w, rid = [], [], [], []
        short = 0
        for k in pick:
            bi, j = rows[k]
            res = due[bi]["result"]
            if len(res.decisions) != due[bi]["n"]:
                short += 1
                continue
            queries.append(due[bi]["queries"][j])
            dec.append(res.decisions[j])
            w.append(res.weights[j])
            rid.append(res.rule_ids[j])
        wrong = short
        if queries:
            dense = inputs.dense_rules(self.cfg, self.rules)
            wrong += ref.judge(dense, ref.query_values(self.rules, queries),
                               np.array(dec), np.array(w), np.array(rid),
                               device=self.device)
        return {"mct_wrong": (wrong, 0, wrong <= 0 and n > 0),
                "searches_missing": (missing, 0, missing <= 0)}
