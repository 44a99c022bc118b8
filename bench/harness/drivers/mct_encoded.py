"""Closed loop of pre-encoded MCT batches sent straight to
``ErbiumEngine.match``: the paper's "optimal submission", where the
application hands over encoded, aggregated batches.

Traffic parameters: ``callers`` threads, each holding one batch in flight:
it sends a batch of ``batch`` encoded int32 rows (a host array, as the
application holds it) to ``ErbiumEngine.match`` and reads the three answers
back to the host. ``pool_batches`` batches of generated queries are drawn
from ``--seed`` and encoded once in set-up by the program's encoder, and
the callers cycle through them in an order drawn from ``--seed``. One call
in ``keep_every`` (chosen from ``--seed``) keeps its answers for the check;
``check_queries`` of those are judged. ``profile_s`` seconds are profiled
with ``--trace 1``; the trace run then also counts the work of each batch
of the pool (``bench/work/mct.py``) for the lane's roofline.
"""
from __future__ import annotations

import threading
import time
from typing import List

import numpy as np

from bench.harness import inputs
from bench.harness.core import TracedRun
from bench.harness.profile import hold_window
from bench.reference import mct as ref
from bench.work import mct as work

DRAIN_S = 60.0


class Driver:
    GAP_PRIORITY = ("match", "readback", "caller")

    def __init__(self, cell, config, traffic, seed, device, trace):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, \
            device
        self.trace = trace

    def setup(self):
        from repro_torch.core.compiler import compile_rules
        from repro_torch.core.engine import ErbiumEngine
        t = self.tr
        B, n = int(t["batch"]), int(t["pool_batches"])
        self.rules = inputs.rule_set(self.cfg)
        self.engine = ErbiumEngine(compile_rules(self.rules),
                                   device=self.device)
        self.pool = inputs.query_pool(self.rules, B * n, self.seed)
        enc = self.engine.encode_queries_host(self.pool)
        self.batches = [np.ascontiguousarray(enc[i * B:(i + 1) * B])
                        for i in range(n)]
        rng = np.random.default_rng(self.seed)
        self.order = rng.permutation(n)
        self.keep_key = int(rng.integers(1 << 30))
        for b in self.batches:
            [x.cpu() for x in self.engine.match(b)]
        self._lock = threading.Lock()
        self._next = 0
        self._stop = threading.Event()
        self.calls: List[dict] = []
        self._threads = [threading.Thread(target=self._caller, daemon=True)
                         for _ in range(int(t["callers"]))]
        for th in self._threads:
            th.start()
        time.sleep(float(t["warmup_s"]))

    def _caller(self):
        keep_every = int(self.tr["keep_every"])
        while not self._stop.is_set():
            with self._lock:
                k = self._next
                self._next += 1
            bi = int(self.order[k % len(self.order)])
            t_s = time.perf_counter()
            dec, w, rid = self.engine.match(self.batches[bi])
            t_m = time.perf_counter()
            out = (dec.cpu().numpy(), w.cpu().numpy(), rid.cpu().numpy())
            rec = {"batch": bi, "n": len(self.batches[bi]), "t_s": t_s,
                   "t_m": t_m, "t_e": time.perf_counter()}
            if (k * 2654435761 + self.keep_key) % keep_every == 0:
                rec["answers"] = out
            with self._lock:
                self.calls.append(rec)

    def window(self, seconds: float, profile_at) -> TracedRun:
        t0, t1, dev = hold_window(seconds, profile_at,
                                  float(self.tr["profile_s"]), self.device)
        self._stop.set()
        for th in self._threads:
            th.join(timeout=DRAIN_S)
        with self._lock:
            calls = list(self.calls)
        started = [c for c in calls if t0 <= c["t_s"] < t1]
        data = {"calls": calls, "attempted": len(started), "failed": 0}
        return TracedRun(t0, t1, data=data, device=dev)

    def trace_data(self, run: TracedRun) -> None:
        """The lane's bound for the roofline: the work of each batch of the
        pool (``bench/work/mct.py``), counted on the card after the
        window."""
        dense = inputs.dense_rules(self.cfg, self.rules)
        order = [self.cfg["work_order"].index(nm) for nm in dense.names]
        B = int(self.tr["batch"])
        bounds = [work.lane_bound(dense, ref.query_values(
            self.rules, self.pool[i * B:(i + 1) * B]), order=order,
            device=self.device) for i in range(len(self.batches))]
        run.data["lane_bound_s"] = float(np.mean([x["bound_s"]
                                                  for x in bounds]))
        run.data["lane_bound_by"] = sorted({x["by"] for x in bounds})

    def end_to_end(self, run: TracedRun) -> dict:
        n = sum(c["n"] for c in run.data["calls"]
                if run.t0 <= c["t_e"] < run.t1)
        return {"mct_queries_per_s": n / run.seconds}

    def host_spans(self, run: TracedRun):
        out = []
        for c in run.data["calls"]:
            out.append(("match", c["t_s"], c["t_m"]))
            out.append(("readback", c["t_m"], c["t_e"]))
        return out

    def release(self):
        del self.engine

    def check(self, run: TracedRun) -> dict:
        kept = [c for c in run.data["calls"] if "answers" in c
                and run.t0 <= c["t_s"] < run.t1]
        rng = np.random.default_rng([self.seed, 1])
        rows = [(ci, j) for ci, c in enumerate(kept) for j in range(c["n"])]
        n = min(int(self.tr["check_queries"]), len(rows))
        pick = rng.choice(len(rows), n, replace=False) if n else []
        queries, dec, w, rid = [], [], [], []
        short = 0
        B = int(self.tr["batch"])
        for k in sorted(pick):
            ci, j = rows[k]
            c = kept[ci]
            d, ww, r = c["answers"]
            if len(d) != c["n"]:
                short += 1
                continue
            queries.append(self.pool[c["batch"] * B + j])
            dec.append(d[j])
            w.append(ww[j])
            rid.append(r[j])
        wrong = short
        if queries:
            dense = inputs.dense_rules(self.cfg, self.rules)
            wrong += ref.judge(dense, ref.query_values(self.rules, queries),
                               np.array(dec), np.array(w), np.array(rid),
                               device=self.device)
        return {"mct_wrong": (wrong, 0, wrong <= 0 and n > 0)}
