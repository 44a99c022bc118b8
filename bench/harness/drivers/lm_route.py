"""Closed loop of route-scoring searches through the port's serving stack:
``build(ServeConfig(model=..., rule_filter=ErbiumEngine))`` and one live
session, the MCT filter ahead of the LM.

Configuration (``bench/configs/<config>.json``): a model's published
``config.json`` keys (as cut, ``reduced``), ``arch`` (the port's config
module ``repro_torch.configs.<arch>``, whose ``from_hf`` reads those
keys), ``dtype``, ``reference`` and ``work`` (module names under
``bench/reference/`` and ``bench/work/``: the plain model and its FLOP and
byte counts), ``mct_config`` (the filter's rule table, a configuration of
its own; ``mct_overrides`` patches it, for the CPU tests),
``lm_logits_err_limit`` with its reason ``lm_logits_err_why`` (the limit
set from this configuration's own readings on the card, against its own
controls; no default) and ``counters`` (the ``LMServer`` counters its
per-layer metrics read, each read at the window's open and close into
``run.data["counts"][name]``; one the program lacks is not read).

The reference module gives what the driver takes from the model: the
program's tree in its own layout (``from_port(params, keys)``: ``embed``,
``layers`` and the weights ``logits`` reads; a tied model's head is its
embedding), the pieces ``embed``, ``block`` and ``logits`` run a layer at
a time, ``to_float32``, ``strict_float32``, and the controls:
``CONTROLS`` (each control's weight groups) and ``matrices(params,
groups)``.

Traffic (``bench/traffic/<mix>.json``): ``searchers`` threads, each
submitting one search at a time and waiting for every answer; a search is
``routes`` requests, each a prompt of ``prompt_min``-``prompt_max`` tokens
(log-uniform, ids over the whole vocabulary), ``new_tokens`` greedy
tokens and ``mct_min``-``mct_max`` MCT queries from a pool of
``query_pool``, whose connect times make a share ``infeasible_share`` of
the routes infeasible: every connection of a feasible route is at least
the largest decision among its query's best-weight rules (the plain
reference's ``decision_range``), one connection of an infeasible route is
below the least. ``n_searches`` searches drawn from ``--seed``, cycled;
scheduler knobs ``target_batch``, ``deadline_s``, ``max_seq``;
``warmup_s`` of load before the window; every ``capture_every``-th
request of the window, up to ``capture_max``, is marked for capture;
``profile_s`` seconds profiled with ``--trace 1``.

Checks: ``lm_logits_err``, the largest over the marked and scored routes
and their logit positions (the prefill's last and every decode step's) of
||program - reference|| / ||reference|| over the vocabulary (the
reference's full forward over prompt and generated tokens in float32 from
the program's weights, a layer at a time); ``mct_wrong``, the marked
routes' MCT answers judged by ``bench/reference/mct.py`` plus every
answered route whose fate (scored or dropped) is not the one its connect
times were drawn for; ``searches_missing``.

``control`` (a traffic override, never in a traffic file), one of the
reference module's ``CONTROLS``, rounds the weight matrices of its groups
in the program through float8 e4m3 (with a per-tensor scale) for the
window and restores them for the check. ``lm_logits_err`` must refuse
each.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import threading
import time
from typing import Dict, List

import numpy as np

from bench.harness import core, inputs
from bench.harness.core import TracedRun
from bench.harness.profile import PauseAtSpans, hold_window
from bench.reference import mct as ref_mct

DRAIN_S = 120.0
# what every configuration of this driver states, with no default
REQUIRED = ("lm_logits_err_limit", "lm_logits_err_why")


class Driver:
    GAP_PRIORITY = ("lm.decode", "lm.prefill", "lm.filter")

    def __init__(self, cell, config, traffic, seed, device, trace):
        self.cfg, self.tr, self.seed, self.device = config, traffic, seed, \
            device
        self.trace = trace
        for k in REQUIRED:
            if k not in config:
                raise KeyError(f"configuration {cell['config']!r} states no "
                               f"{k!r}: lm_logits_err's limit comes from "
                               "the configuration's own readings")
        self.limit = float(config["lm_logits_err_limit"])
        self.counters = tuple(config.get("counters", ()))
        # the program's config first: a program without the arch stops here
        mod = importlib.import_module(
            "repro_torch.configs."
            + config["arch"].replace("-", "_").replace(".", "_"))
        self.model_cfg = dataclasses.replace(
            mod.from_hf(config, arch=config["arch"]),
            dtype=config["dtype"], param_dtype=config["dtype"])
        self.ref = importlib.import_module(
            f"bench.reference.{config['reference']}")
        self.work = importlib.import_module(f"bench.work.{config['work']}")
        self.mct_cfg = {**core.load_config(config["mct_config"]),
                        **config.get("mct_overrides", {})}

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from repro_torch.core.compiler import compile_rules
        from repro_torch.core.engine import ErbiumEngine
        from repro_torch.serve import ServeConfig, build
        from repro_torch.serve.trace import TraceConfig
        t = self.tr
        self.rules = inputs.rule_set(self.mct_cfg)
        engine = ErbiumEngine(compile_rules(self.rules), device=self.device)
        self.srv = build(ServeConfig(
            model=self.model_cfg, reduced=False, device=self.device,
            max_seq=int(t["max_seq"]), seed=self.seed, rule_filter=engine,
            target_batch=int(t["target_batch"]),
            deadline=float(t["deadline_s"]),
            max_queue=int(t["searchers"]) * int(t["routes"]) + 1,
            policy="block",
            trace=TraceConfig(capacity=1 << 20) if self.trace else None))
        engine.tracer = self.srv.tracer
        self.lm = self.srv.engine
        # the profiler stops while the thread that launches the scorer's
        # work waits between two stages: stopped while that thread
        # launched, it hung the run on the card
        self._pause = PauseAtSpans(self.srv.tracer, self.GAP_PRIORITY) \
            if self.trace else None
        self._saved = None
        if t.get("control"):
            self._saved = _round_fp8(self.ref.matrices(
                self.lm.params, self.ref.CONTROLS[t["control"]]))
        self._draw_searches()
        # the filter's kernel built and the LM's largest shapes run once
        # (allocator, library handles) before the load starts
        [x.cpu() for x in engine.match(engine.encode_queries_host(
            self.pool[:int(t["target_batch"]) * int(t["mct_max"])]))]
        self.lm.warmup((int(t["target_batch"]),),
                       prompt_len=int(t["prompt_max"]),
                       max_new_tokens=int(t["new_tokens"]))
        self._lock = threading.Lock()
        self._next = 0
        self._serial = 0
        self._open = False
        self._in_window = 0
        self._marked = 0
        self._stop = threading.Event()
        self.routes: Dict[int, dict] = {}
        self.searches: List[dict] = []
        self.session = self.srv.session()
        self.session.on_complete = self._on_complete
        self.session.on_drop = self._on_drop
        self._threads = [threading.Thread(target=self._searcher, daemon=True)
                         for _ in range(int(t["searchers"]))]
        for th in self._threads:
            th.start()
        time.sleep(float(t["warmup_s"]))

    def _draw_searches(self):
        t = self.tr
        pool = inputs.query_pool(self.rules, int(t["query_pool"]), self.seed)
        dense = inputs.dense_rules(self.mct_cfg, self.rules)
        lo, hi = ref_mct.decision_range(
            dense, ref_mct.query_values(self.rules, pool), device=self.device,
            default=self.rules.default_decision)
        rng = np.random.default_rng([self.seed, 7])
        lmin, lmax = math.log(int(t["prompt_min"])), \
            math.log(int(t["prompt_max"]))
        V = self.model_cfg.vocab
        self.pool = pool
        self.search_specs = []
        for _ in range(int(t["n_searches"])):
            routes = []
            for _ in range(int(t["routes"])):
                n = int(round(math.exp(rng.uniform(lmin, lmax))))
                k = int(rng.integers(int(t["mct_min"]), int(t["mct_max"]) + 1))
                qi = rng.integers(0, len(pool), k)
                have = hi[qi] + rng.integers(0, 61, k)
                bad = np.flatnonzero(lo[qi] >= 1)
                infeasible = bool(rng.random() < float(t["infeasible_share"])
                                  and len(bad))
                if infeasible:
                    j = int(rng.choice(bad))
                    have[j] = rng.integers(0, lo[qi[j]])
                routes.append({
                    "tokens": rng.integers(0, V, n).astype(np.int32),
                    "queries": [int(x) for x in qi],
                    "connect": [int(x) for x in have],
                    "feasible": not infeasible})
            self.search_specs.append(routes)
        self.order = rng.permutation(len(self.search_specs))

    # -- the load -------------------------------------------------------------
    def _searcher(self):
        from repro_torch.serve import Request
        t = self.tr
        every, cap = int(t["capture_every"]), int(t["capture_max"])
        while not self._stop.is_set():
            with self._lock:
                i = int(self.order[self._next % len(self.order)])
                self._next += 1
            search = {"spec": i, "left": 0, "done": threading.Event(),
                      "t_first": None}
            reqs = []
            with self._lock:
                for r in self.search_specs[i]:
                    rid = self._serial
                    self._serial += 1
                    mark = False
                    if self._open:
                        mark = self._in_window % every == 0 \
                            and self._marked < cap
                        self._in_window += 1
                        self._marked += mark
                    rec = {"search": search, "route": r, "capture": mark,
                           "n_mct": len(r["queries"])}
                    self.routes[rid] = rec
                    reqs.append(Request(
                        rid=rid, tokens=r["tokens"],
                        max_new_tokens=int(t["new_tokens"]),
                        mct_queries=[self.pool[q] for q in r["queries"]],
                        connect_minutes=r["connect"], capture=mark))
                search["left"] = len(reqs)
                self.searches.append(search)
            search["t_first"] = time.perf_counter()
            for req in reqs:
                self.session.submit(req)
            search["done"].wait()

    def _answer(self, rid: int, fate: str, tokens=None):
        t = time.perf_counter()
        with self._lock:
            rec = self.routes[rid]
            rec["t_done"], rec["fate"], rec["tokens"] = t, fate, tokens
            s = rec["search"]
            s["left"] -= 1
            last = s["left"] == 0
        if last:
            s["t_done"] = t
            s["done"].set()

    def _on_complete(self, comp):
        self._answer(comp.rid, "scored", comp.tokens)

    def _on_drop(self, rid):
        self._answer(rid, "dropped")

    def window(self, seconds: float, profile_at) -> TracedRun:
        with self._lock:
            self._open = True
        counts0 = self._counts()
        t0, t1, dev = hold_window(seconds, profile_at,
                                  float(self.tr["profile_s"]), self.device,
                                  pause=self._pause)
        counts1 = self._counts()
        self._stop.set()
        deadline = t1 + DRAIN_S
        for th in self._threads:
            th.join(timeout=max(0.0, deadline - time.perf_counter()))
        self.session.result()
        with self._lock:
            searches = list(self.searches)
        started = [s for s in searches
                   if s["t_first"] is not None and t0 <= s["t_first"] < t1]
        tracer = self.srv.tracer
        data = {"searches": searches, "routes": self.routes,
                "attempted": len(started),
                "failed": sum(1 for s in started if "t_done" not in s),
                "counts": {k: (counts0[k], counts1[k]) for k in counts0}}
        if tracer is not None:
            data["spans"] = tracer.spans()
            data["spans_dropped"] = tracer.n_dropped
        return TracedRun(t0, t1, device=dev, data=data)

    def _counts(self) -> dict:
        """The configuration's counters as the program reads them now."""
        return {k: getattr(self.lm, k)() for k in self.counters
                if hasattr(self.lm, k)}

    # -- metrics --------------------------------------------------------------
    def end_to_end(self, run: TracedRun) -> dict:
        done = [s for s in run.data["searches"]
                if "t_done" in s and run.t0 <= s["t_done"] < run.t1]
        answered = sum(r["n_mct"] for r in run.data["routes"].values()
                       if "t_done" in r and run.t0 <= r["t_done"] < run.t1)
        out = {"mct_queries_per_s": answered / run.seconds}
        if done:
            out["search_p95_ms"] = float(np.percentile(
                [(s["t_done"] - s["t_first"]) * 1e3 for s in done], 95))
        return out

    def trace_data(self, run: TracedRun):
        """What the scorer's readers need beside the spans: the
        configuration's keys and the counters of its work."""
        run.data["model_keys"] = self.cfg
        run.data["work"] = self.work

    def host_spans(self, run: TracedRun):
        return [(s.stage, s.t0, s.t1) for s in run.data.get("spans", ())
                if s.stage in self.GAP_PRIORITY]

    # -- correctness ----------------------------------------------------------
    def release(self):
        """Everything but the parameters, which the check reads."""
        self.params = self.lm.params
        self.captured = dict(self.lm.captured)
        self.lm._dev_params.clear()
        del self.session, self.srv, self.lm

    def check(self, run: TracedRun) -> dict:
        started = [s for s in run.data["searches"] if s["t_first"] is not None
                   and run.t0 <= s["t_first"] < run.t1]
        missing = sum(1 for s in started if "t_done" not in s)
        routes = run.data["routes"]
        marked = {rid: r for rid, r in routes.items() if r["capture"]}
        wrong = sum(1 for r in routes.values() if "fate" in r
                    and (r["fate"] == "scored") != r["route"]["feasible"])
        wrong += self._judge_mct(marked)
        if self._saved is not None:
            _restore(self._saved)
        scored = {rid: r for rid, r in marked.items()
                  if r.get("fate") == "scored"}
        err = self._logits_err(scored)
        del self.params
        return {"lm_logits_err": (err, self.limit,
                                  bool(scored) and err <= self.limit),
                "mct_wrong": (wrong, 0, wrong <= 0 and bool(marked)),
                "searches_missing": (missing, 0, missing <= 0)}

    def _judge_mct(self, marked: Dict[int, dict]) -> int:
        """Marked routes whose answers are wrong, or whose fate does not
        follow from them."""
        dense = inputs.dense_rules(self.mct_cfg, self.rules)
        default = self.rules.default_decision
        wrong = 0
        for rid, r in marked.items():
            got = self.captured.get(rid, {}).get("mct")
            if got is None or "fate" not in r:
                wrong += 1
                continue
            dec, w, rule = got
            values = ref_mct.query_values(
                self.rules, [self.pool[q] for q in r["route"]["queries"]])
            bad = ref_mct.judge(dense, values, dec, w, rule,
                                device=self.device)
            need = np.where(dec >= 0, dec, default)
            keep = bool(np.all(np.asarray(r["route"]["connect"]) >= need))
            wrong += int(bad > 0 or keep != (r["fate"] == "scored"))
        return wrong

    def _logits_err(self, scored: Dict[int, dict]) -> float:
        """Largest over ``scored`` and their positions of ||program -
        reference|| over ||reference||, the reference a layer at a time in
        float32."""
        import torch
        ref, keys = self.ref, self.cfg
        ref.strict_float32()
        rows = []
        for rid, r in scored.items():
            logits = self.captured.get(rid, {}).get("logits")
            n = len(r["route"]["tokens"])
            seq = np.concatenate([r["route"]["tokens"],
                                  np.asarray(r["tokens"][:-1], np.int32)])
            if logits is None or len(logits) != len(seq) - n + 1:
                return math.inf
            rows.append((n, torch.as_tensor(seq, dtype=torch.long,
                                            device=self.device), logits))
        if not rows:
            return math.inf
        with torch.no_grad():
            w = ref.from_port(self.params, keys)
            embed, layers = w.pop("embed"), w.pop("layers")
            xs = [ref.embed(embed, s, keys) for _, s, _ in rows]
            for layer in layers:
                layer = ref.to_float32(layer)
                xs = [ref.block(layer, x, keys) for x in xs]
                del layer
            w = ref.to_float32(w)     # the final norm and the head, once
            err = 0.0
            for (n, _, got), x in zip(rows, xs):
                want = ref.logits(w, x[n - 1:], keys)
                got = torch.as_tensor(got, device=want.device)
                rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
                err = max(err, float(rel.max()))
        return err


def _round_fp8(matrices) -> list:
    """Round each of ``matrices`` through float8 e4m3 with a per-tensor
    scale (amax to 448), in place, a slab of rows at a time; returns each
    matrix with its original, on the host."""
    import torch
    saved = []
    for w in matrices:
        saved.append((w, w.to("cpu", copy=True)))
        s = float(w.abs().max().float()) / 448.0
        for r in range(0, w.shape[0], 8192):
            v = w[r:r + 8192]
            v.copy_(((v.float() / s).to(torch.float8_e4m3fn).float()
                     * s).to(w.dtype))
    return saved


def _restore(saved: list) -> None:
    for w, v in saved:
        w.copy_(v)
