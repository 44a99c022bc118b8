"""MCT Wrapper — the paper's multi-threaded Host-Executor (§4.1).

Port of ``repro.core.wrapper``. Round-robin dealer over worker threads; each
worker encodes its batch, dispatches it to the card, runs the engine and
collects the results back to the host. Every stage is timed (paper Fig. 6
decomposition):

  queue -> encode -> dispatch (host->device) -> kernel -> collect

On the card, dispatch is a copy from pinned host memory followed by a
synchronize, and the kernel stage ends in ``torch.cuda.synchronize``, so each
stage's time is the device's and not only its enqueue. Worker threads share
the engine: the kernel launch releases the interpreter lock.

Given a ``Tracer``, each batch also leaves one span a stage on the same
clock readings as its ``StageTimes`` (``queue_wait``, ``encode``,
``dispatch``, ``device_execute``, ``collect``), each but the queue wait with
the worker thread's CPU time over it (``cpu_us``: wall minus CPU is the
time the thread was runnable but not running), the ``encode`` span whether
the engine's ``EncodePlan`` sent the batch to the per-key path
(``fallback``, 0 or 1), and ``drain`` adds the
``handoff`` from the worker's end of the batch to the caller's ``get``.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.aggregator import Batch
from repro_torch.core.engine import ErbiumEngine
from repro_torch.device import synchronize

if TYPE_CHECKING:
    from repro_torch.serve.trace import Tracer


@dataclass
class StageTimes:
    queue_us: float = 0.0
    encode_us: float = 0.0
    dispatch_us: float = 0.0
    kernel_us: float = 0.0
    collect_us: float = 0.0
    batch: int = 0

    @property
    def total_us(self) -> float:
        return (self.queue_us + self.encode_us + self.dispatch_us +
                self.kernel_us + self.collect_us)


@dataclass
class MCTResult:
    uid: int
    decisions: np.ndarray
    weights: np.ndarray
    times: StageTimes
    rule_ids: Optional[np.ndarray] = None
    t_done: float = 0.0     # the worker's end of the batch (perf_counter)


class MCTWrapper:
    """n_workers worker threads sharing one engine pool (1..k engines)."""

    def __init__(self, engines: Sequence[ErbiumEngine], n_workers: int = 1,
                 tracer: Optional[Tracer] = None):
        self.engines = list(engines)
        self.n_workers = n_workers
        self.tracer = tracer
        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        for wi in range(self.n_workers):
            t = threading.Thread(target=self._worker_loop,
                                 args=(wi,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()
        for _ in self._threads:
            self._in.put(None)
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        self._stop.clear()

    # -- request path --------------------------------------------------------
    def submit(self, batch: Batch):
        self._in.put((time.perf_counter(), batch))

    def drain(self, n: int, timeout: float = 60.0) -> List[MCTResult]:
        out = []
        for _ in range(n):
            res = self._out.get(timeout=timeout)
            if self.tracer is not None:
                self.tracer.span("handoff", res.t_done, time.perf_counter(),
                                 uid=res.uid, n=len(res.decisions))
            out.append(res)
        return out

    def process(self, batch: Batch, engine_idx: int = 0) -> MCTResult:
        """Synchronous single-request path (used for stage benchmarking)."""
        return self._execute(time.perf_counter(), batch, engine_idx)

    # -- internals ------------------------------------------------------------
    def _worker_loop(self, wi: int):
        while not self._stop.is_set():
            item = self._in.get()
            if item is None:
                return
            t_in, batch = item
            eng = wi % len(self.engines)
            self._out.put(self._execute(t_in, batch, eng, wi))

    def _execute(self, t_in: float, batch: Batch, eng_idx: int,
                 worker: Optional[int] = None) -> MCTResult:
        st = StageTimes(batch=len(batch.queries))
        eng = self.engines[eng_idx]
        dev = eng.device
        tr = self.tracer
        t0 = time.perf_counter()
        c0 = time.thread_time() if tr is not None else 0.0
        st.queue_us = (t0 - t_in) * 1e6

        enc, fallback = eng.plan.encode(batch.queries)
        t1 = time.perf_counter()
        c1 = time.thread_time() if tr is not None else 0.0
        st.encode_us = (t1 - t0) * 1e6

        host = torch.from_numpy(enc)
        if dev.type == "cuda":
            host = host.pin_memory()
        q = host.to(dev, non_blocking=True)
        synchronize(dev)
        t2 = time.perf_counter()
        c2 = time.thread_time() if tr is not None else 0.0
        st.dispatch_us = (t2 - t1) * 1e6

        dec, w, rid = eng.match(q)
        synchronize(dev)
        t3 = time.perf_counter()
        c3 = time.thread_time() if tr is not None else 0.0
        st.kernel_us = (t3 - t2) * 1e6

        dec_h = dec.cpu().numpy()
        w_h = w.cpu().numpy()
        rid_h = rid.cpu().numpy()
        # partition results back to TSs (collect)
        _ = dec_h.sum()
        t4 = time.perf_counter()
        st.collect_us = (t4 - t3) * 1e6
        if tr is not None:
            c4 = time.thread_time()
            meta = dict(replica=eng_idx, worker=worker, uid=batch.uid,
                        n=st.batch)
            tr.span("queue_wait", t_in, t0, **meta)
            tr.span("encode", t0, t1, cpu_us=(c1 - c0) * 1e6,
                    fallback=int(fallback), **meta)
            for stage, a, b, ca, cb in (
                    ("dispatch", t1, t2, c1, c2),
                    ("device_execute", t2, t3, c2, c3),
                    ("collect", t3, t4, c3, c4)):
                tr.span(stage, a, b, cpu_us=(cb - ca) * 1e6, **meta)
        return MCTResult(uid=batch.uid, decisions=dec_h, weights=w_h,
                         times=st, rule_ids=rid_h, t_done=t4)


def measure_stage_times(engine: ErbiumEngine, make_batch, batch_sizes,
                        repeats: int = 3) -> List[StageTimes]:
    """Fig-6 style stage decomposition over batch sizes (median of repeats).
    ``make_batch(n)`` returns a Batch with n queries."""
    wrap = MCTWrapper([engine], n_workers=1)
    out = []
    for n in batch_sizes:
        b = make_batch(n)
        wrap.process(b)  # warmup (first launch, allocator)
        runs = [wrap.process(b).times for _ in range(repeats)]
        med = StageTimes(
            batch=n,
            queue_us=float(np.median([r.queue_us for r in runs])),
            encode_us=float(np.median([r.encode_us for r in runs])),
            dispatch_us=float(np.median([r.dispatch_us for r in runs])),
            kernel_us=float(np.median([r.kernel_us for r in runs])),
            collect_us=float(np.median([r.collect_us for r in runs])))
        out.append(med)
    return out
