"""The device trace of a short profiled sub-window, and what it reduces to.

``Recorder`` runs ``torch.profiler`` with CUDA activity only (no
operator events on the host, so the host path runs at its own speed) and
keeps every device activity: kernels, copies and sets, as
``(name, start, end)`` in ``time.perf_counter`` seconds. The profiler's
clock is the Unix clock in nanoseconds; the offset to ``perf_counter`` is
taken when the sub-window opens, and ``aligned`` says whether the
activities fall inside the sub-window as the host saw it.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class DeviceTrace:
    t0: float = 0.0
    t1: float = 0.0
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    aligned: bool = False

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self) -> List[Tuple[str, float, float]]:
        """Kernel activities, copies and sets left out."""
        return [o for o in self.ops if not o[0].startswith(COPY_PREFIXES)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of all device activities, clipped to the window."""
        iv = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.ops
                    if e > self.t0 and s < self.t1)
        out: List[List[float]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the window: no device activity at all."""
        out, cur = [], self.t0
        for s, e in self.busy_intervals():
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if self.t1 > cur:
            out.append((cur, self.t1))
        return out

    def top_ops(self, n: int = 10) -> List[List[object]]:
        tot: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            tot[name] += e - s
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_label(self, spans: Sequence[Tuple[str, float, float]],
                      priority: Sequence[str], n: int = 10
                      ) -> List[List[object]]:
        """Idle seconds by what the host was doing: each gap is split at
        the edges of the harness's host spans, and each piece goes to the
        first label of ``priority`` whose span covers it ("host_other"
        where none does)."""
        rank = {lab: i for i, lab in enumerate(priority)}
        tot: Dict[str, float] = defaultdict(float)
        sp = sorted((s, e, lab) for lab, s, e in spans
                    if lab in rank and e > self.t0 and s < self.t1)
        for g0, g1 in self.gaps():
            cuts = sorted({g0, g1} | {x for s, e, _ in sp for x in (s, e)
                                     if g0 < x < g1})
            for a, b in zip(cuts[:-1], cuts[1:]):
                mid = 0.5 * (a + b)
                labs = [lab for s, e, lab in sp if s <= mid < e]
                lab = min(labs, key=rank.__getitem__) if labs \
                    else "host_other"
                tot[lab] += b - a
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


class Recorder:
    """``with Recorder() as rec: ...`` profiles the body on the card;
    ``rec.trace`` is the ``DeviceTrace`` afterwards. ``start`` and ``stop``
    may instead be called apart, on one thread, and ``collect`` after."""

    def __enter__(self) -> "Recorder":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        self.collect()
        return False

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._off_ns = time.time_ns() - time.perf_counter_ns()
        self.trace = DeviceTrace(t0=time.perf_counter())

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.trace.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def collect(self) -> DeviceTrace:
        """The stopped profiler's device activities into ``trace``."""
        from torch.autograd import DeviceType
        ops = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s = (ev.start_ns() - self._off_ns) * 1e-9
            ops.append((ev.name(), s, s + ev.duration_ns() * 1e-9))
        self.trace.ops = ops
        inside = sum(1 for _, s, e in ops
                     if s >= self.trace.t0 - 0.01 and e <= self.trace.t1 + 0.01)
        self.trace.aligned = bool(ops) and inside >= 0.9 * len(ops)
        return self.trace


class PauseAtSpans:
    """``pause(fn)`` runs ``fn`` on the caller's thread while the thread
    that emits the program's spans of ``stages`` through ``tracer`` waits,
    held as it closes its next such span: between two of its stages,
    launching nothing. Where no such span comes within
    ``wait_s`` (the load has stopped), ``fn`` runs at once."""

    def __init__(self, tracer, stages, wait_s: float = 30.0):
        self._span, self._stages, self._wait_s = tracer.span, set(stages), \
            wait_s
        self._asks: List[Tuple[threading.Event, threading.Event]] = []
        self._lock = threading.Lock()
        tracer.span = self._on_span       # shadows the method: this tracer

    def _on_span(self, stage, *a, **k):
        out = self._span(stage, *a, **k)
        if stage in self._stages and self._asks:
            with self._lock:
                asks, self._asks = self._asks, []
            for held, go in asks:
                held.set()
                go.wait()
        return out

    def __call__(self, fn):
        ask = (threading.Event(), threading.Event())
        with self._lock:
            self._asks.append(ask)
        try:
            if not ask[0].wait(self._wait_s):
                with self._lock:
                    taken = ask not in self._asks
                    if not taken:
                        self._asks.remove(ask)
                if taken:
                    ask[0].wait()
            return fn()
        finally:
            ask[1].set()


def hold_window(seconds: float, profile_at, profile_s: float, device,
                pause=None):
    """Hold the load's measured window open for ``seconds``; with
    ``profile_at`` (seconds into the window, or None) and a card, profile
    ``profile_s`` seconds of it. ``pause(fn)``, where given, runs ``fn``
    while the thread that launches the program's device work waits between
    two of its launches: the profiler stops there, with no launch racing
    the stop. (It starts with the load running: a pause there changes the
    batches the sub-window sees.) Returns ``(t0, t1, trace or None)``."""
    t0 = time.perf_counter()
    trace = None
    if profile_at is not None and device.type == "cuda":
        time.sleep(profile_at)
        rec = Recorder()
        rec.start()
        time.sleep(profile_s)
        (pause or (lambda fn: fn()))(rec.stop)
        trace = rec.collect()
    time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
    return t0, time.perf_counter(), trace
