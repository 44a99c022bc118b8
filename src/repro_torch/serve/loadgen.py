"""Open-loop and closed-loop load generation for the serving pipeline.

The paper's §6 regime — "the CPU cannot generate enough load to saturate
the accelerator" — needs two controllable axes to reproduce:

- **arrival process**: open loop (Poisson arrivals at a target QPS,
  independent of service rate — models front-end fan-in) vs closed loop
  (fixed concurrency, each completion releases the next submission —
  models a worker pool).
- **host-side work per request**: prompt length drives tokenisation cost,
  MCT query count drives encoder cost. Dialing these up makes the host the
  bottleneck and the device-idle-fraction climb, which is the imbalance
  curve the fig13 harness sweeps.

Everything is seeded: the same (seed, qps, n) always yields the same
arrival schedule and request contents.

A third axis matters once the serving layer caches results
(``repro_torch.serve.cache``): **content repetition**. Travel-search traffic
re-asks the same origin/destination/date queries within seconds, so
``SyntheticWorkload(unique_keys=K, repeat_alpha=a)`` draws every request's
content from ``K`` fixed prototypes with Zipf(``a``) popularity —
``a = 0`` is uniform reuse, larger ``a`` concentrates traffic on the head
keys. Both the open- and closed-loop generators inherit the mode through
their workload. The default (``unique_keys = 0``) keeps the original
every-request-unique stream byte-identical.

Port of ``repro.serve.loadgen``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.serve.engine import Request


def poisson_arrivals(n: int, qps: float, *, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """Cumulative arrival times of a Poisson process at rate ``qps``."""
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / qps, size=n))


def uniform_arrivals(n: int, qps: float, *, start: float = 0.0) -> np.ndarray:
    """Deterministic evenly-spaced arrivals (useful as a control)."""
    return start + (np.arange(n, dtype=np.float64) + 1.0) / qps


def zipf_probs(k: int, alpha: float) -> np.ndarray:
    """Zipf(``alpha``) popularity over ``k`` ranked keys (``alpha = 0`` is
    uniform): p(rank r) proportional to 1 / r**alpha."""
    if k <= 0:
        raise ValueError(f"need k >= 1 keys, got {k}")
    w = np.arange(1, k + 1, dtype=np.float64) ** -float(alpha)
    return w / w.sum()


@dataclass
class SyntheticWorkload:
    """Seeded request factory with dialable host-side work per request.

    With ``unique_keys > 0`` the stream draws request *content* (tokens +
    MCT queries) from that many fixed prototypes under Zipf
    (``repeat_alpha``) popularity — repeat-heavy traffic for result-cache
    studies. Two requests drawn from the same prototype are content-equal
    (same ``repro_torch.serve.cache.request_key``) even though their rids and
    arrivals differ. The default ``unique_keys = 0`` keeps every request's
    content unique and byte-identical to the pre-cache generator.
    """
    vocab: int = 256
    prompt_len: int = 8
    max_new_tokens: int = 4
    n_mct_queries: int = 0        # >0 needs ``ruleset`` for query synthesis
    ruleset: object = None
    seed: int = 0
    # content repetition (off by default): number of distinct request
    # prototypes and the Zipf popularity skew across them
    unique_keys: int = 0
    repeat_alpha: float = 0.0

    def build(self, n: int, arrivals: Optional[np.ndarray] = None,
              rid_base: int = 0) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        n_content = self.unique_keys if self.unique_keys > 0 else n
        mct_pool: List[dict] = []
        if self.n_mct_queries > 0:
            if self.ruleset is None:
                raise ValueError("n_mct_queries > 0 requires a ruleset")
            from repro_torch.core.rules import generate_queries
            mct_pool = generate_queries(self.ruleset,
                                        n_content * self.n_mct_queries,
                                        seed=self.seed)
        protos: Optional[List[np.ndarray]] = None
        choice: Optional[np.ndarray] = None
        if self.unique_keys > 0:
            protos = [rng.integers(1, self.vocab,
                                   self.prompt_len).astype(np.int32)
                      for _ in range(self.unique_keys)]
            choice = rng.choice(self.unique_keys, size=n,
                                p=zipf_probs(self.unique_keys,
                                             self.repeat_alpha))
        out = []
        for i in range(n):
            j = int(choice[i]) if choice is not None else i
            toks = protos[j].copy() if protos is not None \
                else rng.integers(1, self.vocab,
                                  self.prompt_len).astype(np.int32)
            qs = mct_pool[j * self.n_mct_queries:(j + 1) * self.n_mct_queries]
            out.append(Request(
                rid=rid_base + i,
                tokens=toks,
                max_new_tokens=self.max_new_tokens,
                arrival=float(arrivals[i]) if arrivals is not None else 0.0,
                mct_queries=list(qs),
                # generous connect times: the MCT stage encodes/matches but
                # does not drop, so loadgen comparisons stay apples-to-apples
                connect_minutes=[10 ** 6] * len(qs)))
        return out


@dataclass
class OpenLoopGen:
    """Poisson arrivals at ``qps``, submitted regardless of completions."""
    workload: SyntheticWorkload
    qps: float
    n: int
    seed: int = 0

    def requests(self) -> List[Request]:
        """Arrival-stamped requests for deterministic logical-time replay
        (``LMServer.form_batches`` / ``Server.serve``)."""
        arr = poisson_arrivals(self.n, self.qps, seed=self.seed)
        return self.workload.build(self.n, arrivals=arr)

    def drive(self, scheduler, *, time_scale: float = 1.0) -> int:
        """Live submission: sleep out the schedule, fire-and-forget into
        the scheduler (never waits on completions — open loop). Returns
        how many submissions were accepted."""
        reqs = self.requests()
        t0 = time.perf_counter()
        accepted = 0
        for r in reqs:
            delay = r.arrival * time_scale - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            accepted += bool(scheduler.submit(r))
        return accepted


@dataclass
class PhasedOpenLoopGen:
    """Open-loop load whose target QPS shifts through phases — the traffic
    shape that motivates *online* capacity control: a controller tuned for
    one rate must re-diagnose and re-tune when the rate steps.

    ``phases`` is a list of ``(duration_s, qps)`` segments; each phase
    emits its own seeded Poisson arrival schedule at that rate, offset to
    the phase start, all drawn from one workload (rids stay globally
    unique). Used by ``benchmarks/fig14_capacity.py`` to compare a static
    configuration against the capacity controller under load steps."""
    workload: SyntheticWorkload
    phases: List[tuple]           # (duration_s, qps) per phase
    seed: int = 0

    def requests(self) -> List[Request]:
        """Arrival-stamped requests across all phases, arrival-ordered."""
        arrs: List[np.ndarray] = []
        start = 0.0
        for k, (dur, qps) in enumerate(self.phases):
            if qps <= 0 or dur <= 0:
                start += max(0.0, dur)
                continue
            n = max(1, int(round(dur * qps)))
            a = poisson_arrivals(n, qps, seed=self.seed + 1000 * k,
                                 start=start)
            arrs.append(a[a < start + dur])
            start += dur
        if not arrs:
            return []
        arr = np.concatenate(arrs)
        return self.workload.build(len(arr), arrivals=arr)

    @property
    def n(self) -> int:
        return len(self.requests())

    @property
    def total_s(self) -> float:
        return float(sum(max(0.0, d) for d, _ in self.phases))

    @property
    def mean_qps(self) -> float:
        tot = self.total_s
        return self.n / tot if tot > 0 else 0.0

    def drive(self, scheduler, *, time_scale: float = 1.0) -> int:
        """Live submission on the phased schedule (open loop: never waits
        on completions). Returns how many submissions were accepted."""
        reqs = self.requests()
        t0 = time.perf_counter()
        accepted = 0
        for r in reqs:
            delay = r.arrival * time_scale - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            accepted += bool(scheduler.submit(r))
        return accepted


@dataclass
class ClosedLoopGen:
    """Fixed-concurrency loop: ``concurrency`` requests in flight at all
    times; each completion releases the next submission."""
    workload: SyntheticWorkload
    concurrency: int
    n: int
    seed: int = 0
    _sem: threading.Semaphore = field(init=False, repr=False, default=None)

    def drive(self, scheduler) -> int:
        reqs = self.workload.build(self.n)
        self._sem = threading.Semaphore(self.concurrency)
        prev_done = scheduler.on_complete
        prev_drop = scheduler.on_drop

        def _release(completion):
            self._sem.release()
            if prev_done is not None:
                prev_done(completion)

        def _release_drop(rid):
            # a request that will never complete (shed, MCT-filtered) must
            # still return its permit or the loop wedges at `concurrency`
            # losses
            self._sem.release()
            if prev_drop is not None:
                prev_drop(rid)

        scheduler.on_complete = _release
        scheduler.on_drop = _release_drop
        accepted = 0
        for r in reqs:
            self._sem.acquire()
            if scheduler.submit(r):
                accepted += 1
            else:
                self._sem.release()    # rejected: no completion will come
        return accepted
