"""Port copy of ``repro.core.aggregator``. Kept as a copy because
importing ``repro`` loads JAX.

Batch-formation policy (paper §5): aggregate MCT queries across the
Travel Solutions of a user query so the accelerator sees large batches.

The paper's compromise: batch size is driven by the user query's
required-qualified-TS count — all potential TSs are batched together when
fewer than required, otherwise multiple required-sized batches. We implement
that policy (`paper_policy`) plus two beyond-paper ones:

- ``greedy_all``: one batch with every MCT query of the user query
  (minimises accelerator calls; what the paper notes would be optimal).
- ``deadline``: cross-USER-query continuous batching with an SLA deadline —
  aggregates requests from concurrent user queries until either the target
  batch size or the deadline is hit (the paper's "delay submitting queries
  to batch several requests" discussion, made concrete). This is the same
  policy object the LM serving engine uses for request batching.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.workload import MAX_QUALIFIED_TS, TravelSolution, UserQuery


@dataclass
class Batch:
    uid: int                       # -1 for mixed (cross-user) batches
    queries: List[Dict[str, int]]
    ts_index: List[Tuple[int, int]]  # (uid, ts position) per query


def paper_policy(uq: UserQuery) -> List[Batch]:
    """Batch size == required qualified TS count (paper §5.2)."""
    batches: List[Batch] = []
    cur = Batch(uq.uid, [], [])
    ts_budget = uq.required_ts
    seen_ts = 0
    for ti, ts in enumerate(uq.solutions):
        if ts.n_connections == 0:
            seen_ts += 1
            continue
        if seen_ts >= MAX_QUALIFIED_TS:
            break
        cur.queries.extend(ts.mct_queries)
        cur.ts_index.extend([(uq.uid, ti)] * len(ts.mct_queries))
        seen_ts += 1
        if seen_ts % ts_budget == 0 and cur.queries:
            batches.append(cur)
            cur = Batch(uq.uid, [], [])
    if cur.queries:
        batches.append(cur)
    return batches


def greedy_all(uq: UserQuery) -> List[Batch]:
    b = Batch(uq.uid, [], [])
    for ti, ts in enumerate(uq.solutions[:MAX_QUALIFIED_TS]):
        b.queries.extend(ts.mct_queries)
        b.ts_index.extend([(uq.uid, ti)] * len(ts.mct_queries))
    return [b] if b.queries else []


@dataclass
class DeadlineAggregator:
    """Cross-request continuous batching with an SLA deadline.

    Time is logical (caller-supplied timestamps), so the policy is testable
    deterministically and reusable for LM serving.
    """
    target_batch: int = 4_096
    deadline: float = 0.002        # seconds of queueing allowed
    _q: deque = dataclasses.field(default_factory=deque)
    _oldest: Optional[float] = None

    def add(self, uid: int, queries: Sequence[Dict[str, int]],
            now: float) -> None:
        """Enqueue without polling — callers that must cap batches per
        drain (the async scheduler) add everything first, then poll with
        an explicit limit."""
        for q in queries:
            self._q.append((uid, q))
        if self._oldest is None and queries:
            self._oldest = now

    def offer(self, uid: int, queries: Sequence[Dict[str, int]],
              now: float) -> List[Batch]:
        self.add(uid, queries, now)
        return self.poll(now)

    def poll(self, now: float, limit: Optional[int] = None) -> List[Batch]:
        """Form ready batches. ``limit`` caps how many full batches are
        drained per call — the async scheduler drains one at a time so the
        bounded admission queue (not this aggregator) absorbs overload and
        backpressure can engage."""
        out: List[Batch] = []
        while len(self._q) >= self.target_batch \
                and (limit is None or len(out) < limit):
            out.append(self._drain(self.target_batch))
        if self._q and (limit is None or len(out) < limit) \
                and self._oldest is not None \
                and now - self._oldest >= self.deadline:
            out.append(self._drain(len(self._q)))
        if not self._q:
            self._oldest = None
        elif out:
            self._oldest = now
        return out

    def pending(self) -> int:
        """Queries currently buffered (counted against the scheduler's
        bounded queue depth)."""
        return len(self._q)

    def next_deadline(self) -> Optional[float]:
        """Logical time at which the oldest buffered item must be flushed;
        None when empty (lets pollers sleep instead of busy-ticking)."""
        return None if self._oldest is None else self._oldest + self.deadline

    def evict_oldest(self, now: float
                     ) -> Optional[Tuple[int, Dict[str, int]]]:
        """Drop and return the oldest buffered item (shed-oldest
        backpressure policy); None when empty. The deadline clock restarts
        at ``now`` for the survivors — per-item enqueue times aren't
        tracked, and inheriting the evicted item's age would flush the
        newer remainder as an early undersized batch."""
        if not self._q:
            return None
        item = self._q.popleft()
        self._oldest = now if self._q else None
        return item

    def flush(self) -> List[Batch]:
        return [self._drain(len(self._q))] if self._q else []

    def _drain(self, n: int) -> Batch:
        b = Batch(-1, [], [])
        for _ in range(n):
            uid, q = self._q.popleft()
            b.queries.append(q)
            b.ts_index.append((uid, -1))
        return b


def batch_stats(batches: Iterable[Batch]) -> Dict[str, float]:
    sizes = [len(b.queries) for b in batches]
    if not sizes:
        return {"n_batches": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0}
    return {"n_batches": len(sizes), "mean": float(np.mean(sizes)),
            "p50": float(np.percentile(sizes, 50)),
            "p90": float(np.percentile(sizes, 90)),
            "max": float(np.max(sizes))}
