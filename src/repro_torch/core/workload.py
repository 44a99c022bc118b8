"""Port copy of ``repro.core.workload``. Kept as a copy because importing
``repro`` loads JAX.

Domain-Explorer workload model: user queries -> Travel Solutions -> MCT
queries (paper §2.2, §5.1).

Reproduces the production snapshot statistics the paper reports: 6,301 user
queries -> 5.8M potential TSs -> 4.8M MCT queries; ~17% of TSs are direct
flights (no MCT call); non-direct TSs spawn 1.24 MCT queries on average
(1..5 connections, capped); the engine explores up to 1,500 qualified TSs
per user query.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.rules import RuleSet, generate_queries

MAX_QUALIFIED_TS = 1_500


@dataclass
class TravelSolution:
    n_connections: int            # 0 == direct flight
    mct_queries: List[Dict[str, int]] = field(default_factory=list)


@dataclass
class UserQuery:
    uid: int
    required_ts: int              # qualified TSs requested (batching driver)
    solutions: List[TravelSolution] = field(default_factory=list)

    @property
    def n_mct(self) -> int:
        return sum(len(ts.mct_queries) for ts in self.solutions)


def generate_workload(ruleset: RuleSet, n_user_queries: int, *,
                      seed: int = 0, mean_ts: float = 920.0,
                      direct_frac: float = 0.17,
                      mean_mct_per_ts: float = 1.24) -> List[UserQuery]:
    """Synthetic trace with the production snapshot's shape."""
    rng = np.random.default_rng(seed)
    out: List[UserQuery] = []
    for uid in range(n_user_queries):
        # log-normal TS counts (heavy tail, mean ~ mean_ts)
        n_ts = int(np.clip(rng.lognormal(np.log(mean_ts) - 0.5, 1.0), 1,
                           8_000))
        required = int(rng.choice([200, 500, 1_000, 1_500],
                                  p=[0.25, 0.3, 0.3, 0.15]))
        n_direct = rng.binomial(n_ts, direct_frac)
        n_indirect = n_ts - n_direct
        # connections per indirect TS: geometric-ish over 1..4,
        # tuned to mean_mct_per_ts
        conns = np.clip(rng.geometric(1.0 / mean_mct_per_ts, n_indirect),
                        1, 4)
        total_mct = int(conns.sum())
        mq = generate_queries(ruleset, total_mct, seed=seed * 977 + uid)
        sols = [TravelSolution(0) for _ in range(n_direct)]
        off = 0
        for c in conns:
            sols.append(TravelSolution(int(c), mq[off:off + int(c)]))
            off += int(c)
        rng.shuffle(sols)
        out.append(UserQuery(uid=uid, required_ts=required, solutions=sols))
    return out


def workload_stats(wl: Sequence[UserQuery]) -> Dict[str, float]:
    n_ts = sum(len(u.solutions) for u in wl)
    n_direct = sum(1 for u in wl for t in u.solutions
                   if t.n_connections == 0)
    n_mct = sum(u.n_mct for u in wl)
    return {
        "user_queries": len(wl),
        "travel_solutions": n_ts,
        "mct_queries": n_mct,
        "direct_frac": n_direct / max(n_ts, 1),
        "mct_per_indirect_ts": n_mct / max(n_ts - n_direct, 1),
    }
