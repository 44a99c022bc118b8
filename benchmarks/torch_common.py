"""Shared fixtures of the port's paper-figure harnesses, the counterpart of
``benchmarks/common.py``: the rule system, a timer that waits for the card,
and the rows every harness emits.

A :class:`Bench` carries what one run shares: the device, the rule-system
sizes, the rule systems and engines built so far, and the emitted rows.
Its sizes follow the device (``SIZES``): 160,000 rules (the paper's count)
and 8,192 queries on the card, the reference's 4,096 / 8,192 on the CPU.
Rows have the reference's schema (``name``,
``us_per_call``, ``derived``, extras) plus the ``device`` they ran on.

The harnesses are scripts: run them from the root of a checkout as
``PYTHONPATH=src python3 benchmarks/torch_<name>.py [--device cpu]``, or
all of them through ``benchmarks/torch_run.py``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.core.aggregator import Batch
from repro_torch.core.compiler import CompiledRuleTable, compile_rules
from repro_torch.core.encoder import encode_queries
from repro_torch.core.engine import ErbiumEngine
from repro_torch.core.rules import RuleSet, generate_queries, generate_rules
from repro_torch.device import resolve_device, synchronize

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# (rules, queries) by device type: the paper's rule count on the card, the
# reference's scaled-down shape (benchmarks/common.py) on the CPU
SIZES = {"cuda": (160_000, 8_192), "cpu": (4_096, 8_192)}
RULE_SEED = 42                  # queries: RULE_SEED + 1, as the reference


class RuleSystem(NamedTuple):
    """Unpacks as the reference's ``(rs, table, qs, enc)``."""
    ruleset: RuleSet
    table: CompiledRuleTable
    queries: list
    encoded: np.ndarray


def rule_system(version: int, n_rules: int, n_queries: int, *,
                seed: int = RULE_SEED) -> RuleSystem:
    """The reference's rule system at these sizes: the same rules, table,
    queries and encodings, byte for byte."""
    rs = generate_rules(n_rules, version=version, seed=seed)
    return with_queries(rs, compile_rules(rs), n_queries, seed=seed + 1)


def with_queries(ruleset: RuleSet, table: CompiledRuleTable,
                 n_queries: int, *, seed: int = RULE_SEED + 1
                 ) -> RuleSystem:
    """A rule system around a rule set and table already built."""
    qs = generate_queries(ruleset, n_queries, seed=seed)
    return RuleSystem(ruleset, table, qs, encode_queries(table, qs))


def batch_maker(queries):
    """``n -> Batch`` of n queries, cycling through ``queries``."""
    def make_batch(n: int) -> Batch:
        return Batch(0, [queries[i % len(queries)] for i in range(n)],
                     [(0, -1)] * n)
    return make_batch


@dataclass
class Bench:
    device: torch.device
    n_rules: int
    n_queries: int
    systems: Dict[int, RuleSystem] = field(default_factory=dict)
    engines: Dict[int, ErbiumEngine] = field(default_factory=dict)
    results: List[dict] = field(default_factory=list)
    # BENCH_endtoend.json sections other than "results" (cache, capacity,
    # trace), by name
    sections: Dict[str, list] = field(default_factory=dict)

    @classmethod
    def on(cls, device="cuda") -> "Bench":
        """A bench on ``device`` (the card unless the caller asks for the
        CPU; no card is an error) at the device's ``SIZES``."""
        dev = resolve_device(device)
        return cls(dev, *SIZES[dev.type])

    @property
    def device_name(self) -> str:
        return (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")

    def system(self, version: int) -> RuleSystem:
        if version not in self.systems:
            self.systems[version] = rule_system(version, self.n_rules,
                                                self.n_queries)
        return self.systems[version]

    def engine(self, version: int = 2) -> ErbiumEngine:
        """The dense engine on the rule-match kernel (its plain version on
        the CPU), one per rule-set version."""
        if version not in self.engines:
            self.engines[version] = ErbiumEngine(self.system(version).table,
                                                 device=self.device)
        return self.engines[version]

    def times_us(self, fn, *args, repeats: int = 3, warmup: int = 1,
                 **kw) -> List[float]:
        """The wall time of each of ``repeats`` calls of ``fn(*args,
        **kw)`` in µs; each call ends in a synchronisation of the device,
        so the card's work is inside the span."""
        for _ in range(warmup):
            fn(*args, **kw)
        synchronize(self.device)
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(*args, **kw)
            synchronize(self.device)
            ts.append((time.perf_counter() - t0) * 1e6)
        return ts

    def time_us(self, fn, *args, **kw) -> float:
        """The median of :meth:`times_us`."""
        return float(np.median(self.times_us(fn, *args, **kw)))

    def emit(self, name: str, us_per_call: float, derived: str,
             **extra) -> dict:
        print(f"{name},{us_per_call:.1f},{derived}", flush=True)
        row = {"name": name, "us_per_call": float(us_per_call),
               "derived": derived, **extra, "device": self.device_name}
        self.results.append(row)
        return row


def cli(doc: str, argv=None, **flags):
    """A harness's command line: ``--device {cuda,cpu}`` (the card unless
    asked) and the given store-true ``flags`` (name -> help). Prints the
    CSV header and returns ``(Bench, args)``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    for name, help_ in flags.items():
        ap.add_argument(f"--{name}", action="store_true", help=help_)
    args = ap.parse_args(argv)
    bench = Bench.on(args.device)
    print("name,us_per_call,derived")
    return bench, args
