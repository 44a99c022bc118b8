"""Inputs that several drivers share: the deployment's rule set, cached in
the checkout, and pools of MCT queries drawn from ``--seed``.

The rule set is the deployment's table and is fixed by the configuration
(``n_rules``, ``version``, ``rule_seed``): every run serves the same table,
and only its first run in a checkout generates it (about 16 s of host time
at 160k rules) and writes it to ``build/bench_inputs/``. The queries, the
searches and their order are drawn from ``--seed``.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from pathlib import Path

import numpy as np

from bench.harness import gen
from bench.harness.core import ROOT
from bench.reference import mct as ref

CACHE = ROOT / "build" / "bench_inputs"


def _key(config: dict):
    key = dict(n=int(config["n_rules"]), version=int(config["version"]),
               seed=int(config["rule_seed"]))
    src = Path(gen.__file__).read_bytes() + Path(ref.__file__).read_bytes()
    tag = hashlib.sha256(repr(sorted(key.items())).encode() + src
                         ).hexdigest()[:16]
    return key, f"rules_{key['n']}_v{key['version']}_{tag}"


def rule_set(config: dict) -> gen.RuleSet:
    """The configuration's rule set, from the cache when it holds it."""
    key, stem = _key(config)
    path = CACHE / f"{stem}.pkl"
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    rs = gen.generate_rules(key["n"], version=key["version"],
                            seed=key["seed"])
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(rs, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return rs


def query_pool(ruleset: gen.RuleSet, n: int, seed: int):
    """``n`` MCT queries drawn from ``seed``."""
    return gen.generate_queries(ruleset, n, seed=seed)


def dense_rules(config: dict, ruleset: gen.RuleSet) -> ref.DenseRules:
    """The plain reference's dense form of the configuration's rule set
    (``reference.mct.dense_rules``), cached beside the rule set."""
    _, stem = _key(config)
    path = CACHE / f"{stem}.dense.npz"
    if path.exists():
        with np.load(path) as z:
            return ref.DenseRules([c.name for c in ruleset.schema],
                                  *(z[k] for k in ref.DenseRules._fields[1:]))
    d = ref.dense_rules(ruleset)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, **{k: getattr(d, k) for k in ref.DenseRules._fields[1:]})
    os.replace(tmp, path)
    return d
