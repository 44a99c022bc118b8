"""Port parity, the serving entry point for the recurrent, hybrid and MoE
families: ``build(ServeConfig(model=<arch>, reduced=True, device="cpu"))``
behind a ~2,000-rule MCT filter serves requests in the style of
``chip_smoke.py`` phase 6 (several MCT queries each, about half of the
requests with one connection too short) for ``hymba-1.5b``, ``xlstm-1.3b``
and ``qwen3-moe-235b-a22b``, and gives the tokens and drops of the JAX
package's ``serve()`` on the same seeds.

Both stacks run the float32 copy of the arch's config (greedy tokens are
compared exactly), on the reference's parameters drawn from seed 0, which
the port's built server takes through ``convert.params_from_numpy``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as j_get_config
from repro.core.compiler import compile_rules as j_compile
from repro.core.engine import ErbiumEngine as JEngine
from repro.core.rules import generate_queries as j_queries
from repro.core.rules import generate_rules as j_rules
from repro.models.registry import build_model as j_build_model
from repro.serve import Request as JRequest
from repro.serve import serve as j_serve
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.compiler import compile_rules
from repro_torch.core.engine import ErbiumEngine, cpu_match_numpy
from repro_torch.core.rules import generate_queries, generate_rules
from repro_torch.serve import Request, ServeConfig, build

ARCHS = ["hymba-1.5b", "xlstm-1.3b", "qwen3-moe-235b-a22b"]
KNOBS = dict(max_seq=32, target_batch=4, deadline=0.005)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def rules():
    rs_j = j_rules(2_000, version=2, seed=3)
    rs = generate_rules(2_000, version=2, seed=3)
    qs = generate_queries(rs, 48, seed=5)
    assert qs == j_queries(rs_j, 48, seed=5)
    return rs_j, compile_rules(rs), qs


def _stream(table, queries, vocab, n=8):
    """n requests of 4-11 prompt tokens, 3 new tokens and 2-4 MCT queries
    each, arrivals 2 ms apart; each connection gets its MCT + 30 minutes
    and about half the requests one connection of 0 minutes. Returns the
    requests as plain dicts and the rids ``cpu_match_numpy``'s decisions
    make infeasible."""
    from repro_torch.core.encoder import encode_queries
    rng = np.random.default_rng(11)
    out, drop = [], set()
    for i in range(n):
        qs = [queries[j] for j in rng.integers(0, len(queries),
                                               int(rng.integers(2, 5)))]
        dec = cpu_match_numpy(table, encode_queries(table, qs))[0]
        need = np.where(dec >= 0, dec, table.default_decision)
        have = need + 30
        if rng.random() < 0.5:
            have[rng.integers(0, len(qs))] = 0
            drop.add(i)
        out.append(dict(rid=i, tokens=rng.integers(1, vocab,
                                                   int(rng.integers(4, 12))),
                        max_new_tokens=3, arrival=i * 0.002, mct_queries=qs,
                        connect_minutes=[int(x) for x in have]))
    return out, drop


def _mk(cls, spec):
    return [cls(rid=r["rid"], tokens=np.asarray(r["tokens"], np.int32),
                max_new_tokens=r["max_new_tokens"], arrival=r["arrival"],
                mct_queries=r["mct_queries"],
                connect_minutes=r["connect_minutes"]) for r in spec]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_serves_family_like_the_reference(arch, rules):
    rs_j, table, qs = rules
    cfg, j_cfg = _f32(get_config(arch)), _f32(j_get_config(arch))
    spec, expect_drop = _stream(table, qs, cfg.reduced().vocab)
    assert 0 < len(expect_drop) < len(spec)

    j_outs, j_rep = j_serve(
        _mk(JRequest, spec), model=j_cfg, reduced=True, mode="pipelined",
        rule_filter=JEngine(j_compile(rs_j), backend="ref"), **KNOBS)
    j_params = jax.jit(j_build_model(j_cfg.reduced()).init)(
        jax.random.PRNGKey(0))          # the reference server's (seed 0)
    with build(ServeConfig(model=cfg, reduced=True, device="cpu",
                           rule_filter=ErbiumEngine(table, device="cpu"),
                           **KNOBS)) as srv:
        assert srv.engine.cfg == cfg.reduced()
        srv.engine.params = params_from_numpy(
            jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                   j_params), cfg.reduced(), device="cpu")
        outs = srv.serve(_mk(Request, spec), mode="pipelined")
        rep = srv.report()

    by, j_by = {c.rid: c for c in outs}, {c.rid: c for c in j_outs}
    assert set(by) == set(j_by) == {r["rid"] for r in spec} - expect_drop
    for rid, c in by.items():
        assert len(c.tokens) == 3
        np.testing.assert_array_equal(c.tokens, np.asarray(j_by[rid].tokens))
        assert c.batch_size == j_by[rid].batch_size
    assert sorted(rep.batch_sizes) == sorted(j_rep.batch_sizes)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_by_arch_name(arch):
    """The arch id through ``ServeConfig(model=..., reduced=True)``: the
    built server draws its own bf16 weights and serves."""
    with build(ServeConfig(model=arch, reduced=True, device="cpu",
                           **KNOBS)) as srv:
        assert srv.engine.cfg == get_config(arch).reduced()
        outs = srv.serve([Request(rid=0, tokens=np.arange(1, 6,
                                                          dtype=np.int32),
                                  max_new_tokens=2)], mode="sync")
    assert len(outs) == 1 and len(outs[0].tokens) == 2
