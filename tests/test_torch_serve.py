"""Port parity, route scorer: the port's ``LMServer(device="cpu")`` against
the JAX package's on the cases of ``tests/test_serve.py``, in float32 on the
same weights (the JAX package's initialised parameters carried across by
``convert.params_from_numpy``): greedy tokens, batch sizes, ``truncated``
flags and the requests the MCT rule filter drops must be equal.

The async-scheduler half of the reference's rule-filter case waits for the
port's serving orchestration (ROADMAP.md queue 1, item 8).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.compiler import compile_rules as j_compile
from repro.core.engine import ErbiumEngine as JEngine
from repro.core.rules import generate_queries as j_queries
from repro.core.rules import generate_rules as j_rules
from repro.serve.engine import LMServer as JServer
from repro.serve.engine import Request as JRequest
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.compiler import compile_rules
from repro_torch.core.engine import ErbiumEngine
from repro_torch.core.rules import generate_queries, generate_rules
from repro_torch.serve import LMServer, Request, form_batch_groups

ARCH = "llama3.2-3b"


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    j_cfg = _f32(j_get_config(ARCH).reduced())
    cfg = _f32(get_config(ARCH).reduced())
    j_params = JServer(j_cfg, max_seq=8).params
    tree = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  j_params)
    return j_cfg, cfg, j_params, params_from_numpy(tree, cfg, device="cpu")


def _servers(weights, filters=(None, None), **kw):
    """The reference's server and the port's on the same weights;
    ``filters``: their rule filters."""
    j_cfg, cfg, j_params, params = weights
    return (JServer(j_cfg, j_params, rule_filter=filters[0], **kw),
            LMServer(cfg, params, device="cpu", rule_filter=filters[1], **kw))


@pytest.fixture(scope="module")
def servers(weights):
    return _servers(weights, max_seq=48)


def _both(reqs):
    """The same requests for each server's Request type."""
    def mk(cls):
        return [cls(rid=r["rid"], tokens=np.asarray(r["tokens"], np.int32),
                    max_new_tokens=r["max_new_tokens"],
                    arrival=r.get("arrival", 0.0),
                    mct_queries=r.get("mct_queries", []),
                    connect_minutes=r.get("connect_minutes", []))
                for r in reqs]
    return mk(JRequest), mk(Request)


def _assert_same(j_outs, outs):
    assert [o.rid for o in outs] == [o.rid for o in j_outs]
    for j, o in zip(j_outs, outs):
        np.testing.assert_array_equal(o.tokens, np.asarray(j.tokens))
        assert o.truncated == j.truncated
        assert o.batch_size == j.batch_size


def test_generate_batch_greedy_deterministic(servers):
    j_srv, srv = servers
    prompt = [3, 5, 7, 11]
    j_reqs, reqs = _both([dict(rid=0, tokens=prompt, max_new_tokens=6),
                          dict(rid=1, tokens=prompt, max_new_tokens=6)])
    outs = srv.generate_batch(reqs)
    np.testing.assert_array_equal(outs[0].tokens, outs[1].tokens)
    assert len(outs[0].tokens) == 6
    _assert_same(j_srv.generate_batch(j_reqs), outs)


def test_batch_independence(servers):
    j_srv, srv = servers
    p0 = dict(rid=0, tokens=[3, 5, 7, 11], max_new_tokens=5)
    p1 = dict(rid=1, tokens=[2, 4, 6, 8], max_new_tokens=5)
    (j_solo,), (solo,) = _both([p0])
    j_pair, pair = _both([p0, p1])
    solo_out = srv.generate_batch([solo])
    pair_out = srv.generate_batch(pair)
    np.testing.assert_array_equal(solo_out[0].tokens, pair_out[0].tokens)
    _assert_same(j_srv.generate_batch([j_solo]), solo_out)
    _assert_same(j_srv.generate_batch(j_pair), pair_out)


def test_form_batches_by_deadline(servers):
    j_srv, srv = servers
    j_reqs, reqs = _both([dict(rid=i, tokens=[1 + i, 2, 3], max_new_tokens=3,
                               arrival=i * 0.001) for i in range(6)])
    groups = srv.form_batches(reqs, target_batch=4, deadline=0.01)
    j_groups = j_srv.form_batches(j_reqs, target_batch=4, deadline=0.01)
    assert [[r.rid for r in g] for g in groups] == \
        [[r.rid for r in g] for g in j_groups]
    assert [[r.rid for r in g] for g in form_batch_groups(
        reqs, target_batch=4, deadline=0.01)] == \
        [[r.rid for r in g] for g in groups]
    outs = [c for rs in groups for c in srv.generate_batch(rs)]
    assert len(outs) == 6
    assert sorted({o.batch_size for o in outs}) == [2, 4]
    _assert_same([c for rs in j_groups for c in j_srv.generate_batch(rs)],
                 outs)


def test_context_limit_sets_truncated_flag(weights):
    """Mixed prompt lengths hitting max_seq: the ragged prompts are
    zero-padded and prefilled together, as in the reference."""
    j_srv, srv = _servers(weights, max_seq=8)
    j_reqs, reqs = _both([dict(rid=0, tokens=[1, 2, 3, 4], max_new_tokens=10),
                          dict(rid=1, tokens=[5, 6], max_new_tokens=2)])
    outs = {c.rid: c for c in srv.generate_batch(reqs)}
    assert outs[0].truncated
    assert 0 < len(outs[0].tokens) < 10
    assert not outs[1].truncated
    assert len(outs[1].tokens) == 2
    _assert_same(j_srv.generate_batch(j_reqs), [outs[0], outs[1]])


def test_prompt_longer_than_context_raises(weights):
    _, srv = _servers(weights, max_seq=4)
    (_, ), (req,) = _both([dict(rid=0, tokens=[1, 2, 3, 4],
                                max_new_tokens=2)])
    with pytest.raises(ValueError, match="max_seq=4"):
        srv.generate_batch([req])


def test_padding_changes_no_result(servers):
    """A batch of 3: the port's server pads no row, the reference's pads
    the batch to 4; each row's result is the same."""
    j_srv, srv = servers
    j_reqs, reqs = _both([dict(rid=i, tokens=[i + 1, 9, 4 + i],
                               max_new_tokens=4) for i in range(3)])
    outs = srv.generate_batch(reqs)
    assert [o.batch_size for o in outs] == [3] * 3
    _assert_same(j_srv.generate_batch(j_reqs), outs)


def test_rule_filter_drops_infeasible(weights):
    rs_j = j_rules(150, version=2, seed=3)
    rs = generate_rules(150, version=2, seed=3)
    j_eng = JEngine(j_compile(rs_j), backend="ref")
    table = compile_rules(rs)
    eng = ErbiumEngine(table, device="cpu")
    qs = generate_queries(rs, 4, seed=5, match_bias=1.0)
    assert qs == j_queries(rs_j, 4, seed=5, match_bias=1.0)
    dec = eng.match_queries(qs)[0].numpy()
    mct0 = int(dec[0]) if dec[0] >= 0 else table.default_decision
    mct2 = int(dec[2]) if dec[2] >= 0 else table.default_decision
    j_srv, srv = _servers(weights, (j_eng, eng), max_seq=32)
    spec = [dict(rid=0, tokens=[1, 2], max_new_tokens=2,
                 mct_queries=[qs[0]], connect_minutes=[mct0 + 30]),
            dict(rid=1, tokens=[1, 2], max_new_tokens=2,
                 mct_queries=[qs[1]], connect_minutes=[0]),
            # a missing connect time counts as 10**6 minutes: feasible
            dict(rid=2, tokens=[4, 2, 7], max_new_tokens=3,
                 mct_queries=[qs[2], qs[3]], connect_minutes=[mct2])]
    j_reqs, reqs = _both(spec)
    outs = srv.generate_batch(reqs)
    assert [o.rid for o in outs] == [0, 2]
    _assert_same(j_srv.generate_batch(j_reqs), outs)
    # all requests infeasible: nothing reaches the model
    j_bad, bad = _both([spec[1]])
    assert srv.generate_batch(bad) == [] == j_srv.generate_batch(j_bad)


def test_prepare_is_host_only_and_execute_caches_params(weights):
    _, cfg, _, params = weights
    srv = LMServer(cfg, params, device="cpu", max_seq=16)
    _, reqs = _both([dict(rid=0, tokens=[3, 4, 5], max_new_tokens=2),
                     dict(rid=1, tokens=[6], max_new_tokens=3)])
    pb = srv.prepare_batch(reqs)
    assert pb.toks.dtype == np.int32 and pb.toks.shape == (2, 3)
    np.testing.assert_array_equal(pb.toks[1], [6, 0, 0])
    assert pb.max_new == 3 and pb.mct_encoded is None
    first = srv.execute_prepared(pb, device="cpu")
    cached = srv._dev_params[torch.device("cpu")]
    again = srv.execute_prepared(pb, device="cpu")
    assert srv._dev_params[torch.device("cpu")] is cached
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    srv.warmup((1, 2))


def test_server_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        LMServer(get_config(ARCH).reduced())
