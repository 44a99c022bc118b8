"""A whole run of each cell on the CPU at a tiny size, its chip check
skipped, with the timed path broken underneath: ``correct`` must come out
false. One case for each fault the cell can have: an answer altered where
it is produced, half of a batch left out (its answers taken from the other
half)."""
import pytest
import torch

from bench.harness import core

SMALL_MCT = {"n_rules": 2_000}
SEARCH = {"searchers": 4, "n_searches": 16, "query_pool": 512,
          "warmup_s": 0.3, "warm_batch": 600, "check_queries": 2_000}
ENCODED = {"batch": 256, "pool_batches": 3, "keep_every": 2,
           "warmup_s": 0.3, "check_queries": 1_000}
TRAFFIC = {"mct-search": SEARCH, "mct-encoded": ENCODED}


def _run(cell, seed=3):
    torch.set_num_threads(2)
    return core.run(cell, seed, 2.0, False, device="cpu",
                    config_overrides=SMALL_MCT,
                    traffic_overrides=TRAFFIC[cell])


def _altered(match):
    def bad(self, encoded):
        dec, w, rid = match(self, encoded)
        dec = dec.clone()
        dec[::8] += 5
        return dec, w, rid
    return bad


def _half(match):
    def bad(self, encoded):
        q = torch.as_tensor(encoded)
        h = (len(q) + 1) // 2
        outs = match(self, q[:h])
        return tuple(torch.cat([o, o[:len(q) - h]]) for o in outs)
    return bad


@pytest.mark.parametrize("cell", ["mct-search", "mct-encoded"])
@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_mct_fault_is_not_correct(monkeypatch, cell, fault):
    from repro_torch.core.engine import ErbiumEngine
    wrap = _altered if fault == "answer_altered" else _half
    monkeypatch.setattr(ErbiumEngine, "match", wrap(ErbiumEngine.match))
    out = _run(cell)
    assert out["correct"] is False
    assert out["checks"]["mct_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", ["mct-search", "mct-encoded"])
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True, out["checks"]
