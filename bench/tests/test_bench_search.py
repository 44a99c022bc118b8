"""``mct-search``'s end-to-end metric, the card's queries per busy second,
and the host path's rate and tail read per layer, on hand-made records with
known values; and a CPU run of the cell (no card: no device trace, so no
end-to-end metric but ``setup_s``, and the readers read the host path)."""
import numpy as np
import pytest
import torch

from bench.harness import core
from bench.harness.drivers.mct_search import Driver
from bench.harness.profile import DeviceTrace
from bench.tests.test_bench_faults import SEARCH, SMALL_MCT


def _hand_made(device=True):
    """Window 10..20 s: three batches answered inside it (100, 200, 300
    queries), one before and one after; searches of 50, 150, 250 ms done
    inside it, one after; the card busy 0.5 s inside the window (two ops
    overlapping, one clipped at each edge)."""
    batches = [{"n": n, "t_recv": t} for n, t in
               ((100, 11.0), (200, 15.0), (300, 19.9), (400, 9.9),
                (500, 20.0))] + [{"n": 7, "t_sub": 12.0}]
    searches = [{"t_first": 12.0 - ms * 1e-3, "t_done": 12.0}
                for ms in (50, 150, 250)]
    searches += [{"t_first": 19.99, "t_done": 20.1}, {"t_first": 19.5}]
    dev = DeviceTrace(t0=10.0, t1=20.0, aligned=True, ops=[
        ("k", 9.9, 10.1), ("k", 12.0, 12.2), ("k", 12.1, 12.3),
        ("Memcpy", 19.9, 20.5)]) if device else None
    return core.TracedRun(10.0, 20.0, data={"batches": batches,
                                            "searches": searches},
                          device=dev)


def _driver():
    return Driver.__new__(Driver)


def test_queries_per_busy_second_known_value():
    got = _driver().end_to_end(_hand_made())
    assert got == {"mct_queries_per_busy_s": pytest.approx(600 / 0.5)}


@pytest.mark.parametrize("case", ["no_trace", "not_aligned", "idle",
                                  "no_answers"])
def test_queries_per_busy_second_reads_nothing_without_its_record(case):
    run = _hand_made(device=case != "no_trace")
    if case == "not_aligned":
        run.device.aligned = False
    elif case == "idle":
        run.device.ops = []
    elif case == "no_answers":
        run.data["batches"] = []
    assert _driver().end_to_end(run) == {}


@pytest.mark.parametrize("name,want", [
    ("mct_queries_per_s.search", 600 / 10.0),
    ("search_p95_ms.search", float(np.percentile([50, 150, 250], 95)))])
def test_host_path_readers_known_value(name, want):
    got = core.load_reader(name).read(_hand_made())
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ["mct_queries_per_s.search",
                                  "search_p95_ms.search"])
def test_host_path_readers_read_nothing_without_records(name):
    reader = core.load_reader(name)
    assert reader.read(core.TracedRun(0.0, 1.0)) is None
    run = _hand_made()
    run.data = {"batches": [], "searches": []}
    assert reader.read(run) is None


def test_cpu_run_reports_set_up_only_and_readers_read_the_host_path():
    torch.set_num_threads(2)
    out = core.run("mct-search", 2**31 + 11, 2.0, False, device="cpu",
                   config_overrides=SMALL_MCT, traffic_overrides=SEARCH)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s"}
    out = core.run("mct-search", 2**31 + 11, 2.0, True, device="cpu",
                   config_overrides=SMALL_MCT, traffic_overrides=SEARCH)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["mct_queries_per_s.search"]["value"] > 0
    assert m["search_p95_ms.search"]["value"] > 0
    assert "device_idle.mct" not in m
