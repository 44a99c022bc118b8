"""MCT queries answered in the window, over the window, in ``mct-search``:
the host path's rate (searchers, batch formation, MCTWrapper's workers).
Read per layer there: it follows the host's speed, which on a shared host
swings by a fifth within a run and from run to run."""
from bench.harness.drivers.mct_search import Driver


def read(run):
    if "batches" not in run.data:
        return None
    n = sum(b["n"] for b in Driver.answered(run))
    return n / run.seconds if n else None
