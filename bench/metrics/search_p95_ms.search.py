"""95th percentile of the searches finished in the window, first batch
submitted to last answer, in ``mct-search``: the host path's tail, read per
layer there for the reason ``mct_queries_per_s.search`` is."""
import numpy as np

from bench.harness.drivers.mct_search import Driver


def read(run):
    if "searches" not in run.data:
        return None
    lat = Driver.search_ms(run)
    return float(np.percentile(lat, 95)) if lat else None
