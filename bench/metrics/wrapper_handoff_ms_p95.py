"""95th percentile of the MCT Wrapper's hand-off: from a worker's end of a
batch to the caller's ``drain`` returning it (``handoff`` spans ending in
the window)."""
import numpy as np

from bench.harness.spans import ending_in_window


def read(run):
    spans = ending_in_window(run, ("handoff",))
    if not spans:
        return None
    return float(np.percentile([(s.t1 - s.t0) * 1e3 for s in spans], 95))
