"""Host time a call of ``ErbiumEngine.match``: the mean duration of the
program's ``match`` spans ending in the window (upload, sort, launch and
lookup on the host; the card's time is not in it unless the host waits)."""
from bench.harness.spans import ending_in_window


def read(run):
    spans = ending_in_window(run, ("match",))
    if not spans:
        return None
    return sum((s.t1 - s.t0) * 1e6 for s in spans) / len(spans)
