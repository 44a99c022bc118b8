"""Padded share of the prefill tokens the route scorer computed in the
window: the program's counter ``LMServer.prefill_counts`` (prompt tokens,
and the padding of each prefill sub-batch to its own longest prompt),
which the configuration lists under ``counters``, read at the window's
open and close."""


def read(run):
    counts = run.data.get("counts", {}).get("prefill_counts")
    if not counts:
        return None
    (r0, p0), (r1, p1) = counts
    real, pad = r1 - r0, p1 - p0
    return 100.0 * pad / (real + pad) if real + pad > 0 else None
