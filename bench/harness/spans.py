"""The program's own spans in a traced run, and the clock check of the
device trace against them.

A driver that builds a ``repro_torch.serve.trace.Tracer`` for ``--trace 1``
hands its ring to the readers as ``run.data["spans"]`` (``Span`` objects,
``time.perf_counter`` seconds) and ``run.data["spans_dropped"]``. A reader
reads nothing where there are no spans (an untraced run, or a program
without them) or where the ring dropped any (the window is then not
whole).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional


def ending_in_window(run, stages) -> Optional[List[object]]:
    """The spans of ``stages`` that end inside the window, or None where
    the run holds no whole record of the program's spans."""
    spans = run.data.get("spans")
    if not spans or run.data.get("spans_dropped", 0):
        return None
    return [s for s in spans
            if s.stage in stages and run.t0 <= s.t1 < run.t1]


def _launch_starts(device) -> List[float]:
    """Start of each launch of the rule-match kernel in the device trace:
    its first ``rule_match_*`` kernel after the last launch's
    ``rule_match_reduce`` (launches that do not overlap, as one caller's)."""
    out, new = [], True
    for name, s, _ in sorted(((n, s, e) for n, s, e in device.ops
                              if "rule_match_" in n), key=lambda o: o[1]):
        if new and "rule_match_reduce" not in name:
            out.append(s)
            new = False
        elif "rule_match_reduce" in name:
            new = True
    return out


def clock_leads(spans, device) -> Dict[str, List[float]]:
    """Seconds from the host span that issues each call's lane kernels to
    their start in the device trace, for one caller's calls: ``launch``
    pairs each ``lane.launch`` with the next launch of the rule-match
    kernel, ``sort`` each ``lane.sort`` with the next
    ``radixSortKVInPlace``. The kernel is looked for from halfway back to
    the span's predecessor, so that a device trace placed too early (by up
    to half a call) reads as a negative lead. Spans outside the profiled
    sub-window are left out."""
    out: Dict[str, List[float]] = {}
    radix = sorted(s for n, s, _ in device.ops if "radixSortKVInPlace" in n)
    for key, stage, starts in (("launch", "lane.launch",
                                _launch_starts(device)),
                               ("sort", "lane.sort", radix)):
        opens = sorted(s.t0 for s in spans if s.stage == stage
                       and device.t0 <= s.t0 and s.t1 <= device.t1)
        leads = []
        for prev, t in zip(opens, opens[1:]):
            j = bisect.bisect_left(starts, 0.5 * (prev + t))
            if j < len(starts):
                leads.append(starts[j] - t)
        out[key] = leads
    return out
