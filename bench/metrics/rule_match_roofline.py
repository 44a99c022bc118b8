"""Share of its roofline that the rule-match lane reaches: the calls' least
time on the card (bench/work/mct.py: compares over the int32 issue rate or
bytes over the bandwidth, whichever is larger, for the pool's batches)
times the calls whose last kernel (rule_match_reduce) ran in the profiled
sub-window, over the device time of the kernels in it, copies left out."""


def read(run):
    dev, bound = run.device, run.data.get("lane_bound_s")
    if dev is None or not dev.aligned or bound is None:
        return None
    kernels = dev.kernels()
    calls = sum(1 for name, s, e in kernels if "rule_match_reduce" in name
                and dev.t0 <= s and e <= dev.t1)
    busy = sum(min(e, dev.t1) - max(s, dev.t0) for _, s, e in kernels
               if e > dev.t0 and s < dev.t1)
    if not calls or busy <= 0:
        return None
    return 100.0 * calls * bound / busy
