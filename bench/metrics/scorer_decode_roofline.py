"""Share of its roofline that the route scorer's decode step reaches: the
bytes each ``lm.decode`` span's step must move (the configuration's work
counter, ``run.data["work"].decode_bytes``) over the card's bandwidth,
summed over the spans inside the profiled sub-window, over the device time
of the kernels that start inside those spans (copies and sets left out)."""
from bench.harness.spans import ending_in_window
from bench.work import peaks


def read(run):
    dev, work = run.device, run.data.get("work")
    keys = run.data.get("model_keys")
    spans = ending_in_window(run, ("lm.decode",))
    if dev is None or not dev.aligned or work is None or not spans:
        return None
    lens = {s.meta["batch"]: s.meta["lens"] for s in run.data["spans"]
            if s.stage == "lm.prefill"}
    steps = sorted((s.t0, s.t1, s) for s in spans
                   if dev.t0 <= s.t0 and s.t1 <= dev.t1
                   and s.meta["batch"] in lens)
    if not steps:
        return None
    bound = sum(work.decode_bytes(keys, lens[s.meta["batch"]],
                                  s.meta["pos"] - max(lens[s.meta["batch"]]))
                for _, _, s in steps) / peaks.HBM_BYTES_PER_S
    kernels = sorted((k[1], k[2]) for k in dev.kernels())
    busy, i = 0.0, 0
    for t0, t1, _ in steps:
        while i < len(kernels) and kernels[i][0] < t0:
            i += 1
        j = i
        while j < len(kernels) and kernels[j][0] < t1:
            busy += kernels[j][1] - kernels[j][0]
            j += 1
    return 100.0 * bound / busy if busy > 0 else None
