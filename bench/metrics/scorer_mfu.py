"""Model FLOPs of the route scorer over the profiled sub-window's seconds
times the card's dense BF16 peak: the ``lm.prefill`` and ``lm.decode``
spans that end in the sub-window, each counted by the configuration's
work counter (``run.data["work"]``: real tokens only, the head at the
positions whose logits are taken) from the prompt lengths its batch's
``lm.prefill`` span carries."""
from bench.harness.spans import ending_in_window


def read(run):
    dev, work = run.device, run.data.get("work")
    keys = run.data.get("model_keys")
    spans = ending_in_window(run, ("lm.prefill", "lm.decode"))
    if dev is None or work is None or not spans or dev.window_s <= 0:
        return None
    lens = {s.meta["batch"]: s.meta["lens"] for s in run.data["spans"]
            if s.stage == "lm.prefill"}
    flops = 0
    for s in spans:
        if not dev.t0 <= s.t1 < dev.t1 or s.meta["batch"] not in lens:
            continue
        n = lens[s.meta["batch"]]
        if s.stage == "lm.prefill":
            flops += work.prefill_flops(keys, n)
        else:
            flops += work.decode_flops(keys, n, s.meta["pos"] - max(n))
    if not flops:
        return None
    return 100.0 * flops / (dev.window_s * work.PEAK_BF16_FLOPS)
