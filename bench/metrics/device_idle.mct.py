"""Share of the profiled sub-window in which no operation (kernel, copy or
set) ran on the card, in the MCT cells."""


def read(run):
    dev = run.device
    if dev is None or not dev.aligned or dev.window_s <= 0 or not dev.ops:
        return None
    return 100.0 * (1.0 - dev.busy_s() / dev.window_s)
