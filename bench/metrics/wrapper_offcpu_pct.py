"""Share of the MCT Wrapper workers' stage time in which the worker thread
was not running on a CPU: the sum of (wall - cpu_us) over the sum of wall,
over the ``encode``, ``dispatch``, ``device_execute`` and ``collect`` spans
of the batches handed back to the caller in the window (``handoff`` ending
there). Off-CPU here is runnable and waiting for the interpreter lock, or
blocked; the card's synchronize spins, so it counts as CPU."""
from bench.harness.spans import ending_in_window

STAGES = ("encode", "dispatch", "device_execute", "collect")


def read(run):
    done = ending_in_window(run, ("handoff",))
    if not done:
        return None
    uids = {s.meta["uid"] for s in done}
    wall = cpu = 0.0
    for s in run.data["spans"]:
        if s.stage in STAGES and s.meta["uid"] in uids:
            wall += (s.t1 - s.t0) * 1e6
            cpu += s.meta["cpu_us"]
    return 100.0 * (wall - cpu) / wall if wall > 0 else None
