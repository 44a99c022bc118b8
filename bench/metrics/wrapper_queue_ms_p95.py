"""95th percentile of the time a batch waits in MCTWrapper's queue for a
worker (StageTimes.queue_us), over the batches answered in the window."""
import numpy as np


def read(run):
    q = [b["result"].times.queue_us * 1e-3 for b in run.data.get("batches", [])
         if "result" in b and run.t0 <= b["t_recv"] < run.t1]
    return float(np.percentile(q, 95)) if q else None
