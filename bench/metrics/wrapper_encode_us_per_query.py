"""Host encode time a query in MCTWrapper (StageTimes.encode_us over the
batch size), over the batches answered in the window."""


def read(run):
    res = [b["result"] for b in run.data.get("batches", [])
           if "result" in b and run.t0 <= b["t_recv"] < run.t1]
    n = sum(r.times.batch for r in res)
    return sum(r.times.encode_us for r in res) / n if n else None
