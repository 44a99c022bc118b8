"""Mean size of the MCT batches the searchers' paper_policy formed and
submitted in the window (queries a batch): the batch-formation layer
(core/aggregator.py)."""


def read(run):
    sizes = [b["n"] for b in run.data.get("batches", [])
             if b["t_sub"] is not None and run.t0 <= b["t_sub"] < run.t1]
    return sum(sizes) / len(sizes) if sizes else None
