"""END TO END, from the PyTorch port: a miniature flight-search
serving stack, the paper's architecture on one box; the port's copy of
examples/serve_search_engine.py.

  Injector (replayed workload)
    -> Domain Explorer (user query -> Travel Solutions -> MCT queries)
    -> paper_policy batches (the paper's §5 lesson)
    -> MCT Wrapper (workers) -> ERBIUM rule engine   [connection filtering]
    -> LM route scorer (llama3.2-3b)                 [Fig 14 co-location]

Runs on the card unless ``--device cpu`` is given (no card: an error,
never a fall back). On the card the engine runs the CUDA rule-match kernel
and the route scorer is llama3.2-3b at full width (bf16); on the CPU the
kernel's plain version and the reduced model.

Run:  PYTHONPATH=src python examples/torch_serve_search_engine.py \\
          [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.aggregator import batch_stats, paper_policy
from repro_torch.core.compiler import compile_rules
from repro_torch.core.engine import ErbiumEngine
from repro_torch.core.rules import generate_rules
from repro_torch.core.workload import generate_workload, workload_stats
from repro_torch.core.wrapper import MCTWrapper
from repro_torch.device import resolve_device
from repro_torch.serve import Request, serve

ARCH = "llama3.2-3b"


def main(device="cuda"):
    dev = resolve_device(device)
    # offline: rules + engine
    ruleset = generate_rules(2_000, version=2, seed=0)
    table = compile_rules(ruleset)
    engine = ErbiumEngine(table, device=dev)

    # injector: replay a production-shaped trace
    wl = generate_workload(ruleset, 8, seed=3, mean_ts=120.0)
    print("workload:", workload_stats(wl))

    # MCT stage: wrapper with 2 workers, paper batching policy
    wrap = MCTWrapper([engine], n_workers=2)
    wrap.start()
    t0 = time.perf_counter()
    batches = [b for uq in wl for b in paper_policy(uq)]
    for b in batches:
        wrap.submit(b)
    results = wrap.drain(len(batches))
    wrap.stop()
    mct_s = time.perf_counter() - t0
    total_q = sum(len(r.decisions) for r in results)
    print(f"MCT stage on {dev}: {total_q} queries in {len(batches)} batches "
          f"({batch_stats(batches)}) -> {total_q / mct_s:.0f} q/s end-to-end")

    # route scoring stage: the LM server scores surviving routes behind the
    # repro_torch.serve front end, host encode of batch N+1 overlapped with
    # device execution of batch N
    reduced = dev.type == "cpu"
    from repro_torch.configs.base import get_config
    cfg = get_config(ARCH)
    vocab = (cfg.reduced() if reduced else cfg).vocab
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=rng.integers(1, vocab, 8).astype(np.int32),
                    max_new_tokens=4, arrival=i * 0.002)
            for i in range(12)]
    outs, rep = serve(reqs, model=ARCH, reduced=reduced, device=dev,
                      max_seq=64, target_batch=4, deadline=0.01, warmup=(4,))
    print(f"route scoring ({ARCH}, {'reduced' if reduced else 'full width'}"
          f"): {len(outs)} requests served, batch sizes "
          f"{[o.batch_size for o in outs]}")
    print(f"  prefill {np.mean([o.prefill_ms for o in outs]):.1f} ms, "
          f"decode {np.mean([o.decode_ms for o in outs]):.1f} ms (batched)")
    print(f"  {rep.summary()}")
    print("done.")
    return results, outs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
