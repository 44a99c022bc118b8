"""Paper Fig. 6 from the port: the execution time of an MCT request split
into stages (queue, encode, dispatch, kernel, collect) against batch size;
the counterpart of ``benchmarks/fig6_overheads.py``.

The kernel stage is the CUDA rule-match kernel through ``ErbiumEngine``
(its plain version on the CPU), timed by ``MCTWrapper`` up to the card's
synchronisation. The paper's claims: small batches are dominated by
dispatch overheads, large ones by the host's (linear) encoder, which
exceeds the kernel; the derived row gives the measured encode over the
measured kernel at the largest batch.

    PYTHONPATH=src python3 benchmarks/torch_fig6_overheads.py [--device cpu]
"""
from __future__ import annotations

from repro_torch.core.wrapper import measure_stage_times
from torch_common import Bench, batch_maker, cli

BATCHES = (64, 256, 1024, 4096, 8192)


def run(bench: Bench = None):
    bench = bench or Bench.on()
    times = measure_stage_times(bench.engine(2),
                                batch_maker(bench.system(2).queries),
                                BATCHES, repeats=3)
    for t in times:
        bench.emit(f"fig6/b{t.batch}", t.total_us,
                   f"encode={t.encode_us:.0f};dispatch={t.dispatch_us:.0f};"
                   f"kernel={t.kernel_us:.0f};collect={t.collect_us:.0f}",
                   **vars(t))
    big = times[-1]
    ratio = big.encode_us / max(big.kernel_us, 1e-3)
    bench.emit("fig6/encoder_dominates_at_large_batch", 0.0,
               f"encode/kernel={ratio:.2f} at B={big.batch} (paper: encoder "
               f"> kernel on the accelerator target)", ratio=ratio)
    return times


if __name__ == "__main__":
    run(cli(__doc__)[0])
