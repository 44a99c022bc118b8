"""Paper Fig. 4 from the port: stand-alone engine throughput against batch
size, MCT v1 against v2, 1/2/4 evaluation engines; the counterpart of
``benchmarks/fig4_throughput.py``.

Each point times ``ops.match_rules`` on the packed device table (the CUDA
rule-match kernel on the card, its plain version on the CPU) with the
batch already on the device; the clock stops after the card has finished.
The paper's claims: latency flat until the pipeline saturates, then a
throughput plateau; v2 saturates lower than v1 (its ratio 32M/40M = 0.80);
engines scale sub-linearly. On the card, ``n_engines`` splits the batch
into lanes that run one after another on one stream, so more engines mean
more, smaller launches: they cannot scale as the FPGA's engines do.

Each point is the median of ``repeats`` calls (the reference's 3 by
default); its rows also carry the quartiles, and the derived ratio its
range from them, since a call of 0.2-1 ms on the host's clock varies from
call to call. The results of every point are kept and must not depend on
``n_engines``.

    PYTHONPATH=src python3 benchmarks/torch_fig4_throughput.py [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from torch_common import Bench, cli

BATCHES = (256, 1024, 4096, 8192)
ENGINES = (1, 2, 4)
VERSIONS = (1, 2)


def run(bench: Bench = None, *, repeats: int = 3):
    """Returns ``(qps, outputs)``, each keyed ``(version, n_engines, B)``;
    outputs are numpy ``(decision, weight, rule_id)``."""
    bench = bench or Bench.on()
    qps, outputs, quartiles = {}, {}, {}
    for version in VERSIONS:
        dt = bench.engine(version).dt
        enc = bench.system(version).encoded
        for n_eng in ENGINES:
            for b in BATCHES:
                q = torch.as_tensor(enc[:b], dtype=torch.int32,
                                    device=bench.device)
                ts = bench.times_us(ops.match_rules, q, dt,
                                    n_engines=n_eng, repeats=repeats)
                us, p25, p75 = np.percentile(ts, (50, 25, 75))
                key = (version, n_eng, b)
                qps[key] = b / (us / 1e6)
                quartiles[key] = (p25, p75)
                bench.emit(f"fig4/v{version}_e{n_eng}_b{b}", us,
                           f"qps={qps[key]:.3e} us_p25={p25:.1f} "
                           f"us_p75={p75:.1f}", qps=qps[key],
                           us_p25=p25, us_p75=p75, repeats=repeats)
                outputs[(version, n_eng, b)] = tuple(
                    x.cpu().numpy()
                    for x in ops.match_rules(q, dt, n_engines=n_eng))
                one = outputs[(version, ENGINES[0], b)]
                if not all(np.array_equal(x, y) for x, y in
                           zip(outputs[(version, n_eng, b)], one)):
                    raise RuntimeError(
                        f"fig4 v{version} B={b}: n_engines={n_eng} changed "
                        "the results")
    v2, v1 = (quartiles[(v, ENGINES[-1], max(BATCHES))] for v in (2, 1))
    ratio = qps[(2, ENGINES[-1], max(BATCHES))] \
        / qps[(1, ENGINES[-1], max(BATCHES))]
    # v2's queries/s over v1's at the quartiles' extremes
    lo, hi = v1[0] / v2[1], v1[1] / v2[0]
    bench.emit("fig4/v2_vs_v1_saturated", 0.0,
               f"ratio={ratio:.2f} quartile_range={lo:.2f}-{hi:.2f} "
               f"(paper: 32M/40M = 0.80)", ratio=ratio, ratio_lo=lo,
               ratio_hi=hi)
    return qps, outputs


if __name__ == "__main__":
    run(cli(__doc__)[0])
