"""ASYNC SUBMISSION PIPELINE DEMO, from the PyTorch port: the paper's §5-6
imbalance, live; the port's copy of examples/async_serving.py.

One ``ServeConfig`` + ``build()`` (``repro_torch.serve``) stands up the
engine, replica group, scheduler and metrics. Sweeps open-loop offered
load through live sessions and prints the saturation and imbalance curve,
then contrasts the synchronous baseline with the pipelined path on the
same stream (equal tokens), a closed loop, simulated replicas behind the
same admission path, and one traced run.

Runs on the card unless ``--device cpu`` is given (no card: an error,
never a fall back). The route scorer is llama3.2-3b at full width (bf16)
on the card and reduced on the CPU; the replica and traced sections use
simulated engines on the host's clock.

Run:  PYTHONPATH=src python examples/torch_async_serving.py [--device cpu]
      PYTHONPATH=src python examples/torch_async_serving.py --smoke
"""
import argparse
import time

from repro_torch.device import resolve_device
from repro_torch.serve import (ClosedLoopGen, OpenLoopGen, ServeConfig,
                               SimServer, SyntheticWorkload, build, serve,
                               sim_requests)


def main(device="cuda", smoke: bool = False):
    dev = resolve_device(device)
    # --smoke shrinks every sweep: same code paths, same printed shape
    fractions = (0.5, 2.0) if smoke else (0.25, 0.5, 1.0, 2.0, 4.0)
    n_open = 32 if smoke else 64
    n_sim_batches = 12 if smoke else 32
    replica_counts = (1, 2) if smoke else (1, 2, 4)
    cfg = ServeConfig(model="llama3.2-3b", reduced=dev.type == "cpu",
                      device=dev, max_seq=48, target_batch=8, deadline=0.01,
                      max_queue=16, policy="reject", warmup=(1, 2, 4, 8))
    srv = build(cfg)
    workload = SyntheticWorkload(vocab=srv.engine.cfg.vocab, prompt_len=6,
                                 max_new_tokens=3, seed=1)

    # capacity: service rate with full batches
    warm = workload.build(8, rid_base=10_000)
    t0 = time.perf_counter()
    srv.engine.generate_batch(warm)
    cap = 8 / (time.perf_counter() - t0)
    print(f"measured capacity ~{cap:.0f} q/s at batch 8 on {dev}\n")

    print("open-loop sweep (offered load vs achieved / idle / latency):")
    for frac in fractions:
        qps = cap * frac
        # more requests than max_queue plus the ~3 batches in flight, so
        # overload can fill the queue and reject
        sched = srv.session()
        OpenLoopGen(workload, qps=qps, n=n_open,
                    seed=int(frac * 100)).drive(sched)
        sched.result()
        print(f"  {frac:4.2f}x  {sched.report(offered_qps=qps).summary()}")

    print("\nclosed-loop (concurrency 16, always-full batches):")
    sched = srv.session(policy="block", deadline=5.0, max_queue=64)
    ClosedLoopGen(workload, concurrency=16, n=16 if smoke else 32).drive(sched)
    outs = sched.result()
    print(f"  batch sizes: {sorted({o.batch_size for o in outs})}, "
          f"{sched.report().summary()}")

    print("\nsync baseline vs pipelined (same stream, equal tokens):")
    reqs = OpenLoopGen(workload, qps=cap, n=12 if smoke else 24,
                       seed=5).requests()
    t0 = time.perf_counter()
    srv.serve(reqs, mode="sync")
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.serve(reqs, mode="pipelined")
    pipe_s = time.perf_counter() - t0
    print(f"  sync {sync_s * 1e3:.0f} ms -> pipelined {pipe_s * 1e3:.0f} ms "
          f"({sync_s / pipe_s:.2f}x)")
    srv.close()

    print("\nsharded serving (simulated replicas, shared admission path):")
    sreqs = sim_requests(n_sim_batches * 8, max_new_tokens=4)
    for r in replica_counts:
        _, rep = serve(sreqs, replicas=r, target_batch=8, deadline=1.0,
                       server_factory=lambda i: SimServer(
                           host_ms_per_batch=3.0, device_ms_per_batch=8.0))
        print(f"  {r} replica(s): {rep.achieved_qps:6.0f} q/s  "
              f"(host-serial cap {1e3 / 3.0 * 8:.0f} q/s)")

    print("\ntraced run (where did the time go?):")
    with build(ServeConfig(
            replicas=2, target_batch=8, deadline=1.0, trace=True,
            server_factory=lambda i: SimServer(host_ms_per_batch=3.0,
                                               device_ms_per_batch=8.0))
            ) as tsrv:
        touts = tsrv.serve(sreqs[:64], mode="pipelined")
    print(f"  {tsrv.trace_report().summary()}")
    print(f"  {tsrv.tracer.timeline(touts[0].rid)}")
    print("done.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="smaller sweeps, same code paths")
    args = ap.parse_args()
    main(args.device, smoke=args.smoke)
