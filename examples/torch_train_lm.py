"""Train an LM from the assigned-architecture zoo on the synthetic pipeline
with checkpointing + (optional) injected failure + restart, through the
PyTorch port (``repro_torch.train.loop.fit``). The port's copy of
examples/train_lm.py, with the same flags plus ``--device``.

Default is a small model of the arch's family; pass --width/--layers to
scale it. Runs on the card unless ``--device cpu`` is given (no card: an
error, never a fall back).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
      PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
          --steps 20 --inject-failure-at 12
"""
import argparse
import dataclasses
from pathlib import Path

from repro_torch.configs.base import get_config
from repro_torch.ft.failures import FailureInjector
from repro_torch.train.loop import TrainConfig, fit

CKPT_DEFAULT = Path(__file__).resolve().parent.parent / "build" / \
    "torch_train_lm_ckpt"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt", default=str(CKPT_DEFAULT))
    ap.add_argument("--inject-failure-at", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(cfg, d_model=args.width,
                              n_layers=args.layers,
                              d_ff=args.width * 4 if cfg.d_ff else 0)
    n = cfg.n_params()
    print(f"{args.arch} (reduced to {n / 1e6:.1f}M params), "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq} "
          f"on {args.device}")

    inj = None
    if args.inject_failure_at:
        inj = FailureInjector({args.inject_failure_at: "host0"})
    tc = TrainConfig(steps=args.steps, batch=args.batch, seq_len=args.seq,
                     lr=1e-3, warmup=20, microbatches=args.microbatches,
                     ckpt_dir=args.ckpt, ckpt_every=50, log_every=10)
    res = fit(cfg, tc, injector=inj, device=args.device)
    if not res.losses:
        print(f"nothing to train: {args.ckpt} already holds step "
              f"{res.steps_done}")
        return
    print(f"done: {res.steps_done} steps, {res.restarts} restarts, "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}, "
          f"median step {sorted(res.step_times)[len(res.step_times)//2]*1e3:.0f} ms")


if __name__ == "__main__":
    main()
