"""Training launcher:  PYTHONPATH=src python -m repro_torch.launch.train \
    --arch qwen3-4b [--reduced | --full] --steps 100 --batch 8 --seq 128 \
    [--ckpt DIR] [--seed 0] [--device cpu]

Trains on the synthetic k-gram stream from seeded random weights, on
``cuda:0`` unless ``--device`` names another device (``cpu`` runs the
plain PyTorch path).  ``--reduced`` (the default) is the family's small
CPU-test configuration; ``--full`` is the published one (qwen3-4b's train
state is about 49 GB, so it wants a card of 80 GB).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..configs import ARCH_NAMES, get
from ..runtime.train_loop import train


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu: plain path)")
    args = ap.parse_args(argv)

    cfg = get(args.arch, reduced=args.reduced)
    res = train(cfg, n_steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, ckpt_dir=args.ckpt, seed=args.seed,
                device=args.device)
    if res.losses:
        print(f"done: {res.steps} steps, loss {res.losses[0]:.4f} -> "
              f"{res.losses[-1]:.4f}")
    else:
        print(f"done: the checkpoint is at step {res.resumed_from}, "
              f"nothing left to run")


if __name__ == "__main__":
    main()
