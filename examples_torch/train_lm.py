"""End-to-end training on the PyTorch port: the reference's "~100M"
early-exit LM for a few hundred steps on the synthetic k-gram stream, with
checkpoint/restart.

This is the qwen3 family at width 512 / 12 layers with the 8k-token vocab
(55.6M parameters by ``launch.flops.param_count``) and two early exits
trained jointly (BranchyNet loss): the paper's dynamic-DNN training
substrate at LM scale.  ``--small`` is a 3-layer, width-64 variant of the
same family for quick runs.

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--steps 200] \
          [--device cpu] [--small] [--ckpt DIR]
It runs on ``cuda:0`` unless ``--device`` names another device.  The
checkpoints go to ``build/train_lm`` under the repository root unless
``--ckpt`` names another directory; a run resumes from the newest there.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

from repro_torch.configs import get
from repro_torch.launch.flops import param_count
from repro_torch.runtime.train_loop import train

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "train_lm"


def build_config(small: bool = False):
    base = get("qwen3-4b")
    if small:
        return dataclasses.replace(
            base, name="qwen3-small", n_layers=3, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
            vocab_pad_multiple=64, exit_layers=(1, 2), dtype="float32",
            remat="none", attn_chunk=64)
    return dataclasses.replace(
        base,
        name="qwen3-100m",
        n_layers=12,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=8192,
        vocab_pad_multiple=256,
        exit_layers=(4, 8),
        dtype="float32",
        remat="none",
        attn_chunk=256,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(CKPT_DIR))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu: plain path)")
    args = ap.parse_args(argv)

    cfg = build_config(args.small)
    print(f"config {cfg.name}: ~{param_count(cfg)/1e6:.1f}M params, "
          f"exits at periods {cfg.exit_layer_list}")
    res = train(cfg, n_steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, ckpt_dir=args.ckpt, ckpt_every=50,
                log_every=20, seed=0, device=args.device)
    if not res.losses:
        print(f"\nthe checkpoint is at step {res.resumed_from}: nothing "
              f"left to run")
        return 0
    k = max(1, min(10, len(res.losses) // 2))
    first = float(np.mean(res.losses[:k]))
    last = float(np.mean(res.losses[-k:]))
    print(f"\nloss: {first:.4f} -> {last:.4f} over {res.steps} steps "
          f"(resumed_from={res.resumed_from})")
    if not last < first:
        raise SystemExit("training failed to reduce the joint exit loss")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
