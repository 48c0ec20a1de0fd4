"""Serving launcher:  PYTHONPATH=src python -m repro_torch.launch.serve \
    --arch qwen3-4b --requests 16 --max-new 8 [--threshold 0.7] [--device cpu]

Runs the split-serving engine (exit-aware continuous batching) on the
reduced config of any decoder architecture (dense, MoE, Mamba-2 SSM,
hybrid, vision; the encoder-only hubert-xlarge has no serve path) with a
FIN placement over the paper's mobile-edge-cloud system, and reports
throughput / exit usage / placement-model energy.  The counterpart of ``repro/launch/serve.py`` with the same flags, plus
``--device``: it runs on ``cuda:0`` unless ``--device cpu`` is given.  The
weights are drawn from ``torch.Generator(...).manual_seed(0)``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..configs import ARCH_NAMES, get
from ..core import AppRequirements, paper_profile
from ..core.scenarios import paper_scenario
from ..models import transformer as T
from ..runtime.serve_engine import SplitServeEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get(args.arch, reduced=True)
    if not cfg.has_decoder:
        raise SystemExit(f"{args.arch} is encoder-only; no serve path")
    params = T.init_model(cfg, seed=0, device=args.device)
    eng = SplitServeEngine(
        cfg, params, batch_size=args.batch, cache_len=256,
        thresholds=[args.threshold] * (len(cfg.exit_layer_list)),
        network=paper_scenario(), profile=paper_profile("h2"),
        req=AppRequirements(alpha=0.55, delta=8e-3), device=args.device)
    for i in range(args.requests):
        eng.submit([1 + i % 7, 2, 3], max_new_tokens=args.max_new)
    stats = eng.run()
    print(f"steps={stats.steps} tokens={stats.tokens_out} "
          f"phi={stats.measured_phi} energy={stats.energy_j*1e3:.2f}mJ "
          f"blocks saved={stats.blocks_saved}")


if __name__ == "__main__":
    main()
