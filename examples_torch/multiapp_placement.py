"""Multi-application orchestration on the PyTorch port (paper Sec. V /
Fig. 8).

Six applications (three branchy DNNs x two datasets) share the multi-tier
system under resource slicing; FIN and MCP place every user's inference
pipeline.  Prints per-app energy gain, tier usage, failure rates and exit
distributions.

Run:  PYTHONPATH=src python examples_torch/multiapp_placement.py \
          [--users 30] [--device cpu]
It runs on ``cuda:0`` unless ``--device`` names another device.
"""
import argparse
import sys

import numpy as np

from repro_torch.core import run_multiapp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=30)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu: plain path)")
    args = ap.parse_args(argv)

    res = run_multiapp(args.users, seed=args.seed, device=args.device)
    print(f"{args.users} users per app, per-execution slice 0.5% "
          f"of edge/cloud\n")
    hdr = (f"{'app':5s} {'E_fin/E_mcp':>11s} {'fail_fin':>8s} "
           f"{'fail_mcp':>8s}  tiers(FIN)                exits(FIN)")
    print(hdr)
    for app in ("h1", "h2", "h3", "h4", "h5", "h6"):
        fin = res.stats[app]["fin"]
        mcp = res.stats[app]["mcp"]
        tiers = ",".join(f"{t}:{p:.2f}" for t, p in
                         sorted(fin.tier_probs().items()))
        exits = "/".join(f"{p:.2f}" for p in fin.exit_probs())
        print(f"{app:5s} {res.energy_gain(app):11.3f} "
              f"{fin.failure_prob:8.2f} {mcp.failure_prob:8.2f}  "
              f"{tiers:25s} {exits}")
    gains = [res.energy_gain(a) for a in res.stats]
    print(f"\nmean FIN/MCP energy ratio: {np.nanmean(gains):.3f} "
          f"(paper: 0.65-0.70 — 'over 65% savings' headline)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
