"""Split serving on the PyTorch port: a FIN-placed early-exit LM with
continuous batching.

Builds the reduced qwen3-4b early-exit LM from seeded random weights,
solves the FIN placement over the mobile-edge-cloud system (B1), then
serves a request stream with exit-aware continuous batching (the exit gate
B6 and the flash-decode attention B7), including a mid-run node failure
that triggers an elastic FIN re-placement, and the node's recovery.

Run:  PYTHONPATH=src python examples_torch/serve_split.py [--device cpu]
It runs on ``cuda:0`` unless ``--device`` names another device.
"""
import argparse
import sys

from repro_torch import resolve_device
from repro_torch.configs import get
from repro_torch.core import AppRequirements, paper_profile
from repro_torch.core.scenarios import paper_scenario
from repro_torch.models import transformer as T
from repro_torch.runtime.serve_engine import SplitServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu: plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get("qwen3-4b", reduced=True)
    params = T.init_model(cfg, seed=0, device=dev)
    # a degraded uplink pushes the placement off the mobile tier, so the
    # mid-run failure below actually re-places (warm, via the plan IR)
    network = paper_scenario(uplink_bps=0.3e9)
    profile = paper_profile("h1")
    req = AppRequirements(alpha=0.55, delta=5e-3)

    eng = SplitServeEngine(cfg, params, batch_size=4, cache_len=128,
                           thresholds=[0.6], network=network,
                           profile=profile, req=req, device=dev)
    tiers = [n.tier for n in network.nodes]
    print("FIN placement:",
          [f"l{i+1}@{tiers[n]}" for i, n in
           enumerate(eng.placement.placement)],
          f"exit-{eng.placement.final_exit + 1}")

    for i in range(12):
        eng.submit([1 + i, 2, 3], max_new_tokens=6)

    # serve half the load, then lose the deepest-tier node
    for _ in range(24):
        eng.step()
    victim = max(p for p in eng.placement.placement)
    if victim != network.source_node:
        print(f"\n!! node {network.nodes[victim].name} fails — warm re-solve")
        eng.fail_node(victim)
        print("new placement:",
              [f"l{i+1}@{eng.network.tier_of(n)}" for i, n in
               enumerate(eng.placement.placement)],
              f"({eng.stats.blocks_migrated} blocks migrated, "
              f"{eng.stats.migration_bits/8e6:.2f} MB of cut state)")
        for _ in range(12):
            eng.step()
        print(f"   node {network.nodes[victim].name} recovers")
        eng.recover_node(victim)
    stats = eng.run(max_steps=500)

    print(f"\nsteps            : {stats.steps}")
    print(f"tokens generated : {stats.tokens_out}")
    print(f"exit usage (phi) : {stats.measured_phi}")
    print(f"blocks executed  : {stats.blocks_executed} "
          f"(saved by exits: {stats.blocks_saved})")
    print(f"placement energy : {stats.energy_j*1e3:.3f} mJ")
    print(f"re-placements    : {stats.replacements}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
