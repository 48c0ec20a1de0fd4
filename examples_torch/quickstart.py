"""Quickstart on the PyTorch port: the paper in 60 seconds.

1. Build the mobile-edge-cloud system and a branchy DNN profile (B-AlexNet).
2. Solve the placement with FIN (the banded (min,+) chain B1), MCP and
   exhaustive Opt.
3. Compare energy / latency / accuracy and show the chosen split.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
It runs on ``cuda:0`` unless ``--device`` names another device, and raises
where no card is present and none was named.
"""
import argparse
import sys

from repro_torch import resolve_device
from repro_torch.core import (AppRequirements, paper_profile, solve_fin,
                              solve_mcp, solve_opt)
from repro_torch.core.scenarios import paper_scenario


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; cpu: plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    network = paper_scenario()
    profile = paper_profile("h2")          # B-AlexNet / CIFAR10 (Table II)
    req = AppRequirements(alpha=0.80, delta=5e-3, sigma=1.0)

    print(f"system : {[n.name for n in network.nodes]}")
    print(f"model  : {profile.name} ({profile.n_blocks} blocks, "
          f"{profile.n_exits} exits)")
    print(f"target : accuracy >= {req.alpha:.0%}, latency <= "
          f"{req.delta*1e3:g} ms\n")

    tiers = [n.tier for n in network.nodes]
    for name, solver, kwargs in (
            ("FIN(g=10)", solve_fin, dict(gamma=10, device=dev)),
            ("MCP", solve_mcp, dict(device=dev)),
            ("Opt", solve_opt, {})):
        sol = solver(network, profile, req, **kwargs)
        if not sol.found:
            print(f"{name:10s} -> no configuration found")
            continue
        ev = sol.eval
        place = " -> ".join(
            f"l{i+1}@{tiers[n]}" for i, n in
            enumerate(sol.config.placement))
        flag = "" if ev.feasible else "  [INFEASIBLE]"
        print(f"{name:10s} energy {ev.energy*1e3:7.3f} mJ | latency "
              f"{ev.latency*1e3:6.3f} ms | acc {ev.accuracy:.1%} | "
              f"exit-{sol.config.final_exit + 1}{flag}")
        print(f"{'':10s} {place}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
