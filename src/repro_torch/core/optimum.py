"""Opt: exhaustive-search optimum (Sec. V benchmark).

Port of ``repro/core/optimum.py``: host code over the exact evaluator.

Enumerates every (final exit k, block->node assignment) pair, evaluates each
exactly with the shared evaluator, and returns the min-energy feasible
configuration.  Guarded by ``max_space`` — the paper itself notes the
multi-application scenario is impractical for Opt.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional

from .dnn_profile import DNNProfile
from .problem import AppRequirements, Config, Solution, evaluate_config
from .system_model import Network


def solve_opt(network: Network, profile: DNNProfile, req: AppRequirements,
              *, max_space: int = 2_000_000,
              check_aggregate_load: bool = False) -> Solution:
    t0 = time.perf_counter()
    N = network.n_nodes

    space = sum(N ** (profile.exits[k].block + 1) for k in range(profile.n_exits))
    if space > max_space:
        raise ValueError(f"Opt search space {space} exceeds max_space={max_space}")

    best_cfg: Optional[Config] = None
    best_ev = None
    for k in range(profile.n_exits):
        if profile.accuracy_of(k) < req.alpha - 1e-12:
            continue
        n_blocks = profile.exits[k].block + 1
        for assign in itertools.product(range(N), repeat=n_blocks):
            cfg = Config(placement=list(assign), final_exit=k)
            ev = evaluate_config(network, profile, req, cfg,
                                 check_aggregate_load=check_aggregate_load)
            if ev.feasible and (best_ev is None or ev.energy < best_ev.energy):
                best_cfg, best_ev = cfg, ev
    dt = time.perf_counter() - t0
    return Solution(config=best_cfg, eval=best_ev, solve_time=dt, solver="opt",
                    meta={"space": space})
