"""MCP baseline: multi-constrained path selection (Xue et al. [17]).

Port of ``repro/core/mcp.py``; the baseline is host code.

MCP operates on the *extended* graph (no depth replication).  Each edge
v -> v' gets the auxiliary additive weight of Sec. V-B:

    Omega(v, v') = (T(v, v') + C(v, v')) / delta + max(0, alpha - a(v')) / alpha

where a(v') is the accuracy of the deepest exit in the block sequence up to
v'.  NOTE: the paper prints the accuracy term as ``a(v')/alpha``; taken
literally that *rewards* low accuracy and makes MCP stop at exit-1 for every
application (100% failure whenever exit-1 misses alpha) — inconsistent with
Fig. 8, where MCP reaches deep exits with substantial probability.  Xue et
al. [17] normalize additive constraint *violations*, so we use the accuracy
deficit; this reproduces the paper's reported MCP behaviour (deep exits,
20-30% failure from resource constraints, poor energy).

The minimum-Omega path is selected (layered DP, exact) and only then checked
against the true constraints — MCP has no feasibility-by-construction
guarantee, hence its failure rates (Fig. 8 center-right).
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from .._device import DeviceLike
from .dnn_profile import DNNProfile
from .extended_graph import build_extended_graph
from .problem import AppRequirements, Config, Solution, evaluate_config
from .system_model import Network


def solve_mcp(network: Network, profile: DNNProfile, req: AppRequirements,
              *, check_aggregate_load: bool = False,
              device: DeviceLike = None) -> Solution:
    """Min-Omega path on the extended graph, then the exact post-check.

    The extended graph is built on ``device`` (default ``cuda:0``); the
    L-step DP over N nodes runs on the host in float64, as in the
    reference."""
    t0 = time.perf_counter()
    ext = build_extended_graph(network, profile, req, device=device)
    N, L = ext.n_nodes, ext.n_blocks
    init_T = ext.init_T.cpu().numpy()
    TT = ext.TT.cpu().numpy()

    # Omega edge weights on the extended graph.  Connectivity-only pruning
    # (zero-bandwidth links); resource constraints are post-checked, per [17].
    link_ok = (network.bandwidth > 0) | np.eye(N, dtype=bool)
    # accuracy-deficit term (see module docstring)
    acc_term = np.maximum(0.0, req.alpha - ext.acc_seq) / max(req.alpha, 1e-12)

    dist = np.full((L, N), np.inf)
    par = np.full((L, N), -1, dtype=np.int64)
    init_ok = np.isfinite(init_T)
    dist[0] = np.where(init_ok,
                       init_T / req.delta + acc_term[0], np.inf)

    for i in range(L - 1):
        w = TT[i] / req.delta + acc_term[i + 1]          # (N, N)
        w = np.where(link_ok & np.isfinite(TT[i]), w, np.inf)
        cand = dist[i][:, None] + w
        par[i + 1] = np.argmin(cand, axis=0)
        dist[i + 1] = cand[par[i + 1], np.arange(N)]

    # candidate destinations: exit vertices whose accuracy meets alpha (the
    # destination constraint (3c) is known upfront, as in [17]); among them
    # pick the min-Omega one.  Resource feasibility is *not* guaranteed.
    best: Optional[Tuple[float, int, int]] = None   # (omega, exit k, node)
    for k in range(profile.n_exits):
        if profile.accuracy_of(k) < req.alpha - 1e-12:
            continue
        b = profile.exits[k].block
        n = int(np.argmin(dist[b]))
        if np.isfinite(dist[b, n]):
            key = (float(dist[b, n]), k, n)
            if best is None or key[0] < best[0]:
                best = key

    dt = time.perf_counter() - t0
    if best is None:
        return Solution(config=None, eval=None, solve_time=dt, solver="mcp",
                        meta={"reason": "disconnected"})

    _, k, n = best
    b = profile.exits[k].block
    place = [n]
    i, cur = b, n
    while i > 0:
        cur = int(par[i, cur])
        place.append(cur)
        i -= 1
    cfg = Config(placement=place[::-1], final_exit=k)
    ev = evaluate_config(network, profile, req, cfg,
                         check_aggregate_load=check_aggregate_load)
    dt = time.perf_counter() - t0
    return Solution(config=cfg, eval=ev, solve_time=dt, solver="mcp",
                    meta={"omega": best[0]})
