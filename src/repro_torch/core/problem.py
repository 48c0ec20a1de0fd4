"""Problem formulation (Sec. II-C): requirements, configurations, evaluation.

A *configuration* pi^h is (i) the placement of blocks 0..B(k) onto network
nodes and (ii) the final exit k (deeper blocks are suppressed).  This module
evaluates a configuration exactly — energy objective (3a), latency (3b),
accuracy (3c), per-node compute load (3d), per-link bandwidth load (3e) —
and is the single source of truth used by FIN, MCP and Opt alike.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .dnn_profile import DNNProfile
from .system_model import Network


@dataclass(frozen=True)
class AppRequirements:
    """Application-level requirements (Table I)."""

    alpha: float          # target inference quality (accuracy in [0,1])
    delta: float          # max inference latency, seconds
    sigma: float = 1.0    # inference rate, tasks/s


@dataclass
class Config:
    """A deployment configuration pi^h."""

    placement: List[int]        # node index per block, len = final block + 1
    final_exit: int             # index into profile.exits

    def tier_histogram(self, network: Network) -> dict:
        """Blocks deployed per tier name."""
        hist: dict = {}
        for p in self.placement:
            t = network.tier_of(p)
            hist[t] = hist.get(t, 0) + 1
        return hist


@dataclass
class ConfigEval:
    """Exact evaluation of a configuration."""

    energy: float               # expected J per inference (objective 3a / sigma)
    energy_comp: float
    energy_comm: float
    latency: float              # worst-case (deepest-sample) latency, s  (3b)
    accuracy: float             # a(pi)                                   (3c)
    feasible: bool
    violations: List[str] = field(default_factory=list)

    @property
    def energy_rate(self) -> float:
        """J/s at inference rate sigma (filled by evaluate_config)."""
        return self._energy_rate

    _energy_rate: float = 0.0


def config_node_loads(profile: DNNProfile, config: Config, sigma: float,
                      n_nodes: int) -> List[float]:
    """Per-node aggregate compute load (ops/s) of ONE configuration — the
    (3d+) left-hand side: every deployed block charges its host
    ``sigma * survival_entering * ops_with_exit``.

    This is the single home of the aggregate-load arithmetic; both exact
    evaluators (``evaluate_config`` and the vectorized
    ``frontier.eval_config_users``) and the shared-capacity accumulator
    (``capacity.accumulate_loads``) call it, so their sums are IEEE-double
    identical term by term (pure-Python scalar adds, placement order).
    """
    place = config.placement
    k = config.final_exit
    last_block = profile.exits[k].block
    load = [0.0] * n_nodes
    for i in range(last_block + 1):
        load[place[i]] += (sigma * profile.survival_entering_block(i, k)
                           * profile.block_ops_with_exit(i, k))
    return load


def config_link_loads(profile: DNNProfile, config: Config, src: int,
                      sigma: float) -> List[Tuple[int, int, float]]:
    """Per-link bandwidth load (bits/s) of ONE configuration — the (3e)
    left-hand sides, as ``(from_node, to_node, load)`` terms in placement
    order: the input transfer charges ``sigma * input_bits`` on the
    source -> host-of-block-0 link, and every cross-node cut ``i`` charges
    ``sigma * survival_after_block(i) * cut_bits[i]``.  Same-host cuts and
    a source-hosted block 0 produce no term, exactly like the per-link
    checks of ``evaluate_config``."""
    place = config.placement
    k = config.final_exit
    last_block = profile.exits[k].block
    loads: List[Tuple[int, int, float]] = []
    if place[0] != src:
        loads.append((src, place[0], sigma * profile.input_bits))
    for i in range(last_block):
        n, n2 = place[i], place[i + 1]
        if n != n2:
            loads.append((n, n2, sigma * profile.survival_after_block(i, k)
                          * float(profile.cut_bits[i])))
    return loads


def evaluate_config(network: Network, profile: DNNProfile,
                    req: AppRequirements, config: Config,
                    *, check_aggregate_load: bool = False) -> ConfigEval:
    """Exact evaluation of (3a)-(3e) for a configuration.

    ``check_aggregate_load=True`` additionally enforces that the *summed*
    load of all blocks mapped to a node fits its slice (stricter than the
    paper's per-edge pruning; used by the multi-app orchestrator).
    """
    place = config.placement
    k = config.final_exit
    last_block = profile.exits[k].block
    assert len(place) == last_block + 1, \
        f"placement covers blocks 0..{len(place)-1} but final exit is on {last_block}"

    # Pure-Python scalar arithmetic on the hot path: every candidate
    # configuration of every solver post-pass lands here, and per-element
    # numpy scalar ops (plus the array-building Network accessors) cost ~3x
    # the identical IEEE-double Python ops.  Values are bit-identical.
    bw = network.bandwidth.tolist()
    comp = network.compute.tolist()
    nodes = network.nodes
    src = network.source_node
    sigma = req.sigma
    inf = float("inf")

    violations: List[str] = []
    latency = 0.0
    energy_comp = 0.0
    energy_comm = 0.0

    # --- input transfer: source -> host of block 0 ---------------------------
    if place[0] != src:
        b_in = bw[src][place[0]]
        if b_in <= 0:
            violations.append(f"no link source->{place[0]}")
            b_in = inf
        latency += profile.input_bits / b_in
        energy_comm += (nodes[src].e_tx + nodes[place[0]].e_rx) \
            * profile.input_bits
        if sigma * profile.input_bits > b_in:
            violations.append("(3e) input link overloaded")

    # --- per-block compute + inter-block transfers ----------------------------
    for i in range(last_block + 1):
        n = place[i]
        ops = profile.block_ops_with_exit(i, k)
        surv_in = profile.survival_entering_block(i, k)
        c = comp[n]
        if c <= 0:
            violations.append(f"(3d) node {n} has no compute slice")
            c = inf
        t_comp = ops / c
        latency += t_comp
        energy_comp += surv_in * nodes[n].power_active * t_comp
        if sigma * surv_in * ops > c:
            violations.append(f"(3d) compute overload on node {n} block {i}")

        if i < last_block:
            n2 = place[i + 1]
            d = profile.cut_bits[i]
            surv_out = profile.survival_after_block(i, k)
            b = bw[n][n2]
            if n != n2:
                if b <= 0:
                    violations.append(f"no link {n}->{n2}")
                    b = inf
                latency += d / b
                energy_comm += surv_out * (nodes[n].e_tx + nodes[n2].e_rx) * d
                if sigma * surv_out * d > b:
                    violations.append(f"(3e) link {n}->{n2} overloaded cut {i}")

    # --- aggregate per-node load (multi-app orchestrator mode) ----------------
    if check_aggregate_load:
        load = config_node_loads(profile, config, sigma, network.n_nodes)
        for n in range(network.n_nodes):
            if load[n] > comp[n]:
                violations.append(f"(3d+) aggregate compute overload node {n}")

    accuracy = profile.accuracy_of(k)
    if latency > req.delta * (1 + 1e-12):
        violations.append(f"(3b) latency {latency:.6g} > delta {req.delta:.6g}")
    if accuracy < req.alpha - 1e-12:
        violations.append(f"(3c) accuracy {accuracy:.4f} < alpha {req.alpha:.4f}")

    ev = ConfigEval(
        energy=energy_comp + energy_comm,
        energy_comp=energy_comp,
        energy_comm=energy_comm,
        latency=latency,
        accuracy=accuracy,
        feasible=not violations,
        violations=violations,
    )
    ev._energy_rate = sigma * ev.energy
    return ev


@dataclass
class Solution:
    """Output of a solver (FIN / MCP / Opt)."""

    config: Optional[Config]
    eval: Optional[ConfigEval]
    solve_time: float           # wall-clock seconds spent solving
    solver: str
    meta: dict = field(default_factory=dict)

    @property
    def found(self) -> bool:
        return self.config is not None

    @property
    def feasible(self) -> bool:
        return self.found and self.eval is not None and self.eval.feasible

    @property
    def energy(self) -> float:
        return self.eval.energy if self.eval is not None else np.inf
