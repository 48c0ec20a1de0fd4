"""Plain reference of the paper's placement problem (Sec. II-C).

A configuration places blocks 0..B(k) on network nodes and stops at exit
k.  Its expected energy a sample (objective 3a) is the compute energy of
each block, weighted by the share of samples that still run it, plus the
energy of every cut sent between two nodes, weighted by the share that
crosses it (and the input's transfer when block 0 is off the source); its
latency (3b) is the deepest sample's; its accuracy (3c) is exit k's; each
node's slice must carry its block's load (3d) and each link its cut's
(3e).  A configuration that touches a failed node is infeasible.

``network_at`` replays churn ticks onto the base network: an uplink event
sets both directions of every source link to ``uplink_bps * q``; fail and
recover events mask and unmask nodes.  ``optimum`` is the least energy of
every feasible configuration, by enumeration.  Plain Python over the
benchmark's own copy of the scenario; nothing of the program is imported.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Sequence, Set, Tuple

INF = math.inf


@dataclass
class NetworkState:
    nodes: List[dict]
    bandwidth: List[List[float]]       # bits/s, inf on the diagonal
    compute: List[float]               # ops/s
    source: int
    failed: Set[int]


def base_network(data: dict) -> NetworkState:
    nw = data["network"]
    bw = [[INF if x is None else float(x) for x in row]
          for row in nw["bandwidth_bps"]]
    return NetworkState(nodes=nw["nodes"], bandwidth=bw,
                        compute=[float(c) for c in nw["compute_ops"]],
                        source=int(nw["source_node"]), failed=set())


def apply_tick(state: NetworkState, events: Sequence[tuple],
               uplink_bps: float) -> None:
    """Apply one tick's (kind, user, value) events in place."""
    for kind, _user, value in events:
        if kind == "uplink":
            s = state.source
            for n in range(len(state.nodes)):
                if n != s:
                    state.bandwidth[s][n] = uplink_bps * float(value)
                    state.bandwidth[n][s] = uplink_bps * float(value)
        elif kind == "fail":
            state.failed.add(int(value))
        elif kind == "recover":
            state.failed.discard(int(value))
        else:
            raise ValueError(f"unknown churn event {kind!r}")


class Profile:
    def __init__(self, data: dict):
        p = data["profile"]
        self.input_bits = float(p["input_bits"])
        self.block_ops = [float(x) for x in p["block_ops"]]
        self.cut_bits = [float(x) for x in p["cut_bits"]]
        self.exits = sorted(p["exits"], key=lambda e: e["block"])

    def phi(self, k: int) -> List[float]:
        """Exit shares when exit k is the last deployed: the shares of the
        exits beyond k fall onto k."""
        raw = [e["phi"] for e in self.exits]
        tot = sum(raw)
        phi = [x / tot for x in raw]
        out = phi[:k + 1]
        out[k] += sum(phi[k + 1:])
        return out

    def survival_after(self, block: int, k: int) -> float:
        phi = self.phi(k)
        gone = sum(phi[j] for j in range(k + 1)
                   if self.exits[j]["block"] <= block)
        return max(0.0, 1.0 - gone)

    def ops(self, block: int, k: int) -> float:
        """The block's ops, with the exit head it carries if deployed."""
        extra = sum(e["ops"] for j, e in enumerate(self.exits[:k + 1])
                    if e["block"] == block)
        return self.block_ops[block] + extra


@dataclass
class Evaluation:
    energy: float
    latency: float
    accuracy: float
    feasible: bool


def evaluate(state: NetworkState, prof: Profile, req: dict,
             placement: Sequence[int], k: int) -> Evaluation:
    last = prof.exits[k]["block"]
    if len(placement) != last + 1:
        raise ValueError(f"placement {list(placement)} does not cover "
                         f"blocks 0..{last}")
    sigma = float(req.get("sigma", 1.0))
    nodes = state.nodes
    ok = not any(n in state.failed for n in placement)
    lat = energy = 0.0
    src = state.source
    if placement[0] != src:
        b = state.bandwidth[src][placement[0]]
        ok &= b > 0 and sigma * prof.input_bits <= b
        lat += prof.input_bits / b if b > 0 else INF
        energy += (nodes[src]["e_tx"] + nodes[placement[0]]["e_rx"]) \
            * prof.input_bits
    for i in range(last + 1):
        n = placement[i]
        surv_in = 1.0 if i == 0 else prof.survival_after(i - 1, k)
        c = state.compute[n]
        ops = prof.ops(i, k)
        ok &= c > 0 and sigma * surv_in * ops <= c
        t = ops / c if c > 0 else INF
        lat += t
        energy += surv_in * nodes[n]["power_active"] * t
        if i < last and placement[i + 1] != n:
            n2 = placement[i + 1]
            b = state.bandwidth[n][n2]
            d = prof.cut_bits[i]
            surv = prof.survival_after(i, k)
            ok &= b > 0 and sigma * surv * d <= b
            lat += d / b if b > 0 else INF
            energy += surv * (nodes[n]["e_tx"] + nodes[n2]["e_rx"]) * d
    acc = float(prof.exits[k]["accuracy"])
    ok &= lat <= req["delta"] * (1 + 1e-12) and acc >= req["alpha"] - 1e-12
    return Evaluation(energy=energy if not state.failed.intersection(
        placement) else INF, latency=lat, accuracy=acc, feasible=bool(ok))


def optimum(state: NetworkState, prof: Profile, req: dict
            ) -> Tuple[float, List[int], int]:
    """(least energy, placement, final exit) over every feasible
    configuration; (inf, [], -1) when none is feasible."""
    best = (INF, [], -1)
    live = [n for n in range(len(state.nodes)) if n not in state.failed]
    for k, e in enumerate(prof.exits):
        for place in itertools.product(live, repeat=e["block"] + 1):
            ev = evaluate(state, prof, req, place, k)
            if ev.feasible and ev.energy < best[0]:
                best = (ev.energy, list(place), k)
    return best
