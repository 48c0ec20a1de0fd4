"""Plane-1 system model: multi-tiered network of compute nodes and links.

Implements Sec. II-A of the paper: a set of data sources S, a set of
computationally-capable nodes N (mobile / edge / cloud tiers), per-application
resource slices (bandwidth b^h(n, n') and compute c^h(n)), and the per-node
power/energy profile used by the energy model of Eq. (2).

Units (SI throughout):
  compute      ops / s
  bandwidth    bits / s
  power        W
  energy/bit   J / bit
  data         bits
  time         s
  energy       J
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Tier profiles
# ---------------------------------------------------------------------------

#: Paper Table V + Sec. IV node capabilities:  (TOPS, max W, idle W,
#: DL/UL traffic Gbps, DL/UL energy nJ/bit).
PAPER_TIERS: Dict[str, Dict[str, float]] = {
    "mobile": dict(tops=11.0, power_max=3.7 + 2.3, power_idle=3.1,  # 6 W compute budget
                   link_gbps=0.1, e_bit_nj=30.0),
    "edge": dict(tops=153.4, power_max=140.0, power_idle=4.0,
                 link_gbps=560.0, e_bit_nj=37.0),
    "cloud": dict(tops=312.0, power_max=400.0, power_idle=10.0,
                  link_gbps=4480.0, e_bit_nj=12.6),
}
# Note: the paper quotes [11 TOPS, 6 W], [153.4 TOPS, 140 W], [312 TOPS, 400 W]
# for the compute engines and Table V for the comm interfaces.  We use the
# compute-engine max power as the active compute power P(n) in Eq. (2).
PAPER_COMPUTE_POWER = {"mobile": 6.0, "edge": 140.0, "cloud": 400.0}

#: The reference's tier profiles for beyond-paper experiments (an "edge"
#: v5e-class accelerator, a pod slice and a full pod), copied as data: a
#: modelled node profile for ``make_network(profiles=...)``, not a
#: measurement of any card.
TPU_TIERS: Dict[str, Dict[str, float]] = {
    "edge-tpu": dict(tops=197.0e0, power_max=250.0, power_idle=60.0,
                     link_gbps=400.0, e_bit_nj=20.0),
    "pod-slice": dict(tops=197.0 * 16, power_max=250.0 * 16,
                      power_idle=60.0 * 16, link_gbps=1600.0, e_bit_nj=15.0),
    "pod": dict(tops=197.0 * 256, power_max=250.0 * 256,
                power_idle=60.0 * 256, link_gbps=6400.0, e_bit_nj=10.0),
}


@dataclass(frozen=True)
class NodeSpec:
    """A computationally-capable network node (one vertex of Plane 1)."""

    name: str
    tier: str                     # "mobile" | "edge" | "cloud" | custom
    compute_ops: float            # ops/s available on the node (before slicing)
    power_active: float           # W drawn while computing (P(n) in Eq. (2))
    power_idle: float             # W drawn while idle
    link_bps: float               # physical UL/DL capacity, bits/s
    e_tx: float                   # J/bit to transmit
    e_rx: float                   # J/bit to receive


def make_node(name: str, tier: str, *, compute_frac: float = 1.0,
              bw_frac: float = 1.0, profile: Optional[Dict[str, float]] = None,
              ) -> NodeSpec:
    """Build a NodeSpec from a named tier profile (paper Table V by default)."""
    prof = profile if profile is not None else PAPER_TIERS[tier]
    e_bit = prof["e_bit_nj"] * 1e-9
    power_active = PAPER_COMPUTE_POWER.get(tier, prof["power_max"])
    return NodeSpec(
        name=name,
        tier=tier,
        compute_ops=prof["tops"] * 1e12 * compute_frac,
        power_active=power_active,
        power_idle=prof["power_idle"],
        link_bps=prof["link_gbps"] * 1e9 * bw_frac,
        e_tx=e_bit,
        e_rx=e_bit,
    )


@dataclass
class Network:
    """Plane 1 of the two-plane graph: nodes + per-app resource slices.

    ``bandwidth[i, j]`` is the bandwidth (bits/s) of link i->j *allocated to
    the application*; ``bandwidth[i, i] = inf`` (self-loop, Sec. II-A).
    ``compute[i]`` is the compute rate (ops/s) allocated to the application.
    """

    nodes: List[NodeSpec]
    bandwidth: np.ndarray         # (N, N) bits/s, inf on diagonal
    compute: np.ndarray           # (N,) ops/s
    source_node: int = 0          # index of the node co-located with the data source

    def __post_init__(self) -> None:
        n = len(self.nodes)
        assert self.bandwidth.shape == (n, n)
        assert self.compute.shape == (n,)

    # -- convenience accessors -------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def power_active(self) -> np.ndarray:
        return np.array([nd.power_active for nd in self.nodes])

    @property
    def e_tx(self) -> np.ndarray:
        return np.array([nd.e_tx for nd in self.nodes])

    @property
    def e_rx(self) -> np.ndarray:
        return np.array([nd.e_rx for nd in self.nodes])

    def tier_of(self, idx: int) -> str:
        return self.nodes[idx].tier


def make_network(tiers: Sequence[str] = ("mobile", "edge", "cloud"),
                 *,
                 compute_frac: Optional[Sequence[float]] = None,
                 bw_frac: float = 1.0,
                 profiles: Optional[Dict[str, Dict[str, float]]] = None,
                 connectivity: Optional[Sequence[Tuple[int, int]]] = None,
                 ) -> Network:
    """Build the canonical chain-connected multi-tier network.

    By default: mobile <-> edge <-> cloud, with mobile also connected to cloud
    (via the edge's backhaul; capacity limited by the narrower link).  The link
    bandwidth i->j is ``min(link(i), link(j))``, matching the paper's setting
    where the mobile uplink is the bottleneck.
    """
    profs = profiles if profiles is not None else PAPER_TIERS
    nodes = [make_node(f"{t}{i}", t, profile=profs.get(t))
             for i, t in enumerate(tiers)]
    n = len(nodes)
    bw = np.zeros((n, n))
    pairs = connectivity
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
    for i, j in pairs:
        bw[i, j] = min(nodes[i].link_bps, nodes[j].link_bps)
    np.fill_diagonal(bw, np.inf)
    frac = np.ones(n) if compute_frac is None else np.asarray(list(compute_frac))
    compute = np.array([nd.compute_ops for nd in nodes]) * frac
    bw_off = ~np.eye(n, dtype=bool)
    bw[bw_off] *= bw_frac
    return Network(nodes=nodes, bandwidth=bw, compute=compute, source_node=0)
