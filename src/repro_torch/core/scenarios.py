"""Calibrated evaluation scenarios (Sec. IV-V reference scenario).

A copy of the reference's calibration (``repro/core/scenarios.py``):

* Compute slices.  The paper's Fig. 4 reports 6.56 ms for all-blocks-on-
  mobile B-AlexNet and 39.4 mJ = 6 W x 6.56 ms, i.e. a per-application
  mobile compute slice of ~1.39e10 ops/s (0.126% of 11 TOPS); edge and cloud
  get the multi-app 0.5% slice.
* Mobile uplink.  The paper's split deployments at delta = 5 ms imply an
  effective ~1 Gb/s mobile uplink (Table V's 0.1 Gb/s with 8-bit cut
  tensors makes every B-AlexNet split infeasible); ``paper_scenario``
  defaults to 1 Gb/s and keeps everything else at Table V values.

``ChurnEvent`` / ``churn_trace`` are the reference's online-regime trace
generator, copied (numpy, seeded): the same seed gives the same events.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .dnn_profile import DNNProfile, all_paper_apps
from .problem import AppRequirements
from .system_model import Network, make_network

#: mobile per-app compute slice calibrated on Fig. 4 (see module docstring).
MOBILE_SLICE_FRAC = 1.389e10 / 11e12        # 0.1263% of 11 TOPS
EDGE_SLICE_FRAC = 0.005                     # Sec. V multi-app slice
CLOUD_SLICE_FRAC = 0.005
MOBILE_UPLINK_BPS = 1e9                     # calibrated (see docstring)


def paper_scenario(*, uplink_bps: float = MOBILE_UPLINK_BPS,
                   mobile_frac: float = MOBILE_SLICE_FRAC,
                   edge_frac: float = EDGE_SLICE_FRAC,
                   cloud_frac: float = CLOUD_SLICE_FRAC,
                   n_extra_edge: int = 0) -> Network:
    """The single-application evaluation network of Figs. 4-7.

    ``n_extra_edge > 0`` densifies the edge tier with that many additional
    edge nodes (same per-app slice)."""
    tiers = ("mobile", "edge") + ("edge",) * n_extra_edge + ("cloud",)
    fracs = (mobile_frac, edge_frac) + (edge_frac,) * n_extra_edge + (cloud_frac,)
    nw = make_network(tiers, compute_frac=fracs)
    bw = nw.bandwidth.copy()
    bw[0, 1:] = uplink_bps
    bw[1:, 0] = uplink_bps
    np.fill_diagonal(bw, np.inf)
    return Network(nodes=nw.nodes, bandwidth=bw, compute=nw.compute,
                   source_node=0)


def paper_apps() -> Dict[str, DNNProfile]:
    """The paper's six applications h1-h6 by name."""
    return all_paper_apps()


def sweep_scenarios(*, apps: Sequence[str] = ("h1", "h2", "h3", "h4", "h5",
                                              "h6"),
                    deltas_ms: Sequence[float] = (2.0, 5.0, 8.0, 12.0),
                    alphas: Optional[Sequence[float]] = None,
                    uplinks_bps: Sequence[float] = (MOBILE_UPLINK_BPS,),
                    n_extra_edge: int = 0
                    ) -> Tuple[List[DNNProfile], List[Network],
                               List[AppRequirements]]:
    """Cartesian (app x delta x alpha x uplink) scenario grid -- parallel
    lists ready for ``fin.solve_many``.

    ``alphas=None`` uses each app's always-satisfiable floor (its weakest
    exit accuracy).  Networks are shared across scenarios per uplink
    setting, which lets the batched solver dedupe the extended graphs.
    """
    profiles = paper_apps()
    nets = {u: paper_scenario(uplink_bps=u, n_extra_edge=n_extra_edge)
            for u in uplinks_bps}
    ps: List[DNNProfile] = []
    ns: List[Network] = []
    rs: List[AppRequirements] = []
    for app in apps:
        prof = profiles[app]
        app_alphas = ([min(e.accuracy for e in prof.exits)] if alphas is None
                      else alphas)
        for u in uplinks_bps:
            for alpha in app_alphas:
                for d in deltas_ms:
                    ps.append(prof)
                    ns.append(nets[u])
                    rs.append(AppRequirements(alpha=alpha, delta=d * 1e-3,
                                              sigma=1.0))
    return ps, ns, rs


# ---------------------------------------------------------------------------
# Churn traces (online regime: mobility, fading, failures)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ChurnEvent:
    """One churn event of an online trace.

    kind:
      ``uplink``   per-user channel draw; ``value`` is the quality factor in
                   [0, 1] (the orchestrator scales it by its base uplink);
      ``attach``   mobility re-association; ``value`` is the *edge slot*
                   index (0..n_edge-1) the user now attaches to — the
                   orchestrator maps slots to its network's edge nodes;
      ``fail`` / ``recover``  node failure / recovery; ``value`` is the node
                   index.  ``user=None`` means an infrastructure event that
                   applies to every user's plan;
      ``slice``    slice re-negotiation; ``value`` is the compute fraction.
    """

    kind: str
    user: Optional[int]
    value: Union[float, int]


def churn_trace(n_users: int, n_ticks: int, *, seed: int = 0,
                rho: float = 0.95, sigma: float = 0.05,
                q_mean: float = 0.65, q_lo: float = 0.3, q_hi: float = 1.0,
                p_fail: float = 0.0, p_recover: float = 0.5,
                fail_nodes: Sequence[int] = (1,),
                p_move: float = 0.0, n_edge: int = 1,
                failure_mode: str = "iid",
                tier_groups: Optional[Sequence[Sequence[int]]] = None,
                ) -> List[List[ChurnEvent]]:
    """Per-tick churn events for a user population (Sec. V online regime).

    Channel fading is a Gauss-Markov (AR(1)) process per user — quality
    q_{t+1} = q_mean + rho (q_t - q_mean) + N(0, sigma), clipped to
    [q_lo, q_hi] — the standard mobile-channel shadowing model; ``rho``
    close to 1 gives slowly varying channels whose *quantized* solver
    tensors change only when a fade crosses a quantization cell (the
    regime the incremental ``Plan`` layer exploits).  ``p_fail`` /
    ``p_recover`` drive infrastructure node failures and recoveries on
    ``fail_nodes``; ``p_move`` re-associates a user to a uniformly drawn
    edge slot (mobility across ``n_edge`` helpers).  Deterministic per
    seed; every tick emits one ``uplink`` event per user.

    ``failure_mode`` picks the outage structure:

    ``"iid"``   (default) one independent Markov chain per node of
                ``fail_nodes`` — uncorrelated single-node failures;
    ``"tier"``  one Markov chain per *group* of ``tier_groups`` (default:
                all of ``fail_nodes`` as one group) — a group fails and
                recovers jointly, emitting one event per member in the
                same tick.  This is the correlated regional-outage model
                (a rack / power-domain / backhaul-segment outage takes a
                whole tier down at once), the failure masks the
                contingency library's per-tier candidates precompute.
    """
    if failure_mode not in ("iid", "tier"):
        raise ValueError(f"failure_mode must be 'iid' or 'tier', got "
                         f"{failure_mode!r}")
    if tier_groups is not None and failure_mode != "tier":
        raise ValueError("tier_groups= only applies with "
                         "failure_mode='tier'")
    rng = np.random.default_rng(seed)
    q = np.full(n_users, q_mean)
    if failure_mode == "tier":
        groups: List[Tuple[int, ...]] = (
            [tuple(int(n) for n in fail_nodes)] if tier_groups is None
            else [tuple(int(n) for n in g) for g in tier_groups])
    else:
        groups = [(int(n),) for n in fail_nodes]
    failed: Dict[int, bool] = {g: False for g in range(len(groups))}
    trace: List[List[ChurnEvent]] = []
    for _ in range(n_ticks):
        events: List[ChurnEvent] = []
        q = np.clip(q_mean + rho * (q - q_mean)
                    + rng.normal(0.0, sigma, n_users), q_lo, q_hi)
        events.extend(ChurnEvent("uplink", u, float(q[u]))
                      for u in range(n_users))
        if p_move > 0 and n_edge > 1:
            movers = np.nonzero(rng.random(n_users) < p_move)[0]
            for u in movers:
                events.append(ChurnEvent("attach", int(u),
                                         int(rng.integers(n_edge))))
        for g, nodes in enumerate(groups):
            if failed[g]:
                if rng.random() < p_recover:
                    failed[g] = False
                    events.extend(ChurnEvent("recover", None, node)
                                  for node in nodes)
            elif p_fail > 0 and rng.random() < p_fail:
                failed[g] = True
                events.extend(ChurnEvent("fail", None, node)
                              for node in nodes)
        trace.append(events)
    return trace
