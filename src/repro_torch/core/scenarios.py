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
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
    profiles = all_paper_apps()
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
