"""Multi-application orchestration (Sec. V, Fig. 8 scenario).

Port of ``repro/core/multiapp.py``.  Multiple applications (h1..h6) and a
growing user population share the multi-tiered system.  Resource slicing
assigns each application 0.5% of the edge and cloud computing resources;
every user brings their own mobile node (and radio link), and an
application's slice is split evenly among its users.  Per-user channel
heterogeneity is modeled as a random uplink-quality factor.

The orchestrator solves one placement per (user, app) with the selected
solver and aggregates: energy (FIN-vs-MCP gain, Fig. 8 left), tier
deployment probabilities (center-left), constraint-failure probability
(center-right), and exit-point usage (right).  The solvers run on
``device`` (``cuda:0`` unless ``device="cpu"``); the aggregation is host
code.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike, resolve_device
from .dnn_profile import DNNProfile, all_paper_apps
from .fin import solve_fin, solve_many
from .mcp import solve_mcp
from .plan import Plan, solve_plans
from .problem import AppRequirements, Solution
from .scenarios import MOBILE_SLICE_FRAC, MOBILE_UPLINK_BPS
from .system_model import Network, make_network

__all__ = ["PAPER_MULTIAPP_REQS", "EDGE_CLOUD_SLICE", "app_price_weights",
           "AppStats", "MultiAppResult", "PlanCache", "default_solvers",
           "user_network", "user_networks", "run_multiapp"]

#: Paper Sec. V requirements: [latency s, accuracy] for h1-2, h3-4, h5-6.
PAPER_MULTIAPP_REQS: Dict[str, AppRequirements] = {
    "h1": AppRequirements(alpha=0.55, delta=5e-3, sigma=1.0),
    "h2": AppRequirements(alpha=0.55, delta=5e-3, sigma=1.0),
    "h3": AppRequirements(alpha=0.55, delta=5e-3, sigma=1.0),
    "h4": AppRequirements(alpha=0.55, delta=5e-3, sigma=1.0),
    "h5": AppRequirements(alpha=0.93, delta=0.1e-3, sigma=1.0),
    "h6": AppRequirements(alpha=0.93, delta=0.1e-3, sigma=1.0),
}
EDGE_CLOUD_SLICE = 0.005  # 0.5% of edge/cloud compute per application


def app_price_weights(apps: Optional[Sequence[str]] = None, *,
                      mode: str = "uniform") -> List[float]:
    """Per-app congestion fairness weights for shared-capacity churn
    (``ChurnOrchestrator(price_weights=...)`` -- one entry per cohort, in
    ``apps`` order; see ``capacity.CongestionController``).

    ``uniform``   every app reacts to congestion prices equally (w = 1);
    ``latency``   latency-critical apps are sheltered: each app's weight
                  is its deadline divided by the loosest deadline in the
                  mix, so the tightest-deadline apps are steered off
                  contended resources last.
    """
    apps = list(PAPER_MULTIAPP_REQS) if apps is None else list(apps)
    unknown = [a for a in apps if a not in PAPER_MULTIAPP_REQS]
    if unknown:
        raise ValueError(f"unknown apps {unknown} (expected subset of "
                         f"{sorted(PAPER_MULTIAPP_REQS)})")
    if mode == "uniform":
        return [1.0] * len(apps)
    if mode == "latency":
        dmax = max(PAPER_MULTIAPP_REQS[a].delta for a in apps)
        return [PAPER_MULTIAPP_REQS[a].delta / dmax for a in apps]
    raise ValueError(f"unknown mode {mode!r} (expected 'uniform' or "
                     f"'latency')")


@dataclass
class AppStats:
    app: str
    solver: str
    n_users: int
    energy_total: float = 0.0
    energy_comp: float = 0.0
    energy_comm: float = 0.0
    failures: int = 0
    tier_blocks: Dict[str, int] = field(default_factory=dict)
    exit_usage: np.ndarray = field(default_factory=lambda: np.zeros(0))
    solve_time: float = 0.0
    solve_cache_hits: int = 0      # per-uplink-bucket solution cache reuses

    @property
    def failure_prob(self) -> float:
        return self.failures / max(1, self.n_users)

    def tier_probs(self) -> Dict[str, float]:
        tot = sum(self.tier_blocks.values())
        return {t: c / max(1, tot) for t, c in self.tier_blocks.items()}

    def exit_probs(self) -> np.ndarray:
        s = self.exit_usage.sum()
        return self.exit_usage / s if s > 0 else self.exit_usage


@dataclass
class MultiAppResult:
    stats: Dict[str, Dict[str, AppStats]]   # app -> solver -> stats

    def energy_gain(self, app: str, base: str = "mcp",
                    new: str = "fin") -> float:
        """FIN energy as a fraction of MCP energy (Fig. 8 left)."""
        b = self.stats[app][base].energy_total
        n = self.stats[app][new].energy_total
        return n / b if b > 0 else np.nan


SolverFn = Callable[[Network, DNNProfile, AppRequirements], Solution]


class PlanCache:
    """Persistent per-(app, uplink-bucket, slice) :class:`Plan` cache.

    With bucketed uplink draws, every user in a bucket sees an identical
    network, so the cache entry is the built pipeline state itself: the
    first time a bucket is seen a plan is built and solved (the new buckets
    of one call batch through ``solve_plans``); afterwards -- also across
    separate ``run_multiapp`` calls -- its incumbent is served directly.
    ``gamma`` / ``backend`` must match the FIN solver entry they shadow;
    the plans live on ``device`` (``cuda:0`` unless ``device="cpu"``).
    """

    def __init__(self, *, gamma: int = 10, backend: str = "minplus",
                 device: DeviceLike = None):
        self.gamma = gamma
        self.backend = backend
        self.device = resolve_device(device)
        self._plans: Dict[tuple, Plan] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._plans)

    def solve_users(self, app: str, profile: DNNProfile,
                    req: AppRequirements, qualities: np.ndarray,
                    per_user_slice: float) -> Tuple[List[Solution], int]:
        """Solutions for a population of bucketed uplink draws.

        Returns (per-user solutions, number of fresh solves issued)."""
        uniq = sorted(set(float(q) for q in qualities))
        fresh: List[Plan] = []
        for q in uniq:
            key = (app, q, per_user_slice)
            if key not in self._plans:
                nw = user_networks(np.array([q]), per_user_slice)[0]
                plan = Plan(nw, profile, req, gamma=self.gamma,
                            backend=self.backend, device=self.device)
                self._plans[key] = plan
                fresh.append(plan)
        if fresh:
            solve_plans(fresh)             # one batched warm relaxation
        self.misses += len(fresh)
        self.hits += len(qualities) - len(fresh)
        sols = [self._plans[(app, float(q), per_user_slice)].solution
                for q in qualities]
        return sols, len(fresh)


def default_solvers(gamma: int = 10, backend: str = "minplus", *,
                    device: DeviceLike = None) -> Dict[str, SolverFn]:
    """FIN + MCP on ``device``.  The FIN entry carries a ``solve_batch``
    attribute so the orchestrator can place a whole user population with
    one batched ``solve_many`` relaxation instead of a per-user loop."""
    dev = resolve_device(device)

    def fin(nw: Network, pf: DNNProfile, rq: AppRequirements) -> Solution:
        return solve_fin(nw, pf, rq, gamma=gamma, backend=backend,
                         device=dev)

    def fin_batch(nws: Sequence[Network], pf: DNNProfile,
                  rq: AppRequirements) -> List[Solution]:
        return solve_many(pf, nws, rq, gamma=gamma, backend=backend,
                          device=dev)

    def mcp(nw: Network, pf: DNNProfile, rq: AppRequirements) -> Solution:
        return solve_mcp(nw, pf, rq, device=dev)

    fin.solve_batch = fin_batch
    return {"fin": fin, "mcp": mcp}


def user_network(rng: np.random.Generator, per_user_slice: float,
                 *, uplink_quality: Optional[float] = None) -> Network:
    """One user's view of the system: own mobile node + sliced edge/cloud
    (the mobile device dedicates ``scenarios.MOBILE_SLICE_FRAC``)."""
    q = (float(rng.uniform(0.3, 1.0)) if uplink_quality is None
         else uplink_quality)
    return user_networks(np.array([q]), per_user_slice)[0]


def user_networks(qualities: np.ndarray, per_user_slice: float
                  ) -> List[Network]:
    """Batched ``user_network``: one vectorized build for a population.

    ``qualities`` is the (B,) array of per-user uplink-quality factors; all
    B bandwidth matrices come from one stacked (B, 3, 3) array op.  Users
    with identical quality factors share the same ``Network`` object, so
    identity-keyed caches downstream hit for free.
    """
    qualities = np.asarray(qualities, dtype=np.float64)
    base = make_network(("mobile", "edge", "cloud"),
                        compute_frac=(MOBILE_SLICE_FRAC, per_user_slice,
                                      per_user_slice))
    bw0 = base.bandwidth.copy()
    bw0[0, 1:] = MOBILE_UPLINK_BPS
    bw0[1:, 0] = MOBILE_UPLINK_BPS
    # edge/cloud backhaul sliced like compute
    bw0[1, 2] *= per_user_slice
    bw0[2, 1] *= per_user_slice
    # user's radio link quality scales every mobile<->{edge,cloud} link
    scale = np.ones((len(qualities), 3, 3))
    scale[:, 0, 1:] = qualities[:, None]
    scale[:, 1:, 0] = qualities[:, None]
    bws = bw0[None] * scale                              # (B, 3, 3)
    bws[:, np.eye(3, dtype=bool)] = np.inf
    shared: Dict[float, Network] = {}
    out: List[Network] = []
    for b, q in enumerate(qualities):
        nw = shared.get(float(q))
        if nw is None:
            nw = Network(nodes=base.nodes, bandwidth=bws[b],
                         compute=base.compute, source_node=0)
            shared[float(q)] = nw
        out.append(nw)
    return out


def run_multiapp(n_users: int,
                 *,
                 apps: Optional[Dict[str, AppRequirements]] = None,
                 profiles: Optional[Dict[str, DNNProfile]] = None,
                 solvers: Optional[Dict[str, SolverFn]] = None,
                 slice_frac: float = EDGE_CLOUD_SLICE,
                 divide_slice_by_users: bool = False,
                 uplink_buckets: Optional[int] = None,
                 plan_cache: Optional[PlanCache] = None,
                 seed: int = 0,
                 device: DeviceLike = None) -> MultiAppResult:
    """Fig. 8 experiment.  ``divide_slice_by_users=False`` follows the
    paper's constant 0.5% per-execution slice; ``True`` splits the app
    slice across its users (hard contention).

    ``uplink_buckets=K`` snaps each user's uplink-quality draw to the
    center of one of K equal buckets over [0.3, 1.0]: users in a bucket
    share one ``Network`` object, MCP solutions are served from a
    per-bucket cache (``AppStats.solve_cache_hits``) and the batched FIN
    path dedups its extended graphs per bucket.  ``plan_cache`` (with
    ``uplink_buckets``) keeps each bucket's built plan across calls.
    The default solvers run on ``device`` (``cuda:0`` unless
    ``device="cpu"``).
    """
    dev = resolve_device(device)
    apps = apps if apps is not None else PAPER_MULTIAPP_REQS
    profiles = profiles if profiles is not None else all_paper_apps()
    solvers = solvers if solvers is not None else default_solvers(device=dev)
    rng = np.random.default_rng(seed)

    stats: Dict[str, Dict[str, AppStats]] = {}
    for app, req in apps.items():
        profile = profiles[app]
        per_user = (slice_frac / max(1, n_users) if divide_slice_by_users
                    else slice_frac)
        qualities = rng.uniform(0.3, 1.0, size=n_users)
        if uplink_buckets:
            width = (1.0 - 0.3) / uplink_buckets
            idx = np.clip(((qualities - 0.3) / width).astype(np.int64),
                          0, uplink_buckets - 1)
            qualities = 0.3 + (idx + 0.5) * width
        networks = user_networks(qualities, per_user)
        stats[app] = {name: AppStats(app=app, solver=name, n_users=n_users,
                                     exit_usage=np.zeros(profile.n_exits))
                      for name in solvers}
        for name, solver in solvers.items():
            st = stats[app][name]
            batch = getattr(solver, "solve_batch", None)
            t0 = time.perf_counter()
            if batch is not None and plan_cache is not None \
                    and uplink_buckets:
                # persistent plan IR per bucket: only never-seen buckets
                # solve (batched); everything else reuses incumbents
                sols, fresh = plan_cache.solve_users(app, profile, req,
                                                     qualities, per_user)
                st.solve_cache_hits += len(networks) - fresh
            elif batch is not None:
                # one batched relaxation over the whole user population
                sols = batch(networks, profile, req)
            else:
                # per-user loop with a per-identical-network solution cache
                cache: Dict[int, Solution] = {}
                sols = []
                for nw in networks:
                    sol = cache.get(id(nw))
                    if sol is None:
                        sol = solver(nw, profile, req)
                        cache[id(nw)] = sol
                    else:
                        st.solve_cache_hits += 1
                    sols.append(sol)
            st.solve_time += time.perf_counter() - t0
            for nw, sol in zip(networks, sols):
                if not sol.feasible:
                    st.failures += 1
                    continue
                ev, cfg = sol.eval, sol.config
                st.energy_total += ev.energy
                st.energy_comp += ev.energy_comp
                st.energy_comm += ev.energy_comm
                for t, c in cfg.tier_histogram(nw).items():
                    st.tier_blocks[t] = st.tier_blocks.get(t, 0) + c
                st.exit_usage[: cfg.final_exit + 1] += \
                    profile.effective_phi(cfg.final_exit)
    return MultiAppResult(stats=stats)
