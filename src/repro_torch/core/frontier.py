"""Pareto-frontier subsystem: the trade space behind the FIN argmin.

Port of ``repro/core/frontier.py``: host code on numpy, like the solver's
exact post-pass, with the reference's IEEE add order kept bit for bit.
Every DP end state (node, depth, slot) at every admissible exit backtracks
to a candidate configuration, and the k-best slots (``n_best > 1``) carry
the alternative placements that collide on a (node, depth) state.  This
module turns those candidates into a planning artifact:

  :class:`ParetoFrontier`  dominance-pruned (energy, latency, accuracy,
                           config) rows for one scenario, energy-sorted,
                           with the solver's canonical argmin row always
                           retained -- ``frontier.argmin`` is bit-identical
                           to what ``solve_fin`` / ``Plan.solve`` return;
  :func:`pareto_mask`      the dominance filter (see the rule below);
  :func:`eval_config_users`
                           the vectorized exact evaluator: ONE configuration
                           against MANY users that differ only in their
                           source-link bandwidth vector -- energy is one
                           shared scalar chain (Eq. 2 has no bandwidth
                           term), and each user's latency accumulates
                           through the SAME ordered IEEE-double adds as the
                           scalar ``problem.evaluate_config``;
  :func:`scan_state_users`
                           the vectorized exact post-pass: ``fin.
                           _best_feasible``'s control flow across a user
                           batch sharing one DP state, with the argmin tie
                           order preserved bit for bit;
  :func:`brute_force_frontier`
                           the enumeration oracle for small scenarios.

Dominance rule: row ``a`` dominates row ``b`` iff ``energy_a <= energy_b``,
``latency_a <= latency_b`` and ``accuracy_a >= accuracy_b`` with at least
one strict inequality; rows with identical (energy, latency, accuracy)
keep the first occurrence (generation order: exit-ascending, then
graph-energy-ascending -- the solver's scan order).  The canonical argmin
row (strictly-cheaper-wins across exits, first feasible within an exit) is
always retained even if an equal-energy row would dominate it, so
``frontier.argmin`` equals the argmin solve on every scenario.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .dnn_profile import DNNProfile
from .fin import _exit_dmin
from .problem import (AppRequirements, Config, ConfigEval,
                      config_node_loads, evaluate_config)
from .system_model import Network

__all__ = ["FrontierRow", "ParetoFrontier", "pareto_mask",
           "frontier_from_rows", "frontier_pick", "brute_force_frontier",
           "eval_config_users", "scan_state_users"]


@dataclass(frozen=True)
class FrontierRow:
    """One non-dominated deployment: exact objectives + the configuration."""

    energy: float            # exact expected J per inference (3a)
    latency: float           # exact worst-case latency, s (3b)
    accuracy: float          # a(pi) of the final exit (3c)
    config: Config

    @property
    def final_exit(self) -> int:
        return self.config.final_exit


class ParetoFrontier:
    """Dominance-pruned frontier rows of one scenario, energy-sorted.

    ``rows`` are sorted by ascending energy (stable: generation order on
    ties); ``argmin`` is the solver's canonical minimum-energy row — always
    present when any row is (even in the degenerate tie case where an
    equal-energy row dominates it), so frontier-aware callers can fall back
    to exactly the argmin solve's choice.
    """

    __slots__ = ("rows", "_argmin_idx")

    def __init__(self, rows: Sequence[FrontierRow],
                 argmin_idx: Optional[int] = None):
        self.rows: List[FrontierRow] = list(rows)
        if argmin_idx is None and self.rows:
            argmin_idx = 0
        self._argmin_idx = argmin_idx

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[FrontierRow]:
        return iter(self.rows)

    def __getitem__(self, i: int) -> FrontierRow:
        return self.rows[i]

    @property
    def argmin(self) -> Optional[FrontierRow]:
        """The canonical energy-argmin row (== the argmin solve's pick)."""
        return None if self._argmin_idx is None else self.rows[self._argmin_idx]

    @property
    def energies(self) -> np.ndarray:
        return np.array([r.energy for r in self.rows])

    @property
    def latencies(self) -> np.ndarray:
        return np.array([r.latency for r in self.rows])

    @property
    def accuracies(self) -> np.ndarray:
        return np.array([r.accuracy for r in self.rows])

    def best(self, *, profile: Optional[DNNProfile] = None,
             old_config: Optional[Config] = None,
             migration_weight: float = 0.0
             ) -> Optional[Tuple[FrontierRow, float]]:
        """Frontier-aware selection: the row minimizing
        ``energy + migration_weight * migration_bits(old_config, row)``.

        With no incumbent (or zero weight) this is exactly the argmin row.
        Returns (row, migration_bits) or None on an empty frontier.  Ties
        resolve to the earlier (cheaper-energy / solver-order) row, and the
        argmin row wins any exact tie with a costlier-energy row — so the
        selection degrades deterministically to the argmin solve.
        """
        if not self.rows:
            return None
        if old_config is None or migration_weight == 0.0 or profile is None:
            row = self.argmin
            bits = 0.0
            if old_config is not None and profile is not None:
                from .plan import migration_delta
                _, bits = migration_delta(profile, old_config, row.config)
            return row, bits
        from .plan import migration_delta
        best: Optional[Tuple[FrontierRow, float]] = None
        best_score = np.inf
        for i, row in enumerate(self.rows):
            _, bits = migration_delta(profile, old_config, row.config)
            score = row.energy + migration_weight * bits
            if score < best_score or (score == best_score
                                      and i == self._argmin_idx):
                best, best_score = (row, bits), score
        return best

    def cheapest_avoiding(self, masked: Sequence[int]
                          ) -> Optional[FrontierRow]:
        """The cheapest row whose placement touches none of the given
        (dead) nodes — the ``on_infeasible="degrade"`` fallback: when no
        placement survives a failure under the CURRENT constraints, the
        engine degrades onto the best row of the last feasible frontier
        that avoids the failed set.  Rows are energy-sorted, so the first
        surviving row is the cheapest; returns None when every row routes
        through a dead node (degrade then falls back to pausing)."""
        dead = set(int(n) for n in masked)
        for row in self.rows:
            if not dead.intersection(row.config.placement):
                return row
        return None


def frontier_pick(fr: "ParetoFrontier", prev_cfg: Optional[Config],
                  keep_ok: bool, keep_energy: float, profile: DNNProfile,
                  migration_weight: float
                  ) -> Tuple[Optional[Config], float, int, float, bool]:
    """One user's frontier-aware placement decision — THE policy core,
    shared by the churn orchestrator (both representations) and the serve
    engine's failover re-splits.

    Scores every frontier row as ``energy + migration_weight *
    migration_bits(prev_cfg, row)`` and compares the best row against
    keeping the (still-feasible) incumbent at zero migration cost; when
    migration is penalized (``migration_weight > 0``) the incumbent wins
    ties, so benign churn never migrates — at ``migration_weight == 0``
    ties go to the row instead, so the policy degrades EXACTLY to the
    argmin policy (the best row is then the canonical argmin row, whose
    energy never exceeds a feasible incumbent's).  Returns (config,
    energy, moved_blocks, moved_bits, kept) — config None when neither a
    feasible row nor a feasible incumbent exists.
    """
    from .plan import migration_delta
    best = (fr.best(profile=profile, old_config=prev_cfg,
                    migration_weight=migration_weight) if len(fr) else None)
    if best is None:
        if keep_ok:
            return prev_cfg, keep_energy, 0, 0.0, True
        return None, np.inf, 0, 0.0, False
    row, bits = best
    score = row.energy + migration_weight * bits
    if keep_ok and (keep_energy < score
                    or (migration_weight > 0 and keep_energy == score)):
        return prev_cfg, keep_energy, 0, 0.0, True
    moved = 0
    if prev_cfg is not None:
        moved, bits = migration_delta(profile, prev_cfg, row.config)
    return row.config, row.energy, moved, bits, False


def pareto_mask(energy: np.ndarray, latency: np.ndarray,
                accuracy: np.ndarray,
                always_keep: Optional[int] = None) -> np.ndarray:
    """Boolean keep-mask of the non-dominated rows (see the module rule).

    Strictly-dominated rows and later duplicates of an identical (energy,
    latency, accuracy) tuple are dropped; ``always_keep`` (the canonical
    argmin index) is retained unconditionally.
    """
    e = np.asarray(energy, dtype=np.float64)
    l = np.asarray(latency, dtype=np.float64)
    a = np.asarray(accuracy, dtype=np.float64)
    R = len(e)
    if R == 0:
        return np.zeros(0, dtype=bool)
    weak = ((e[:, None] <= e[None, :]) & (l[:, None] <= l[None, :])
            & (a[:, None] >= a[None, :]))
    strict = weak & ((e[:, None] < e[None, :]) | (l[:, None] < l[None, :])
                     | (a[:, None] > a[None, :]))
    keep = ~strict.any(axis=0)
    dup = weak & weak.T                        # identical objective tuples
    keep &= ~np.triu(dup, 1).any(axis=0)       # first occurrence wins
    if always_keep is not None:
        keep[always_keep] = True
    return keep


def frontier_from_rows(pairs: Sequence[Tuple[Config, ConfigEval]],
                       argmin_pair: Optional[Tuple[Config, ConfigEval]] = None
                       ) -> ParetoFrontier:
    """Build a :class:`ParetoFrontier` from exact-evaluated candidates.

    ``pairs`` are (config, exact eval) candidates in the solver's scan
    order (exit-ascending, graph-energy-ascending); infeasible evals and
    duplicate configurations (same exit + placement) are dropped, the
    dominance filter runs over the survivors, and ``argmin_pair`` (the
    argmin solve's selection, if any) pins the canonical argmin row.
    """
    seen = set()
    cfgs: List[Config] = []
    evs: List[ConfigEval] = []
    argmin_idx: Optional[int] = None
    amk = (None if argmin_pair is None
           else (argmin_pair[0].final_exit, tuple(argmin_pair[0].placement)))
    for cfg, ev in pairs:
        if not ev.feasible:
            continue
        key = (cfg.final_exit, tuple(cfg.placement))
        if key in seen:
            continue
        seen.add(key)
        if key == amk:
            argmin_idx = len(cfgs)
        cfgs.append(cfg)
        evs.append(ev)
    if argmin_pair is not None and argmin_idx is None and amk is not None:
        argmin_idx = len(cfgs)
        cfgs.append(argmin_pair[0])
        evs.append(argmin_pair[1])
    if not cfgs:
        return ParetoFrontier([], None)
    e = np.array([ev.energy for ev in evs])
    lat = np.array([ev.latency for ev in evs])
    acc = np.array([ev.accuracy for ev in evs])
    keep = pareto_mask(e, lat, acc, always_keep=argmin_idx)
    kept = np.nonzero(keep)[0]
    order = kept[np.argsort(e[kept], kind="stable")]
    rows = [FrontierRow(energy=float(e[i]), latency=float(lat[i]),
                        accuracy=float(acc[i]), config=cfgs[i])
            for i in order]
    out_argmin = None
    if argmin_idx is not None:
        out_argmin = int(np.nonzero(order == argmin_idx)[0][0])
    return ParetoFrontier(rows, out_argmin)


def brute_force_frontier(network: Network, profile: DNNProfile,
                         req: AppRequirements, *,
                         check_aggregate_load: bool = False
                         ) -> ParetoFrontier:
    """Enumeration oracle: ALL (placement, exit) configurations evaluated
    exactly, feasibility-filtered and dominance-pruned.  Exponential in the
    block count — property tests only."""
    import itertools
    N = network.n_nodes
    pairs: List[Tuple[Config, ConfigEval]] = []
    for k in range(profile.n_exits):
        nb = profile.exits[k].block + 1
        for place in itertools.product(range(N), repeat=nb):
            cfg = Config(placement=list(place), final_exit=k)
            ev = evaluate_config(network, profile, req, cfg,
                                 check_aggregate_load=check_aggregate_load)
            if ev.feasible:
                pairs.append((cfg, ev))
    return frontier_from_rows(pairs)


# ---------------------------------------------------------------------------
# vectorized exact evaluation (one config x many user bandwidths)
# ---------------------------------------------------------------------------

def eval_config_users(profile: DNNProfile, req: AppRequirements,
                      nodes, base_bw: np.ndarray, comp: np.ndarray,
                      src: int, config: Config, bwv: np.ndarray,
                      *, check_aggregate_load: bool = False
                      ) -> Tuple[float, float, float, np.ndarray, np.ndarray]:
    """Vectorized ``problem.evaluate_config``: one configuration, many users
    differing only in their source-link bandwidth vector.

    ``bwv`` is the (Us, N) per-user source-row bandwidth; ``base_bw`` /
    ``comp`` the cohort's shared bandwidth matrix and compute vector.
    Returns (energy, energy_comp, energy_comm, latency (Us,),
    violated (Us,)).  Energy has no bandwidth term, so it is a single
    Python-float accumulation shared by every user; the latency accumulates
    per user through the SAME ordered sequence of IEEE-double adds as the
    scalar evaluator, so every per-user (feasible, latency, energy) triple
    is bit-identical to ``evaluate_config`` on that user's mutated network.
    """
    place = config.placement
    k = config.final_exit
    last_block = profile.exits[k].block
    assert len(place) == last_block + 1
    N = len(comp)
    sigma = req.sigma
    inf = float("inf")
    Us = len(bwv)

    lat = np.zeros(Us)
    viol = np.zeros(Us, dtype=bool)
    energy_comp = 0.0
    energy_comm = 0.0

    def link(n: int, n2: int):
        if n == src:
            return bwv[:, n2]
        if n2 == src:
            return bwv[:, n]
        return float(base_bw[n, n2])

    if place[0] != src:
        b_in = link(src, place[0])
        bad = b_in <= 0
        viol |= bad
        b_eff = np.where(bad, inf, b_in)
        lat += profile.input_bits / b_eff
        energy_comm += (nodes[src].e_tx + nodes[place[0]].e_rx) \
            * profile.input_bits
        viol |= sigma * profile.input_bits > b_eff

    for i in range(last_block + 1):
        n = place[i]
        ops = profile.block_ops_with_exit(i, k)
        surv_in = profile.survival_entering_block(i, k)
        c = float(comp[n])
        if c <= 0:
            viol[:] = True
            c = inf
        t_comp = ops / c
        lat += t_comp
        energy_comp += surv_in * nodes[n].power_active * t_comp
        if sigma * surv_in * ops > c:
            viol[:] = True

        if i < last_block:
            n2 = place[i + 1]
            if n != n2:
                d = float(profile.cut_bits[i])
                surv_out = profile.survival_after_block(i, k)
                b = link(n, n2)
                if isinstance(b, float):
                    bad_s = b <= 0
                    if bad_s:
                        viol[:] = True
                        b = inf
                    lat += d / b
                    energy_comm += surv_out * (nodes[n].e_tx
                                               + nodes[n2].e_rx) * d
                    if sigma * surv_out * d > b:
                        viol[:] = True
                else:
                    bad = b <= 0
                    viol |= bad
                    b_eff = np.where(bad, inf, b)
                    lat += d / b_eff
                    energy_comm += surv_out * (nodes[n].e_tx
                                               + nodes[n2].e_rx) * d
                    viol |= sigma * surv_out * d > b_eff

    if check_aggregate_load:
        # Shared (3d+) helper: the same per-config load arithmetic as
        # problem.evaluate_config, so both call sites agree bit-for-bit
        # on boundary cases (load == slice is feasible at both).
        load = config_node_loads(profile, config, sigma, N)
        for n in range(N):
            if load[n] > float(comp[n]):
                viol[:] = True

    accuracy = profile.accuracy_of(k)
    viol |= lat > req.delta * (1 + 1e-12)
    if accuracy < req.alpha - 1e-12:
        viol[:] = True
    return energy_comp + energy_comm, energy_comp, energy_comm, lat, viol


# ---------------------------------------------------------------------------
# vectorized exact post-pass (fin._best_feasible across a user batch)
# ---------------------------------------------------------------------------

@dataclass
class StateScan:
    """Per-user result of one :func:`scan_state_users` pass.

    ``exit``/``cand`` are -1 where no feasible configuration was found;
    ``energy``/``latency``/``e_comp``/``e_comm`` are meaningful where
    found.  ``(exit, cand)`` indexes the shared candidate lists, so the
    chosen ``Config`` objects are shared, not per-user copies.
    """

    exit: np.ndarray        # (Us,) int64
    cand: np.ndarray        # (Us,) int64
    energy: np.ndarray      # (Us,) float64
    latency: np.ndarray     # (Us,) float64
    e_comp: np.ndarray      # (Us,) float64
    e_comm: np.ndarray      # (Us,) float64

    @property
    def found(self) -> np.ndarray:
        return self.exit >= 0


def scan_state_users(dp, profile: DNNProfile,
                     admissible_exits: Sequence[int],
                     candidate: Callable[[int, int],
                                         Optional[Tuple[Config, float]]],
                     eval_users: Callable[[Config, np.ndarray],
                                          Tuple[float, float, float,
                                                np.ndarray, np.ndarray]],
                     Us: int, *, dist_tol: float = 1e-9,
                     bound_energy: Optional[np.ndarray] = None) -> StateScan:
    """``fin._best_feasible`` vectorized across users sharing one DP state.

    ``candidate(k, j)`` returns the j-th energy-ordered candidate at exit
    ``k`` (the exact ``_iter_configs_at_exit`` sequence, lazily extended
    and shared across users), or None when exhausted.  ``eval_users(cfg,
    users)`` scores one candidate against a user index subset as stacked
    arrays (see :func:`eval_config_users`).  Control flow mirrors the
    scalar post-pass per user: exits scanned in order with the per-user
    exit-minimum prune (``bound_energy`` seeds the bound, e.g. the main
    quantizer pass's energies bounding the ceil rescue pass), the first
    exactly-feasible candidate wins an exit, and a strictly cheaper exit
    replaces the incumbent — so every per-user selection is bit-identical
    to ``_best_feasible`` on that user's network, while the overwhelmingly
    common case (every user feasible at the first candidate) costs ONE
    stacked evaluation per exit for the whole batch instead of one scalar
    ``evaluate_config`` per user.
    """
    best_exit = np.full(Us, -1, dtype=np.int64)
    best_cand = np.full(Us, -1, dtype=np.int64)
    best_energy = np.full(Us, np.inf)
    best_lat = np.full(Us, np.inf)
    best_comp = np.full(Us, np.inf)
    best_comm = np.full(Us, np.inf)
    have = np.zeros(Us, dtype=bool)
    bound = (np.full(Us, np.nan) if bound_energy is None
             else np.asarray(bound_energy, dtype=np.float64))
    for k in admissible_exits:
        dmin = _exit_dmin(dp, profile.exits[k].block)
        # per-user exit prune — same float comparison as the scalar path:
        # skip when the exit's cheapest graph state cannot beat the bound
        be = np.where(have, best_energy, bound)
        skip = np.isfinite(be) & (dmin > be * (1.0 + dist_tol))
        done = skip.copy()
        j = 0
        while True:
            need = np.nonzero(~done)[0]
            if not len(need):
                break
            item = candidate(k, j)
            if item is None:
                break
            cfg = item[0]
            energy, e_comp, e_comm, lat, viol = eval_users(cfg, need)
            feas = ~viol
            if feas.any():
                sel = need[feas]
                lats = lat[feas]
                upd = ~have[sel] | (energy < best_energy[sel])
                tgt = sel[upd]
                best_exit[tgt] = k
                best_cand[tgt] = j
                best_energy[tgt] = energy
                best_lat[tgt] = lats[upd]
                best_comp[tgt] = e_comp
                best_comm[tgt] = e_comm
                have[tgt] = True
                done[sel] = True
            j += 1
    return StateScan(exit=best_exit, cand=best_cand, energy=best_energy,
                     latency=best_lat, e_comp=best_comp, e_comm=best_comm)
