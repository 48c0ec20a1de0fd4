"""Event-driven churn orchestrator over the persistent plan IR.

The paper's multi-tiered setting is dynamic: per-user uplink quality fades,
users roam between edge helpers, infrastructure nodes fail and recover, and
per-app slices get re-negotiated — all while inference is being served.
This module steps a population of :class:`repro.core.plan.Plan` objects
through such churn:

  * events (``scenarios.ChurnEvent``) apply as typed plan deltas — channel
    draws and re-associations through the BATCHED packed requantizer
    (``plan.update_uplinks``), failures/recoveries as row/col masks, slice
    changes as compute rescales;
  * *hysteresis*: a dirty user re-places only when its incumbent
    configuration became infeasible (exact (3a)-(3e) re-check against the
    updated network, dead-node aware) or its exact cost degraded past
    ``(1 + hysteresis)`` times the cost it had when last solved — small
    fades ride on the incumbent for free;
  * the users that do re-place solve as ONE grouped batched relaxation per
    tick (``solve_plans``), warm: no graph construction, cached gather
    indices, DP grids reused outright when the quantized tensors did not
    move;
  * migration accounting: every placement change is charged the moved
    blocks and their migration bits (``plan.migration_delta``);
  * *placement policy*: ``"argmin"`` (default) re-places on the energy
    argmin, the paper's FIN behaviour; ``"frontier"`` scores every row of
    the user's Pareto frontier (``core/frontier.py``) — PLUS the still-
    feasible incumbent — as ``energy + migration_weight * migration_bits``
    and deploys the cheapest, so a re-placing user can keep a slightly-
    costlier incumbent (or take a near-argmin row that reuses its current
    hosts) when the energy delta does not pay for moving the blocks' live
    state.  With ``migration_weight=0`` the frontier policy selects
    exactly the argmin row.

``hysteresis=0`` with ``always_resolve=True`` degenerates to per-tick
optimal re-planning whose configurations are bit-exact vs cold per-user
``solve_fin`` calls.

*Crash consistency*: in population mode the full serving state
checkpoints atomically (``runtime/checkpoint.py``, the reference's layout:
a checkpoint of either package restores in the other), ``resume`` replays
the tail a crash swallowed bit-identically, and ``run_arrays(fault_plan=)``
fires ``core/faults.py``'s deterministic crash points.  Cohorts on the
``mesh`` backend expose their relaxers: the straggler detector demotes
them, and the per-tick retry / demotion counts land in the report.

Port of ``repro/core/online.py``.  The orchestrator is host numpy over
the cohorts' host incumbents; the plans and cohorts it drives run their
ingest (kernel B2) and relaxations (kernel B1; B3 for plans built with
``n_best > 1``) on their own device, ``cuda:0`` unless built with
``device="cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Union)

import numpy as np

from .._device import DeviceLike
from .capacity import CongestionController, SharedCapacity
from .contingency import ContingencyPolicy, PopulationContingency
from .dnn_profile import DNNProfile, all_paper_apps
from .frontier import ParetoFrontier, frontier_pick
from .plan import Plan, migration_delta, solve_plans, update_uplinks
from .population import Population
from .multiapp import PAPER_MULTIAPP_REQS
from .problem import AppRequirements, Config
from .scenarios import (MOBILE_UPLINK_BPS, ChurnEvent, churn_trace,
                        paper_scenario)
from .system_model import Network
from ..runtime import checkpoint as ckpt
from ..runtime.straggler import StragglerDetector

__all__ = ["ChurnEvent", "churn_trace", "TickReport", "ChurnStats",
           "ChurnOrchestrator", "population_plans", "population_cohorts"]


@dataclass
class TickReport:
    """What one orchestrator tick did."""

    tick: int
    n_events: int = 0
    n_uplink_updates: int = 0
    n_quant_changed: int = 0     # uplink updates that moved a DP input
    n_dirty: int = 0             # users touched by an event
    n_resolved: int = 0          # warm re-solves issued
    n_held: int = 0              # hysteresis kept the incumbent
    n_failed: int = 0            # users with no feasible placement
    n_migrations: int = 0        # re-solves that changed the placement
    blocks_moved: int = 0
    migration_bits: float = 0.0
    energy: float = 0.0          # sum of current per-user config energies
    # shared-capacity accounting (zero/True when no shared_capacity= or
    # the congestion pass was a read-only no-op — uncoupled ticks keep
    # their exact report shape)
    congestion_iters: int = 0    # fixed-point load evaluations this tick
    congestion_converged: bool = True
    n_repriced: int = 0          # cohort reprice+re-solve passes
    n_evicted: int = 0           # admission-control evictions
    n_degraded: int = 0          # evictions resolved via a frontier row
    n_rejected: int = 0          # evictions that cleared the incumbent
    n_readmitted: int = 0        # unplaced users re-admitted on a row
    n_unplaced: int = 0          # users without an incumbent after the tick
    # contingency-library accounting (zero when contingency= is off)
    contingency_hits: int = 0    # affected states whose mask was prebuilt
    contingency_misses: int = 0  # affected states that had to relax
    contingency_prebuilt: int = 0  # states prebuilt by this tick's refill
    # fault-tolerance accounting (zero unless a TelemetryPolicy, a mesh
    # backend or a straggler detector is configured)
    n_quarantined: int = 0       # users newly quarantined this tick
    n_recovered: int = 0         # users released from quarantine
    n_mesh_retries: int = 0      # mesh collective dispatch retries
    n_mesh_demotions: int = 0    # mesh demotion-ladder rungs taken
    n_stragglers: int = 0        # workers flagged by the straggler detector
    # per-phase wall-ms breakdown (zero unless every cohort was built with
    # ``Population(..., timing=True)``; reprice is timed by the
    # orchestrator).  Streaming ticks overlap phases, so a tick's relax
    # time may partially attribute to the tick whose ingest it overlapped
    # with — sums over a run are exact either way.
    t_ingest_ms: float = 0.0     # channel ingest + requantize
    t_relax_ms: float = 0.0      # banded relaxation launches
    t_post_ms: float = 0.0       # exact post-pass
    t_reprice_ms: float = 0.0    # congestion fixed point (run_tick)
    # post-pass sub-breakdown (subsets of t_post_ms — see PopulationStats):
    # stacked candidate scans / shared fast-table broadcasts / per-user
    # fallbacks.  Attributes the fused-kernel wins per phase.
    t_post_scan_ms: float = 0.0
    t_post_fast_ms: float = 0.0
    t_post_fallback_ms: float = 0.0


@dataclass
class ChurnStats:
    """Aggregate over a churn run."""

    ticks: List[TickReport] = field(default_factory=list)

    def total(self, attr: str) -> float:
        return sum(getattr(t, attr) for t in self.ticks)

    @property
    def n_ticks(self) -> int:
        return len(self.ticks)

    @property
    def resolve_rate(self) -> float:
        """Re-solves per dirty user — what hysteresis saves."""
        dirty = self.total("n_dirty")
        return self.total("n_resolved") / dirty if dirty else 0.0


class ChurnOrchestrator:
    """Steps a user population through churn events.

    Two population representations:

    ``plans``        one :class:`Plan` per user (see
                     :func:`population_plans`) — the per-plan path;
    ``population=``  one or more struct-of-arrays :class:`Population`
                     cohorts (see :func:`population_cohorts`) — whole
                     ticks run as vectorized array programs with no
                     per-user Python on the hot path, bit-exact vs the
                     per-plan path on the float64 backends.

    All users must share a network topology; the uplink model scales each
    user's source-node links by the drawn quality — the attached edge
    helper gets the full channel, detached helpers ``detach_frac`` of it
    (mobility), the cloud path the full channel (it rides the attached
    helper's backhaul in the paper topology).
    """

    def __init__(self, plans: Optional[Sequence[Plan]] = None, *,
                 population: Union[Population, Sequence[Population],
                                   None] = None,
                 hysteresis: float = 0.05,
                 uplink_bps: float = MOBILE_UPLINK_BPS,
                 detach_frac: float = 0.25,
                 always_resolve: bool = False,
                 placement_policy: str = "argmin",
                 migration_weight: float = 0.0,
                 frontier_k: int = 4,
                 shared_capacity: Optional[SharedCapacity] = None,
                 price_weights: Optional[Sequence[float]] = None,
                 contingency: Union[bool, ContingencyPolicy, None] = None,
                 straggler: object = None,
                 stream_overlap: str = "auto"):
        if (plans is None) == (population is None):
            raise ValueError("pass exactly one of plans= or population=")
        if shared_capacity is not None and population is None:
            raise ValueError("shared_capacity= requires the population "
                             "representation (pass population=)")
        if contingency and population is None:
            raise ValueError("contingency= requires the population "
                             "representation (pass population=)")
        if price_weights is not None and shared_capacity is None:
            raise ValueError("price_weights= only applies with "
                             "shared_capacity=")
        if placement_policy not in ("argmin", "frontier"):
            raise ValueError(f"unknown placement_policy "
                             f"{placement_policy!r} (expected 'argmin' or "
                             f"'frontier')")
        if migration_weight < 0:
            raise ValueError(f"migration_weight must be >= 0, got "
                             f"{migration_weight}")
        if frontier_k < 1:
            raise ValueError(f"frontier_k must be >= 1, got {frontier_k}")
        self.hysteresis = hysteresis
        self.uplink_bps = uplink_bps
        self.detach_frac = detach_frac
        self.always_resolve = always_resolve
        self.placement_policy = placement_policy
        self.migration_weight = float(migration_weight)
        self.frontier_k = int(frontier_k)
        self._tick = 0
        self.plans: Optional[List[Plan]] = None
        self.pops: Optional[List[Population]] = None
        self.congestion: Optional[CongestionController] = None
        #: per-cohort prebuilt-failover libraries (core/contingency.py);
        #: ``contingency=True`` uses the default policy, or pass a
        #: ContingencyPolicy to pick the covered masks
        self._contingency_policy: Optional[ContingencyPolicy] = (
            contingency if isinstance(contingency, ContingencyPolicy)
            else ContingencyPolicy() if contingency else None)
        self.contingency_libs: Optional[List[PopulationContingency]] = None
        #: straggler mitigation (runtime/straggler.py): ``True`` builds a
        #: default StragglerDetector on first use, or pass a configured
        #: detector.  Each tick's per-worker relax times feed ``update``;
        #: flagged workers demote every cohort's mesh relaxer one rung
        #: (symmetric across hosts — all hosts see the same gathered
        #: times, so they shrink together).  Times come from
        #: ``TickReport.t_relax_ms`` (requires ``Population(timing=True)``)
        #: unless :attr:`straggler_times` injects a provider.
        self._straggler_cfg = straggler
        self._straggler_det = None
        if stream_overlap not in ("auto", "always", "never"):
            raise ValueError(f"stream_overlap must be 'auto', 'always' or "
                             f"'never', got {stream_overlap!r}")
        #: streaming-overlap policy: ``"auto"`` overlaps tick t's ingest
        #: with tick t-1's relax only when it can pay off — more than one
        #: core to run the background relax on AND the relax EWMA is above
        #: the thread-handoff cost.  Reports are bit-identical either way
        #: (overlap only moves WHEN the relax runs, never what it computes).
        self.stream_overlap = stream_overlap
        self._overlap_relax_s = 0.0   # EWMA of per-tick relax wall time
        self._overlap_used = False    # what the last begin decided
        self._n_cores: Optional[int] = None
        #: injectable per-tick worker step-time provider (tests, external
        #: schedulers): a callable ``TickReport -> (H,) times``
        self.straggler_times: Optional[Callable] = None
        if population is not None:
            self._init_population(population)
            if shared_capacity is not None:
                self.congestion = CongestionController(
                    shared_capacity, self.pops, weights=price_weights,
                    frontier_k=self.frontier_k)
            return
        self.plans = list(plans)
        U = len(self.plans)
        self.quality = np.ones(U)
        nw = self.plans[0].network
        self._edge_nodes = [n for n, spec in enumerate(nw.nodes)
                            if spec.tier == "edge"
                            and n != nw.source_node]
        self.attached = np.zeros(U, dtype=np.int64)   # edge-slot per user
        self._att_ver = 0
        self._fac_ver = -1
        self._ref_energy = np.full(U, np.inf)          # energy at last solve
        self._cur_energy = np.full(U, np.inf)
        # cold-start placement for plans that were not solved yet
        fresh = [p for p in self.plans if p.solution is None]
        if fresh:
            solve_plans(fresh)
        for u, p in enumerate(self.plans):
            if p.solution is not None and p.solution.feasible:
                self._ref_energy[u] = p.solution.energy
                self._cur_energy[u] = p.solution.energy

    def _init_population(self, population) -> None:
        pops = ([population] if isinstance(population, Population)
                else list(population))
        if not pops:
            raise ValueError("population= needs at least one cohort")
        self.pops = pops
        U = sum(p.U for p in pops)
        self.n_users = U
        nw = pops[0].network0
        for p in pops:
            if p.network0.n_nodes != nw.n_nodes \
                    or p.network0.source_node != nw.source_node:
                raise ValueError("population cohorts must share a network "
                                 "topology")
        # cohort user ids must partition 0..U-1 (round-robin interleave
        # from population_cohorts, or any caller-chosen split)
        self._pop_of = np.full(U, -1, dtype=np.int64)
        self._local_of = np.full(U, -1, dtype=np.int64)
        for pi, p in enumerate(pops):
            gids = p.user_ids
            if (gids < 0).any() or (gids >= U).any() \
                    or (self._pop_of[gids] >= 0).any():
                raise ValueError("cohort user_ids must partition the "
                                 "global user index range without overlap")
            self._pop_of[gids] = pi
            self._local_of[gids] = np.arange(p.U)
        assert (self._pop_of >= 0).all()
        #: cached per-cohort local index ranges (dense ticks touch every
        #: user, so the per-tick pop_of scans collapse to these)
        self._loc_all = [np.arange(p.U, dtype=np.int64) for p in pops]
        #: per-cohort global-id slices: ``population_cohorts`` deals users
        #: round-robin, so a cohort's user_ids is an arithmetic progression
        #: and the dense tick's (U,) ledger gathers become strided VIEWS —
        #: zero-copy reads and writes on the hot gate path (values
        #: identical; fancy-index fallback when a caller hand-rolled ids)
        self._gl_sl: List[Optional[slice]] = []
        for p in pops:
            gids = p.user_ids
            sl: Optional[slice] = None
            if len(gids) == 1:
                sl = slice(int(gids[0]), int(gids[0]) + 1)
            elif len(gids) >= 2:
                st = int(gids[1]) - int(gids[0])
                if st > 0 and (np.diff(gids) == st).all():
                    sl = slice(int(gids[0]), int(gids[-1]) + 1, st)
            self._gl_sl.append(sl)
        #: per-cohort uplink factor matrices for the fused dense ingest
        #: (lazily built; rows self-heal against attachment moves)
        self._fac: Optional[List[np.ndarray]] = None
        self._fac_attached: Optional[np.ndarray] = None
        self._edge_nodes = [n for n, spec in enumerate(nw.nodes)
                            if spec.tier == "edge"
                            and n != nw.source_node]
        self.quality = np.ones(U)
        self.attached = np.zeros(U, dtype=np.int64)
        self._att_ver = 0           # bumped on every attachment write
        self._fac_ver = -1          # _att_ver the factor cache reflects
        self._ref_energy = np.full(U, np.inf)
        self._cur_energy = np.full(U, np.inf)
        #: running (retries, demotions) cursor for the per-tick mesh deltas
        self._mesh_cursor = (0, 0)
        for p in pops:
            fresh = np.nonzero(~p._solved)[0]
            if len(fresh):
                p.solve(fresh, build_solutions=False)
            found = p.inc_found
            gl = p.user_ids[found]
            self._ref_energy[gl] = p._inc_energy[found]
            self._cur_energy[gl] = p._inc_energy[found]
        if self._contingency_policy is not None:
            self.contingency_libs = [
                PopulationContingency(p, policy=self._contingency_policy)
                for p in pops]
            for lib in self.contingency_libs:
                lib.refill()

    # ------------------------------------------------------------------ API
    def run(self, trace: Iterable[Sequence[ChurnEvent]]) -> ChurnStats:
        stats = ChurnStats()
        for events in trace:
            stats.ticks.append(self.step(events))
        return stats

    def step(self, events: Sequence[ChurnEvent]) -> TickReport:
        if self.pops is not None:
            return self._step_population(events)
        rep = TickReport(tick=self._tick, n_events=len(events))
        self._tick += 1
        U = len(self.plans)

        uplink_users: set = set()
        dirty = set()
        for ev in events:
            if ev.kind == "uplink":
                if ev.user is None:
                    raise ValueError("uplink events are per-user "
                                     "(ChurnEvent.user must be an int)")
                self.quality[ev.user] = ev.value
                uplink_users.add(ev.user)
                dirty.add(ev.user)
            elif ev.kind == "attach":
                if ev.user is None:
                    raise ValueError("attach events are per-user "
                                     "(ChurnEvent.user must be an int)")
                slot = int(ev.value) % max(1, len(self._edge_nodes))
                if self.attached[ev.user] != slot:
                    self.attached[ev.user] = slot
                    self._att_ver += 1
                    uplink_users.add(ev.user)
                    dirty.add(ev.user)
            elif ev.kind in ("fail", "recover"):
                targets = range(U) if ev.user is None else [ev.user]
                for u in targets:
                    if ev.kind == "fail":
                        self.plans[u].mask_node(int(ev.value))
                    else:
                        self.plans[u].unmask_node(int(ev.value))
                    dirty.add(u)
            elif ev.kind == "slice":
                targets = range(U) if ev.user is None else [ev.user]
                for u in targets:
                    self.plans[u].update_slice(ev.value)
                    dirty.add(u)
            else:
                raise ValueError(f"unknown churn event kind {ev.kind!r}")

        # channel + mobility funnel through one batched packed requantize
        if uplink_users:
            uplink_users = sorted(uplink_users)
            vecs = np.stack([self._uplink_vector(u) for u in uplink_users])
            changed = update_uplinks([self.plans[u] for u in uplink_users],
                                     vecs)
            rep.n_uplink_updates = len(uplink_users)
            rep.n_quant_changed = int(np.count_nonzero(changed))

        # hysteresis gate: exact incumbent re-check against the new state
        rep.n_dirty = len(dirty)
        resolve: List[int] = []
        for u in sorted(dirty):
            p = self.plans[u]
            inc = p.solution
            if inc is None or not inc.found:
                resolve.append(u)
                continue
            ev_ = p.evaluate(inc.config)
            if (self.always_resolve or not ev_.feasible
                    or ev_.energy > self._ref_energy[u]
                    * (1.0 + self.hysteresis)):
                resolve.append(u)
            else:
                rep.n_held += 1
                self._cur_energy[u] = ev_.energy

        # batched warm re-solve of the users that actually re-place
        if resolve:
            old = [self.plans[u].solution for u in resolve]
            sols = solve_plans([self.plans[u] for u in resolve])
            rep.n_resolved = len(resolve)
            frontier_mode = self.placement_policy == "frontier"
            for u, prev, sol in zip(resolve, old, sols):
                p = self.plans[u]
                prev_cfg = (prev.config if prev is not None and prev.found
                            else None)
                if frontier_mode:
                    fr = p.frontier(k_per_exit=self.frontier_k)
                    if prev_cfg is not None:
                        ev_prev = p.evaluate(prev_cfg)
                        keep_ok, keep_e = ev_prev.feasible, ev_prev.energy
                    else:
                        ev_prev, keep_ok, keep_e = None, False, np.inf
                    cfg, energy, moved, bits, kept = self._frontier_pick(
                        fr, prev_cfg, keep_ok, keep_e, p.profile)
                    if cfg is None:
                        rep.n_failed += 1
                        self._cur_energy[u] = np.inf
                        self._ref_energy[u] = np.inf
                        continue
                    if kept:
                        p.adopt(prev_cfg, ev_prev)
                    elif (not sol.feasible
                          or cfg.placement != sol.config.placement
                          or cfg.final_exit != sol.config.final_exit):
                        p.adopt(cfg)       # a non-argmin frontier row
                    self._ref_energy[u] = energy
                    self._cur_energy[u] = energy
                    if moved:
                        rep.n_migrations += 1
                        rep.blocks_moved += moved
                        rep.migration_bits += bits
                    continue
                if not sol.feasible:
                    rep.n_failed += 1
                    self._cur_energy[u] = np.inf
                    self._ref_energy[u] = np.inf
                    continue
                self._ref_energy[u] = sol.energy
                self._cur_energy[u] = sol.energy
                moved, bits = migration_delta(self.plans[u].profile,
                                              prev_cfg, sol.config)
                if moved:
                    rep.n_migrations += 1
                    rep.blocks_moved += moved
                    rep.migration_bits += bits

        fin = np.isfinite(self._cur_energy)
        rep.energy = float(self._cur_energy[fin].sum())
        return rep

    # ------------------------------------------------- population-mode ticks
    def _step_population(self, events: Sequence[ChurnEvent]) -> TickReport:
        """Event-form tick over the struct-of-arrays cohorts: same event
        semantics and bit-exact same decisions as the per-plan path, with
        the funnel / gate / re-solve running as array programs."""
        rep = TickReport(tick=self._tick, n_events=len(events))
        self._tick += 1
        U = self.n_users
        uplink_mask = np.zeros(U, dtype=bool)
        dirty_mask = np.zeros(U, dtype=bool)
        topo_event = False
        for ev in events:
            if ev.kind == "uplink":
                if ev.user is None:
                    raise ValueError("uplink events are per-user "
                                     "(ChurnEvent.user must be an int)")
                self.quality[ev.user] = ev.value
                uplink_mask[ev.user] = True
                dirty_mask[ev.user] = True
            elif ev.kind == "attach":
                if ev.user is None:
                    raise ValueError("attach events are per-user "
                                     "(ChurnEvent.user must be an int)")
                slot = int(ev.value) % max(1, len(self._edge_nodes))
                if self.attached[ev.user] != slot:
                    self.attached[ev.user] = slot
                    self._att_ver += 1
                    uplink_mask[ev.user] = True
                    dirty_mask[ev.user] = True
            elif ev.kind in ("fail", "recover"):
                node = int(ev.value)
                topo_event = True
                # library-coverage probe BEFORE the mask lands: does the
                # flipped (pack, mask) signature already exist relaxed?
                # (event-time view — optimistic when a fade re-keys the
                # user in this same tick; the failover bench reports the
                # tick's actual relaxation count as ground truth)
                if ev.user is None:
                    if self.contingency_libs is not None:
                        for lib in self.contingency_libs:
                            h, m = lib.coverage(node, ev.kind)
                            rep.contingency_hits += h
                            rep.contingency_misses += m
                    for p in self.pops:
                        (p.mask_node(node) if ev.kind == "fail"
                         else p.unmask_node(node))
                    dirty_mask[:] = True
                else:
                    pi = int(self._pop_of[ev.user])
                    loc = [int(self._local_of[ev.user])]
                    if self.contingency_libs is not None:
                        h, m = self.contingency_libs[pi].coverage(
                            node, ev.kind, users=loc)
                        rep.contingency_hits += h
                        rep.contingency_misses += m
                    p = self.pops[pi]
                    (p.mask_node(node, users=loc) if ev.kind == "fail"
                     else p.unmask_node(node, users=loc))
                    dirty_mask[ev.user] = True
            elif ev.kind == "slice":
                if ev.user is not None:
                    raise ValueError(
                        "per-user slice events are not supported in "
                        "population mode (compute slices are cohort-shared "
                        "state); model per-user slices as separate cohorts")
                if self.congestion is not None:
                    # compose with the congestion prices — a raw
                    # update_slice writes the slice fraction absolutely
                    # and would clobber the applied price factors (and
                    # the next reprice would clobber the renegotiation)
                    self.congestion.renegotiate_slice(ev.value)
                else:
                    for p in self.pops:
                        p.update_slice(ev.value)
                dirty_mask[:] = True
                topo_event = True       # slice churn clears the state table
            else:
                raise ValueError(f"unknown churn event kind {ev.kind!r}")
        self._population_tick(rep, uplink_mask, dirty_mask)
        # background refill: after a topology change (masks moved / state
        # table cleared), a quant re-key (new packs need new contingency
        # states) or a congestion reprice (backhaul rescale cleared the
        # table), rebuild coverage around the new cohort states so the
        # NEXT failure tick is relaxation-free again — off that tick's
        # critical path, counted in PopulationStats.prebuilt_states
        if (self.contingency_libs is not None
                and self._contingency_policy.auto_refill
                and (topo_event or rep.n_quant_changed or rep.n_repriced)):
            for lib in self.contingency_libs:
                rep.contingency_prebuilt += lib.refill()
        return rep

    def step_arrays(self, quality: Optional[np.ndarray] = None,
                    attach: Optional[np.ndarray] = None) -> TickReport:
        """Array-form tick (population mode only) — the million-user path.

        ``quality`` is a (U,) per-user channel draw (every user dirty, like
        a trace tick's one-uplink-event-per-user), ``attach`` an optional
        (U,) edge-slot vector.  Skips materializing U ``ChurnEvent``
        objects per tick, and ingests lazily: requantization is deferred
        to the users that actually re-solve (hysteresis holds most), so
        ``n_quant_changed`` is not tracked here (reported 0) — every
        decision, energy and solution is still bit-identical to
        :meth:`step` with the equivalent per-user uplink events.
        """
        if self.pops is None:
            raise ValueError("step_arrays requires population mode")
        U = self.n_users
        rep = TickReport(tick=self._tick, n_events=0)
        self._tick += 1
        uplink_mask = np.zeros(U, dtype=bool)
        dirty_mask = np.zeros(U, dtype=bool)
        if quality is not None:
            quality = np.asarray(quality, dtype=np.float64)
            if quality.shape != (U,):
                raise ValueError(f"quality must be shape ({U},), got "
                                 f"{quality.shape}")
            self.quality[:] = quality
            uplink_mask[:] = True
            dirty_mask[:] = True
            rep.n_events += U
        if attach is not None:
            attach = np.asarray(attach, dtype=np.int64)
            if attach.shape != (U,):
                raise ValueError(f"attach must be shape ({U},), got "
                                 f"{attach.shape}")
            slots = attach % max(1, len(self._edge_nodes))
            moved = slots != self.attached
            if moved.any():
                self.attached[moved] = slots[moved]
                self._att_ver += 1
            uplink_mask |= moved
            dirty_mask |= moved
            rep.n_events += int(moved.sum())
        self._population_tick(rep, uplink_mask, dirty_mask, requant=False)
        return rep

    def _population_tick(self, rep: TickReport, uplink_mask: np.ndarray,
                         dirty_mask: np.ndarray,
                         requant: bool = True) -> None:
        snap = self._timing_snapshot()
        q0 = self._quar_counters()
        # channel + mobility funnel: one vectorized ingest per cohort.
        # Dense ticks (every user dirty — the step_arrays common case)
        # skip the per-cohort membership scans and the (U, N) staging
        # vector: the cached per-cohort factor matrix turns the whole
        # ingest into one fused scale-times-factors multiply per cohort,
        # bit-identical per row to _uplink_vectors (same operand order).
        dense = bool(uplink_mask.all())
        if dense:
            fac = self._factors()
            changed_total = 0
            for pi, p in enumerate(self.pops):
                scale = self.uplink_bps * self.quality[p.user_ids]
                changed = p.ingest_factors(scale, fac[pi], requant=requant)
                if changed is not None:
                    changed_total += int(np.count_nonzero(changed))
            rep.n_uplink_updates = self.n_users
            rep.n_quant_changed = changed_total
        else:
            up_idx = np.nonzero(uplink_mask)[0]
            if len(up_idx):
                vecs = self._uplink_vectors(up_idx)
                changed_total = 0
                for pi, p in enumerate(self.pops):
                    pos = np.nonzero(self._pop_of[up_idx] == pi)[0]
                    if not len(pos):
                        continue
                    loc = self._local_of[up_idx[pos]]
                    changed = p.ingest(vecs[pos], users=loc,
                                       requant=requant)
                    if changed is not None:
                        changed_total += int(np.count_nonzero(changed))
                rep.n_uplink_updates = len(up_idx)
                rep.n_quant_changed = changed_total
        q1 = self._quar_counters()
        rep.n_quarantined = q1[0] - q0[0]
        rep.n_recovered = q1[1] - q0[1]

        # hysteresis gate: vectorized exact incumbent re-check
        all_dirty = dense and bool(dirty_mask.all())
        dirty_idx = np.nonzero(dirty_mask)[0] if not all_dirty else None
        rep.n_dirty = (self.n_users if all_dirty else len(dirty_idx))
        moved_bits = np.zeros(self.n_users)
        migrated = np.zeros(self.n_users, dtype=bool)
        for pi, p in enumerate(self.pops):
            if all_dirty:
                gl = p.user_ids
                loc = self._loc_all[pi]
            else:
                pos = np.nonzero(self._pop_of[dirty_idx] == pi)[0]
                if not len(pos):
                    continue
                gl = dirty_idx[pos]
                loc = self._local_of[gl]
            if self.always_resolve:
                # every dirty user re-solves; skip the (unused) incumbent
                # evaluation — identical decisions, energies overwritten
                res = np.ones(len(gl), dtype=bool)
                n_res = len(gl)
            else:
                no_inc, feas, energy = p.evaluate_incumbents(
                    None if all_dirty else loc)
                thresh = self._ref_energy[gl] * (1.0 + self.hysteresis)
                res = no_inc | ~feas | (energy > thresh)
                n_res = int(np.count_nonzero(res))
                rep.n_held += len(gl) - n_res
                if n_res == 0:
                    # everyone held: one aligned store, no boolean gathers
                    self._cur_energy[gl] = energy
                    continue
                held = ~res
                if held.any():
                    self._cur_energy[gl[held]] = energy[held]
            if n_res == 0:
                continue

            # batched warm re-solve of this cohort's re-placing users
            gl_res = gl[res]
            loc_res = loc[res]
            old_found = p.inc_found[loc_res].copy()
            old_place = p._inc_place[loc_res].copy()
            if self.placement_policy == "frontier":
                self._frontier_resolve(rep, p, gl_res, loc_res, old_found,
                                       old_place, migrated, moved_bits)
                continue
            p.solve(loc_res, build_solutions=False)
            rep.n_resolved += len(loc_res)
            self._account_resolves(rep, p, gl_res, loc_res, old_found,
                                   old_place, migrated, moved_bits)
        # per-plan parity: migration bits accumulate per user in global
        # index order (float addition order matters)
        mb = 0.0
        for u in np.nonzero(migrated)[0]:
            mb += float(moved_bits[u])
        rep.migration_bits = mb

        # shared-capacity coupling: run the congestion-priced fixed point
        # over the freshly-churned incumbents, then resync the energy
        # ledger if it moved anyone (repriced re-solves, evictions and
        # re-admissions all change incumbents behind the hysteresis gate's
        # back).  A read-only pass (no overload, no prior congestion
        # state) touches nothing, keeping coupled ticks bit-exact vs the
        # uncoupled path.
        if self.congestion is not None:
            t_rp = time.perf_counter() if snap is not None else 0.0
            crep = self.congestion.run_tick()
            if snap is not None:
                rep.t_reprice_ms = (time.perf_counter() - t_rp) * 1e3
            rep.congestion_iters = crep.iterations
            rep.congestion_converged = crep.converged
            rep.n_repriced = crep.n_repriced
            rep.n_evicted = crep.n_evicted
            rep.n_degraded = crep.n_degraded
            rep.n_rejected = crep.n_rejected
            rep.n_readmitted = crep.n_readmitted
            rep.n_unplaced = len(crep.unplaced_ids)
            if crep.touched:
                # resync the spent-energy ledger for everyone (repriced
                # tensors move incumbent energies wholesale), but re-arm
                # the hysteresis baseline only for the users whose
                # incumbent actually changed — untouched users keep the
                # migration-gate reference they had before the pass
                for p in self.pops:
                    gl = p.user_ids
                    e = np.where(p.inc_found, p._inc_energy, np.inf)
                    self._cur_energy[gl] = e
                if crep.moved_gids:
                    mg = np.asarray(crep.moved_gids, dtype=np.int64)
                    self._ref_energy[mg] = self._cur_energy[mg]

        fin = np.isfinite(self._cur_energy)
        rep.energy = float(self._cur_energy[fin].sum())
        self._tick_fill(rep, snap)

    # ------------------------------------------------------- streaming ticks
    def run_arrays(self, qualities: np.ndarray,
                   attaches: Optional[np.ndarray] = None, *,
                   stream: bool = True,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: int = 0,
                   checkpoint_keep: int = 3,
                   fault_plan: object = None,
                   _trace_offset: int = 0) -> List[TickReport]:
        """Run a whole array-form churn trace (population mode only).

        ``qualities`` is (T, U) per-tick channel draws; ``attaches`` an
        optional (T, U) edge-slot matrix.  With ``stream=True`` (the
        default) ticks run as a double-buffered pipeline: tick t's
        host-side channel ingest overlaps tick t-1's in-flight relaxation
        (launched on a background thread by ``Population.solve_begin``),
        and tick t-1's post-pass reads its begin-time bandwidth snapshot --
        so every decision, energy and migration stays bit-identical to the
        synchronous :meth:`step_arrays` loop on the same draws.  On CUDA
        the background relax and the foreground ingest share the default
        stream.  Congestion coupling and the frontier policy serialize
        each tick around shared state, so those configurations (and
        ``stream=False``) take the synchronous path.

        Crash consistency: with ``checkpoint_dir`` set, the full serving
        state (:meth:`checkpoint`) is written atomically after every
        ``checkpoint_every`` completed ticks (counted in ABSOLUTE trace
        position, so a resumed run checkpoints on the same boundaries as
        the run it continues) and always after the final tick.  At a
        boundary the streaming pipeline first drains its in-flight tick
        (its relaxation results reach the host before the state is read),
        so a checkpoint never contains lookahead ingest state — a process
        killed anywhere and resumed via :meth:`resume` replays the lost
        tail bit-identically.  ``fault_plan`` (``core/faults.py``) injects
        deterministic mid-tick crashes: ``ingest`` fires before a tick's
        channel ingest, ``relax`` while its relaxation is in flight (on
        the synchronous path, together with ``ingest``), ``post`` after
        the tick fully completed; hook ticks are absolute positions too.
        """
        if self.pops is None:
            raise ValueError("run_arrays requires population mode")
        qualities = np.asarray(qualities, dtype=np.float64)
        U = self.n_users
        if qualities.ndim != 2 or qualities.shape[1] != U:
            raise ValueError(f"qualities must be (T, {U}), got "
                             f"{qualities.shape}")
        if attaches is not None:
            attaches = np.asarray(attaches, dtype=np.int64)
            if attaches.shape != qualities.shape:
                raise ValueError(
                    f"attaches must match qualities shape "
                    f"{qualities.shape}, got {attaches.shape}")
        if checkpoint_every and checkpoint_dir is None:
            raise ValueError("checkpoint_every= needs checkpoint_dir=")
        T = len(qualities)
        off = int(_trace_offset)
        every = int(checkpoint_every)
        if not stream or self.congestion is not None \
                or self.placement_policy == "frontier":
            reports = []
            for t in range(T):
                pos = off + t
                if fault_plan is not None:
                    fault_plan.crash_hook("ingest", pos)
                    fault_plan.crash_hook("relax", pos)
                rep = self.step_arrays(
                    qualities[t],
                    None if attaches is None else attaches[t])
                reports.append(rep)
                if fault_plan is not None:
                    fault_plan.crash_hook("post", pos)
                if checkpoint_dir is not None and every > 0 \
                        and (pos + 1) % every == 0 and t + 1 < T:
                    self.checkpoint(checkpoint_dir, trace_pos=pos + 1,
                                    keep=checkpoint_keep)
            if checkpoint_dir is not None and T:
                self.checkpoint(checkpoint_dir, trace_pos=off + T,
                                keep=checkpoint_keep)
            return reports
        reports: List[TickReport] = []
        prev = None          # in-flight tick: (rep, pendings, snap, pos)
        for t in range(T):
            pos = off + t
            if prev is not None and checkpoint_dir is not None \
                    and every > 0 and pos % every == 0:
                # boundary: drain the in-flight tick BEFORE this tick's
                # ingest, so the checkpoint holds exactly ticks < pos
                self._drain_tick(reports, prev, fault_plan)
                prev = None
                self.checkpoint(checkpoint_dir, trace_pos=pos,
                                keep=checkpoint_keep)
            if fault_plan is not None:
                fault_plan.crash_hook("ingest", pos)
            rep = TickReport(tick=self._tick)
            self._tick += 1
            snap = self._timing_snapshot()
            self.quality[:] = qualities[t]
            rep.n_events += U
            if attaches is not None:
                slots = attaches[t] % max(1, len(self._edge_nodes))
                moved = slots != self.attached
                n_moved = int(np.count_nonzero(moved))
                if n_moved:
                    self.attached[moved] = slots[moved]
                    self._att_ver += 1
                rep.n_events += n_moved
            # ingest(t) overlaps relax(t-1): writes only the bandwidth
            # store + stale flags, while the in-flight post-pass reads
            # its begin-time snapshot
            self._stream_ingest(rep)
            if prev is not None:
                self._drain_tick(reports, prev, fault_plan)
            prev = (rep, self._gate_and_begin(rep), snap, pos)
            if fault_plan is not None:
                fault_plan.crash_hook("relax", pos)
        if prev is not None:
            self._drain_tick(reports, prev, fault_plan)
        if checkpoint_dir is not None and T:
            self.checkpoint(checkpoint_dir, trace_pos=off + T,
                            keep=checkpoint_keep)
        return reports

    def _drain_tick(self, reports: List[TickReport], prev,
                    fault_plan) -> None:
        """Finish the pipeline's in-flight tick and fire its ``post``
        crash point."""
        rep, pendings, snap, pos = prev
        self._finish_tick(rep, pendings, snap)
        reports.append(rep)
        if fault_plan is not None:
            fault_plan.crash_hook("post", pos)

    # --------------------------------------------------- checkpoint / restore
    def checkpoint(self, ckpt_dir: str, *, trace_pos: int = 0,
                   keep: int = 3) -> str:
        """Atomically write the orchestrator's full serving state
        (population mode only) as checkpoint step ``self._tick`` under
        ``ckpt_dir`` (``runtime/checkpoint.py`` layout: temp dir + atomic
        rename, zstd when available).

        The tree covers every input the next tick reads: the orchestrator
        ledgers (quality, attachments, hysteresis baselines), each
        cohort's SoA state including the cohort-state table and pin set
        (``Population.state_dict``, host arrays), the congestion
        controller's price state and the contingency libraries'
        observed-mask counters.  ``trace_pos`` records how many trace rows
        were consumed, so :meth:`resume` knows where to continue.
        """
        if self.pops is None:
            raise ValueError("checkpointing requires population mode")
        return ckpt.save(ckpt_dir, self._tick, self._checkpoint_tree(),
                         keep=keep,
                         extra={"trace_pos": int(trace_pos),
                                "tick": int(self._tick),
                                "n_users": int(self.n_users)})

    def restore(self, ckpt_dir: str,
                step: Optional[int] = None) -> int:
        """Restore the orchestrator from ``ckpt_dir`` (newest undamaged
        checkpoint unless ``step`` pins one — damaged or partial step
        directories are skipped like ``checkpoint.restore_latest``) and
        return the saved trace position.  The orchestrator must be built
        from the same cohorts/configuration as the one that saved; the
        checkpoint may come from the reference's orchestrator."""
        if self.pops is None:
            raise ValueError("checkpointing requires population mode")
        if step is not None:
            flat, manifest = ckpt.load_arrays(ckpt_dir, step)
        else:
            flat = manifest = None
            err: Optional[Exception] = None
            for s in reversed(ckpt.available_steps(ckpt_dir)):
                try:
                    flat, manifest = ckpt.load_arrays(ckpt_dir, s)
                    break
                except Exception as e:     # damaged: fall back one step
                    err = e
            if manifest is None:
                raise FileNotFoundError(
                    f"no restorable checkpoint under {ckpt_dir!r}"
                    + (f" (last error: {err})" if err is not None else ""))
        self._restore_tree(flat, manifest)
        return int(manifest.get("extra", {}).get("trace_pos", 0))

    def resume(self, ckpt_dir: str, qualities: np.ndarray,
               attaches: Optional[np.ndarray] = None, *,
               step: Optional[int] = None, stream: bool = True,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, checkpoint_keep: int = 3,
               fault_plan: object = None) -> List[TickReport]:
        """Restore from ``ckpt_dir`` and continue the FULL original trace
        from the saved position: pass the same ``qualities``/``attaches``
        the interrupted run was given, and the returned reports are the
        bit-identical tail the crash swallowed.  With ``checkpoint_every``
        set, checkpointing continues into ``checkpoint_dir`` (default:
        ``ckpt_dir``) on the same absolute boundaries."""
        pos = self.restore(ckpt_dir, step=step)
        qualities = np.asarray(qualities, dtype=np.float64)
        if pos > len(qualities):
            raise ValueError(f"checkpoint consumed {pos} trace rows but "
                             f"the trace has only {len(qualities)}")
        if checkpoint_dir is None and checkpoint_every > 0:
            checkpoint_dir = ckpt_dir
        return self.run_arrays(
            qualities[pos:],
            None if attaches is None else attaches[pos:],
            stream=stream, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep, fault_plan=fault_plan,
            _trace_offset=pos)

    def _checkpoint_tree(self) -> Dict:
        tree: Dict[str, object] = {
            "orch": {
                "quality": self.quality.copy(),
                "attached": self.attached.copy(),
                "ref_energy": self._ref_energy.copy(),
                "cur_energy": self._cur_energy.copy(),
            },
            "pops": [p.state_dict() for p in self.pops],
        }
        if self.congestion is not None:
            tree["congestion"] = self.congestion.state_dict()
        if self.contingency_libs is not None:
            tree["contingency"] = [lib.state_dict()
                                   for lib in self.contingency_libs]
        return tree

    def _restore_tree(self, flat: Dict[str, np.ndarray],
                      manifest: Dict) -> None:
        extra = manifest.get("extra", {})
        if int(extra.get("n_users", self.n_users)) != self.n_users:
            raise ValueError(f"checkpoint holds {extra['n_users']} users, "
                             f"orchestrator has {self.n_users}")

        def sub(prefix: str) -> Dict[str, np.ndarray]:
            pre = prefix + "/"
            return {k[len(pre):]: v for k, v in flat.items()
                    if k.startswith(pre)}

        # 1) congestion prices FIRST: restore_state re-installs the
        #    crash-time slice/backhaul factors into the cohorts' proto
        #    tensors, which the cohort restores below re-relax against
        cong = sub("congestion")
        if self.congestion is not None:
            if not cong:
                raise ValueError("checkpoint has no congestion state but "
                                 "this orchestrator has shared_capacity=")
            self.congestion.restore_state(cong)
        elif cong:
            raise ValueError("checkpoint has congestion state; rebuild "
                             "the orchestrator with the original "
                             "shared_capacity= before restoring")
        # 2) per-cohort SoA state (arrays, cohort-state table, pin set)
        for pi, p in enumerate(self.pops):
            p.restore_state(sub(f"pops/{pi}"))
        # 3) orchestrator ledgers
        orch = sub("orch")
        self.quality[:] = orch["quality"]
        self.attached[:] = orch["attached"]
        self._att_ver += 1
        self._ref_energy[:] = orch["ref_energy"]
        self._cur_energy[:] = orch["cur_energy"]
        self._tick = int(extra.get("tick", manifest.get("step", 0)))
        self._fac = None            # factor cache re-derives from attached
        self._fac_attached = None
        self._mesh_cursor = (0, 0)  # fresh relaxers start at zero
        # 4) contingency observed-mask counters — the prebuilt states and
        #    the pin set themselves rode the cohort checkpoints, so the
        #    restored table serves the same hits without any refill
        if self.contingency_libs is not None:
            for li, lib in enumerate(self.contingency_libs):
                lib.restore_state(sub(f"contingency/{li}"))

    def _stream_ingest(self, rep: TickReport) -> None:
        """Dense fused ingest of the current quality/attachment state into
        every cohort (requantization deferred to the resolve gather)."""
        q0 = self._quar_counters()
        fac = self._factors()
        for pi, p in enumerate(self.pops):
            sl = self._gl_sl[pi]
            q = self.quality[p.user_ids] if sl is None else self.quality[sl]
            p.ingest_factors(self.uplink_bps * q, fac[pi], requant=False)
        rep.n_uplink_updates = self.n_users
        rep.n_dirty = self.n_users
        q1 = self._quar_counters()
        rep.n_quarantined = q1[0] - q0[0]
        rep.n_recovered = q1[1] - q0[1]

    def _gate_and_begin(self, rep: TickReport) -> list:
        """Hysteresis-gate every cohort and launch its newborn relaxation
        in flight (``solve_begin(stream=True)``); returns the per-cohort
        pending handles for :meth:`_finish_tick`."""
        pendings = []
        overlap = self._overlap_used = self._use_overlap()
        for pi, p in enumerate(self.pops):
            gl = p.user_ids
            sl = self._gl_sl[pi]
            loc = self._loc_all[pi]
            if self.always_resolve:
                gl_res, loc_res = gl, loc
            else:
                no_inc, feas, energy = p.evaluate_incumbents(None)
                ref = self._ref_energy[gl] if sl is None \
                    else self._ref_energy[sl]
                res = energy > ref * (1.0 + self.hysteresis)
                res |= ~feas
                res |= no_inc
                n_res = int(np.count_nonzero(res))
                rep.n_held += p.U - n_res
                cur = self._cur_energy if sl is None else \
                    self._cur_energy[sl]
                if n_res == 0:
                    if sl is None:
                        self._cur_energy[gl] = energy
                    else:
                        cur[:] = energy
                    pendings.append(None)
                    continue
                held = ~res
                if held.any():
                    if sl is None:
                        self._cur_energy[gl[held]] = energy[held]
                    else:
                        cur[held] = energy[held]
                gl_res = gl[res] if n_res < p.U else gl
                loc_res = loc[res] if n_res < p.U else loc
            old_found = p._inc_exit[loc_res] >= 0
            old_place = p._inc_place[loc_res].copy()
            pend = p.solve_begin(loc_res, build_solutions=False,
                                 stream=overlap)
            rep.n_resolved += len(loc_res)
            pendings.append((p, pend, gl_res, loc_res, old_found,
                             old_place))
        return pendings

    def _finish_tick(self, rep: TickReport, pendings: list, snap) -> None:
        """Join every cohort's in-flight relaxation, run the post-passes
        against their begin-time snapshots, and close the tick's
        accounting — identical arithmetic to the synchronous path."""
        moved_bits = np.zeros(self.n_users)
        migrated = np.zeros(self.n_users, dtype=bool)
        relax_s = 0.0
        for item in pendings:
            if item is None:
                continue
            p, pend, gl_res, loc_res, old_found, old_place = item
            p.solve_finish(pend)
            relax_s += p._last_relax_s
            self._account_resolves(rep, p, gl_res, loc_res, old_found,
                                   old_place, migrated, moved_bits)
        # the adaptive-overlap signal: what a background relax could hide
        self._overlap_relax_s += 0.3 * (relax_s - self._overlap_relax_s)
        mb = 0.0
        for u in np.nonzero(migrated)[0]:
            mb += float(moved_bits[u])
        rep.migration_bits = mb
        # all-finite fast path: the full contiguous sum partitions exactly
        # like the all-True gathered sum (same pairwise tree), and any
        # inf/nan poisons the total so the guard catches the mixed case
        s = float(self._cur_energy.sum())
        if np.isfinite(s):
            rep.energy = s
        else:
            fin = np.isfinite(self._cur_energy)
            rep.energy = float(self._cur_energy[fin].sum())
        self._tick_fill(rep, snap)

    def _tick_fill(self, rep: TickReport, snap) -> None:
        """Close a tick's accounting: the timing deltas, the straggler
        check (which may demote), then the mesh retry/demotion deltas
        since the LAST fill — a running cursor rather than a begin-of-tick
        snapshot, because streaming ticks overlap (tick t's ingest runs
        inside tick t-1's window) and fills happen strictly in report
        order, so cursor windows partition the counters exactly."""
        self._timing_fill(rep, snap)
        self._straggler_tick(rep)
        mr, md = self._mesh_counters()
        rep.n_mesh_retries = mr - self._mesh_cursor[0]
        rep.n_mesh_demotions = md - self._mesh_cursor[1]
        self._mesh_cursor = (mr, md)

    def _core_count(self) -> int:
        if self._n_cores is None:
            import os
            try:
                self._n_cores = len(os.sched_getaffinity(0))
            except AttributeError:          # macOS / non-Linux
                self._n_cores = os.cpu_count() or 1
        return self._n_cores

    def _use_overlap(self) -> bool:
        """The adaptive overlap rule (see ``stream_overlap``): overlap is
        pure overhead on one core (the background relax just preempts the
        foreground ingest, plus the thread handoff — the measured
        stream-slower-than-sync regression), and not worth the handoff
        when the relax EWMA is negligible (steady warm ticks relax
        nothing).  The decision never changes results, only scheduling."""
        if self.stream_overlap == "always":
            return True
        if self.stream_overlap == "never":
            return False
        if self._core_count() < 2:
            return False
        return self._overlap_relax_s >= 1e-4

    def _quar_counters(self):
        """(quarantines, recoveries) summed over the cohorts' telemetry
        screens — deltas are taken tightly around each tick's ingest, so
        the attribution is exact on both the sync and streaming paths."""
        q = r = 0
        for p in self.pops:
            if p._telemetry is not None:
                q += p.stats.quarantines
                r += p.stats.recoveries
        return (q, r)

    def _mesh_counters(self):
        mr = md = 0
        for rx in self._relaxers():
            mr += rx.retries
            md += rx.demotions
        return (mr, md)

    def _relaxers(self):
        """The cohorts' live mesh relaxers (lazily built by the mesh
        backend; empty on every other backend)."""
        return [p._mesh_relaxer for p in self.pops
                if p._mesh_relaxer is not None]

    def _straggler_tick(self, rep: TickReport) -> None:
        if not self._straggler_cfg:
            return
        if self.straggler_times is not None:
            times = np.asarray(self.straggler_times(rep), dtype=np.float64)
        else:
            if not all(p._timing for p in self.pops):
                return          # no clock to feed the detector
            times = self._gather_relax_times(rep)
        if self._straggler_det is None:
            self._straggler_det = (
                self._straggler_cfg
                if isinstance(self._straggler_cfg, StragglerDetector)
                else StragglerDetector(len(times)))
        flagged = self._straggler_det.update(times)
        rep.n_stragglers = len(flagged)
        if flagged:
            # a persistently slow worker holds every collective hostage:
            # demote the mesh one rung (all hosts see the same gathered
            # times, so the shrink is symmetric) — bit-exactness across
            # rungs is the relaxer's per-scenario shard-independence
            # contract
            for rx in self._relaxers():
                rx.demote()

    def _gather_relax_times(self, rep: TickReport) -> np.ndarray:
        """This tick's relax wall time, gathered across ranks (over the
        mesh's gloo group) when a multi-rank mesh is live, so every rank
        sees the same vector."""
        t = float(rep.t_relax_ms)
        for rx in self._relaxers():
            if rx.multihost:
                return rx.allgather(t)
        return np.asarray([t])

    _TIMING_FIELDS = ("t_ingest_ms", "t_relax_ms", "t_post_ms",
                      "t_post_scan_ms", "t_post_fast_ms",
                      "t_post_fallback_ms")

    def _timing_snapshot(self):
        """Sums of the cohorts' phase clocks, or None when any cohort has
        timing disabled (keeping the breakdown zero-cost by default)."""
        if self.pops is None or not all(p._timing for p in self.pops):
            return None
        return tuple(sum(getattr(p.stats, f) for p in self.pops)
                     for f in self._TIMING_FIELDS)

    def _timing_fill(self, rep: TickReport, snap) -> None:
        if snap is None:
            return
        for i, f in enumerate(self._TIMING_FIELDS):
            setattr(rep, f,
                    sum(getattr(p.stats, f) for p in self.pops) - snap[i])

    def _account_resolves(self, rep: TickReport, p: Population,
                          gl_res: np.ndarray, loc_res: np.ndarray,
                          old_found: np.ndarray, old_place: np.ndarray,
                          migrated: np.ndarray,
                          moved_bits: np.ndarray) -> None:
        """Post-solve bookkeeping for one cohort's resolve set: the energy
        ledgers plus migration accounting — vectorized but bit-identical
        to ``migration_delta`` per user: the -1 padding makes "block
        present in only one config" a plain element mismatch, and the bits
        accumulate column-by-column in the same order as the scalar loop
        (adding 0.0 for unmoved blocks is exact)."""
        new_found = p._inc_exit[loc_res] >= 0
        new_place = p._inc_place[loc_res]
        new_energy = p._inc_energy[loc_res]
        failed = ~new_found
        rep.n_failed += int(np.count_nonzero(failed))
        self._cur_energy[gl_res[failed]] = np.inf
        self._ref_energy[gl_res[failed]] = np.inf
        self._cur_energy[gl_res[new_found]] = new_energy[new_found]
        self._ref_energy[gl_res[new_found]] = new_energy[new_found]

        elig = new_found & old_found
        if elig.any():
            diff = old_place[elig] != new_place[elig]          # (R, L)
            L = p.L
            cut = p.profile.cut_bits
            bits = np.zeros(diff.shape[0])
            for i in range(L):
                bits += np.where(diff[:, i],
                                 float(cut[min(i, L - 1)]), 0.0)
            moved = diff.sum(axis=1)
            gl_elig = gl_res[elig]
            rep.n_migrations += int(np.count_nonzero(moved))
            rep.blocks_moved += int(moved.sum())
            migrated[gl_elig] = moved > 0
            moved_bits[gl_elig] = bits

    # -------------------------------------------------- frontier policy core
    def _frontier_pick(self, fr: ParetoFrontier,
                       prev_cfg: Optional[Config], keep_ok: bool,
                       keep_energy: float, profile: DNNProfile):
        """One user's frontier-aware placement decision — the shared
        ``frontier.frontier_pick`` core (the serve engine's failover
        re-splits run the same function)."""
        return frontier_pick(fr, prev_cfg, keep_ok, keep_energy, profile,
                             self.migration_weight)

    def _frontier_resolve(self, rep: TickReport, p: Population,
                          gl_res: np.ndarray, loc_res: np.ndarray,
                          old_found: np.ndarray, old_place: np.ndarray,
                          migrated: np.ndarray,
                          moved_bits: np.ndarray) -> None:
        """Population-mode frontier re-placement for one cohort's resolve
        set: per-user frontiers come from the shared cohort-state
        candidates (vectorized exact evaluation), the keep-option from the
        vectorized incumbent re-check, and the per-user decisions are the
        same ``_frontier_pick`` the per-plan path runs — the two
        representations make identical choices tick by tick."""
        old_exit = p._inc_exit[loc_res].copy()
        # keep-option: incumbents re-evaluated under the new channel state
        # (dead-node aware) — must precede set_incumbents
        no_inc, keep_feas, keep_energy = p.evaluate_incumbents(loc_res)
        frs = p.frontiers(loc_res, k_per_exit=self.frontier_k)
        rep.n_resolved += len(loc_res)
        cfgs: List[Optional[Config]] = []
        energies: List[float] = []
        for i, fr in enumerate(frs):
            prev_cfg = None
            if old_found[i]:
                nb = p.profile.exits[int(old_exit[i])].block + 1
                prev_cfg = Config(
                    placement=[int(x) for x in old_place[i][:nb]],
                    final_exit=int(old_exit[i]))
            keep_ok = bool(keep_feas[i]) and not bool(no_inc[i])
            cfg, energy, moved, bits, _kept = self._frontier_pick(
                fr, prev_cfg, keep_ok, float(keep_energy[i]), p.profile)
            cfgs.append(cfg)
            energies.append(energy)
            u = int(gl_res[i])
            if cfg is None:
                rep.n_failed += 1
                self._cur_energy[u] = np.inf
                self._ref_energy[u] = np.inf
                continue
            self._cur_energy[u] = energy
            self._ref_energy[u] = energy
            if moved:
                rep.n_migrations += 1
                rep.blocks_moved += moved
                migrated[u] = True
                moved_bits[u] = bits
        p.set_incumbents(loc_res, cfgs, energies)

    def _factors(self) -> List[np.ndarray]:
        """Per-cohort (p.U, N) uplink factor matrices for the fused dense
        ingest: row u holds 1.0 on the attached edge node / non-edge
        targets and ``detach_frac`` on detached edge helpers, so
        ``uplink_bps * quality[u] * factors[u]`` reproduces
        ``_uplink_vectors`` bit-for-bit (identical operand order).  Rows
        self-heal against attachment moves by diffing a snapshot of
        ``attached``, so event-form ticks interleaved with array-form
        ticks stay consistent."""
        if self._fac is None:
            self._fac = [self._fac_rows(p.user_ids) for p in self.pops]
            self._fac_attached = self.attached.copy()
            self._fac_ver = self._att_ver
            return self._fac
        if self._fac_ver == self._att_ver:
            return self._fac        # no attachment write since last build
        moved = np.nonzero(self.attached != self._fac_attached)[0]
        if len(moved):
            rows = self._fac_rows(moved)
            for pi in np.unique(self._pop_of[moved]):
                sel = self._pop_of[moved] == pi
                self._fac[int(pi)][self._local_of[moved[sel]]] = rows[sel]
            self._fac_attached[moved] = self.attached[moved]
        self._fac_ver = self._att_ver
        return self._fac

    def _fac_rows(self, gids: np.ndarray) -> np.ndarray:
        """(len(gids), N) factor rows for the given global users' current
        attachments — the per-link {1.0, detach_frac} pattern of
        ``_uplink_vectors`` without the bandwidth scale."""
        N = self.pops[0].network0.n_nodes
        rows = np.ones((len(gids), N))
        if self._edge_nodes:
            edge_mask = np.zeros(N, dtype=bool)
            edge_mask[self._edge_nodes] = True
            att = np.asarray(self._edge_nodes)[
                self.attached[gids] % len(self._edge_nodes)]
            detached = edge_mask[None, :] \
                & (np.arange(N)[None, :] != att[:, None])
            rows[detached] = self.detach_frac
        return rows

    def _uplink_vectors(self, idx: np.ndarray) -> np.ndarray:
        """Vectorized ``_uplink_vector`` over many users: (Ud, N) per-target
        source-link bandwidths, bit-identical per row."""
        nw = self.pops[0].network0
        N = nw.n_nodes
        src = nw.source_node
        q = self.quality[idx]
        full = self.uplink_bps * q                       # (Ud,)
        det = full * self.detach_frac
        vec = np.broadcast_to(full[:, None], (len(idx), N)).copy()
        if self._edge_nodes:
            edge_mask = np.zeros(N, dtype=bool)
            edge_mask[self._edge_nodes] = True
            att = np.asarray(self._edge_nodes)[
                self.attached[idx] % len(self._edge_nodes)]
            detached = edge_mask[None, :] \
                & (np.arange(N)[None, :] != att[:, None])
            vec[detached] = np.broadcast_to(det[:, None],
                                            (len(idx), N))[detached]
        vec[:, src] = np.inf
        return vec

    # ------------------------------------------------------------- internals
    def _uplink_vector(self, u: int) -> np.ndarray:
        """Per-target source-link bandwidths for user ``u``'s current
        (quality, attachment) state."""
        p = self.plans[u]
        nw = p.network
        src = nw.source_node
        q = float(self.quality[u])
        vec = np.empty(nw.n_nodes)
        att = (self._edge_nodes[int(self.attached[u])
                                % len(self._edge_nodes)]
               if self._edge_nodes else -1)
        for n, spec in enumerate(nw.nodes):
            if n == src:
                vec[n] = np.inf
            elif spec.tier == "edge" and self._edge_nodes and n != att:
                vec[n] = self.uplink_bps * q * self.detach_frac
            else:
                vec[n] = self.uplink_bps * q
        return vec


def population_plans(n_users: int, *,
                     apps: Optional[Dict[str, AppRequirements]] = None,
                     profiles: Optional[Dict[str, DNNProfile]] = None,
                     network: Optional[Network] = None,
                     n_extra_edge: int = 0, gamma: int = 10,
                     backend: str = "minplus", device: DeviceLike = None,
                     **plan_kwargs) -> List[Plan]:
    """One plan per user, apps assigned round-robin over the paper's h1-h6.

    Every plan snapshots the shared base network (``paper_scenario`` with
    ``n_extra_edge`` helpers by default) -- per-user channel state then
    lives inside each plan and is driven by the orchestrator.  The plans
    live on ``device`` (``cuda:0`` unless ``device="cpu"``).
    """
    apps = apps if apps is not None else PAPER_MULTIAPP_REQS
    profiles = profiles if profiles is not None else all_paper_apps()
    nw = network if network is not None \
        else paper_scenario(n_extra_edge=n_extra_edge)
    names = list(apps)
    plans = []
    for u in range(n_users):
        app = names[u % len(names)]
        plans.append(Plan(nw, profiles[app], apps[app], gamma=gamma,
                          backend=backend, device=device, **plan_kwargs))
    return plans


def population_cohorts(n_users: int, *,
                       apps: Optional[Dict[str, AppRequirements]] = None,
                       profiles: Optional[Dict[str, DNNProfile]] = None,
                       network: Optional[Network] = None,
                       n_extra_edge: int = 0, gamma: int = 10,
                       backend: str = "minplus", device: DeviceLike = None,
                       **pop_kwargs) -> List[Population]:
    """Struct-of-arrays analogue of :func:`population_plans`: one
    :class:`Population` cohort per app, global user ids assigned
    round-robin (user ``u`` -> app ``u % n_apps``) so a population-mode
    orchestrator walks the same user->app mapping as the per-plan path.
    The cohorts live on ``device`` (``cuda:0`` unless ``device="cpu"``).
    """
    apps = apps if apps is not None else PAPER_MULTIAPP_REQS
    profiles = profiles if profiles is not None else all_paper_apps()
    nw = network if network is not None \
        else paper_scenario(n_extra_edge=n_extra_edge)
    names = list(apps)
    pops: List[Population] = []
    for a, app in enumerate(names):
        ids = np.arange(a, n_users, len(names), dtype=np.int64)
        if not len(ids):
            continue
        pops.append(Population(nw, profiles[app], apps[app], len(ids),
                               gamma=gamma, backend=backend, user_ids=ids,
                               device=device, **pop_kwargs))
    return pops

