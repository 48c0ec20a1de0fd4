"""Contingency plan library: precomputed failover, O(1) at event time.

Port of ``repro/core/contingency.py`` without its population form.

:class:`ContingencyLibrary` (per :class:`~repro_torch.core.plan.Plan`)
    precomputes, for the most likely failure masks reachable from the
    plan's current state -- every single-node failure and recovery, the
    per-tier correlated masks, full recovery, and the top observed masks --
    the complete failover artifact: the solver :class:`Solution`, the
    Pareto frontier, the relaxed round-0 DP grids and the migration cost vs
    the base placement, priced at build time.  ``SplitServeEngine``'s
    ``fail_node`` / ``recover_node`` then install the entry
    (``Plan.install_solution``) with zero DP relaxations; uncovered masks
    fall back to the warm re-solve and record the miss.  Entries are keyed
    by the absolute failure mask and guarded by ``Plan.env_version``: any
    non-mask delta (channel fade, slice or backhaul churn) invalidates the
    library wholesale, because the exact post-pass reads the true
    bandwidth.  Refill happens off the failover path.

Entries are built by the very same ``mask -> solve -> frontier`` code path
a warm failover runs, and are served only while every other DP and
post-pass input is unchanged, so a hit returns the placement, energy and
frontier the warm re-solve it replaces would have produced.

:class:`NoFeasiblePlacement` is the typed graceful-degradation error: it
carries the masked node set and the last feasible frontier.

:class:`PopulationContingency` (per :class:`~repro_torch.core.population.
Population`) is the cohort form: candidate (pack, mask) signatures are
materialized as pinned cohort states through the signature-dedupe layer
(their DP inputs built on the cohort's device in one batch) and relaxed in
one chained banded relaxation (kernel B1 on the card), counted in
``PopulationStats.prebuilt_states``; a failure tick whose joint mask was
prebuilt relaxes nothing.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .frontier import ParetoFrontier
from .plan import Plan, migration_delta
from .population import Population
from .problem import Config, Solution
from .system_model import Network

__all__ = ["NoFeasiblePlacement", "ContingencyStats", "ContingencyPolicy",
           "ContingencyEntry", "ContingencyLibrary", "PopulationContingency",
           "candidate_masks", "tier_groups_of"]


class NoFeasiblePlacement(RuntimeError):
    """No feasible FIN placement survives the current failure mask.

    Subclasses ``RuntimeError`` so pre-existing ``except RuntimeError``
    failover handling keeps working; carries the masked node set and the
    last feasible Pareto frontier (if any) so callers can degrade onto a
    still-feasible row or park work until a recovery, instead of losing
    the context the engine had when the placement died.
    """

    def __init__(self, masked_nodes: Sequence[int],
                 frontier: Optional[ParetoFrontier] = None,
                 message: Optional[str] = None):
        self.masked_nodes = [int(n) for n in masked_nodes]
        self.frontier = frontier
        super().__init__(
            message or f"no feasible placement with nodes "
                       f"{self.masked_nodes} masked")


@dataclass
class ContingencyStats:
    """Library counters (diagnostics and benches)."""

    hits: int = 0            # lookups served from a precomputed entry
    misses: int = 0          # lookups that fell back to the warm solve
    stale_misses: int = 0    # misses because the environment moved (subset)
    refills: int = 0         # library rebuilds
    entries_built: int = 0   # entries (or cohort states) built across refills
    observed: int = 0        # masks recorded for the top-observed candidates

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


@dataclass(frozen=True)
class ContingencyPolicy:
    """What the library covers (shared by plan and population forms).

    ``tier_groups="auto"`` derives the correlated-failure groups from the
    network's tier labels (every non-source tier with >= 2 nodes); pass an
    explicit sequence of node-index groups to model other failure domains
    (racks, power zones), or ``()`` to disable correlated masks.
    """

    single_node: bool = True        # every single-node failure AND recovery
    tier_groups: Union[str, Sequence[Sequence[int]]] = "auto"
    top_observed: int = 4           # most-frequent observed masks to cover
    max_masks: int = 64             # hard cap on entries per refill
    auto_refill: bool = True        # orchestrator refills after topo changes


def tier_groups_of(network: Network) -> List[Tuple[int, ...]]:
    """Correlated-failure groups from the network's tier labels: the node
    indices of every non-source tier with at least two members (a
    singleton group duplicates the single-node masks)."""
    groups: Dict[str, List[int]] = {}
    for n, spec in enumerate(network.nodes):
        if n == network.source_node:
            continue
        groups.setdefault(spec.tier, []).append(n)
    return [tuple(g) for g in groups.values() if len(g) >= 2]


def candidate_masks(base_mask: np.ndarray, src: int, *,
                    single_node: bool = True,
                    tier_groups: Sequence[Sequence[int]] = (),
                    observed: Sequence[np.ndarray] = (),
                    include_base: bool = True,
                    max_masks: int = 64) -> List[np.ndarray]:
    """The failure masks a library covers, reachable from ``base_mask``.

    Generation order (the cap trims from the back, so likelier masks
    survive): the base mask itself (``include_base`` — a fail->recover
    round trip lands back on it), every single-node toggle (the next
    failure of each alive node, the recovery of each failed one), each
    tier group's joint failure and joint recovery (the correlated
    regional-outage masks), full recovery, then the observed masks.
    Masks containing the source node are unreachable (``mask_node``
    refuses them) and are dropped; duplicates keep the first occurrence.
    """
    base = np.asarray(base_mask, dtype=bool)
    N = len(base)
    out: List[np.ndarray] = []
    seen: set = set()

    def add(m: np.ndarray) -> None:
        if m[src]:
            return
        key = m.tobytes()
        if key not in seen:
            seen.add(key)
            out.append(m)

    if include_base:
        add(base.copy())
    if single_node:
        for n in range(N):
            if n == src:
                continue
            m = base.copy()
            m[n] = not m[n]
            add(m)
    for g in tier_groups:
        nodes = [int(n) for n in g]
        m = base.copy()
        m[nodes] = True
        add(m)
        m = base.copy()
        m[nodes] = False
        add(m)
    if base.any():
        add(np.zeros(N, dtype=bool))            # full recovery
    for m in observed:
        add(np.asarray(m, dtype=bool).copy())
    return out[:max_masks]


@dataclass
class ContingencyEntry:
    """One precomputed failover: everything ``fail_node`` needs, no solve.

    ``solution`` / ``frontier`` / ``dps`` are exactly what the warm
    ``mask -> solve -> frontier`` path would produce at this mask (the
    solution may be infeasible — knowing *instantly* that a mask kills
    every placement is as valuable as a placement).  ``moved`` / ``bits``
    pre-price the migration from ``base_config`` (the placement deployed
    when the entry was built) to the entry's argmin config.
    """

    masked: Tuple[int, ...]              # absolute failed-node set
    solution: Solution
    frontier: ParetoFrontier
    dps: Optional[List[object]]          # relaxed round-0 DP grids
    base_config: Optional[Config]
    moved: int = 0
    bits: float = 0.0

    @property
    def feasible(self) -> bool:
        return self.solution.feasible


class ContingencyLibrary:
    """Precomputed failover entries for one :class:`Plan`.

    ``refill()`` snapshots the plan, solves every candidate mask through
    the normal warm delta path (toggle masks -> ``solve`` -> ``frontier``),
    prices the migration vs the deployed base placement, and restores the
    plan bit-for-bit — including the incumbent/argmin solutions and the
    cached base DP grids, so a refill is invisible to the plan's users.
    ``lookup(mask)`` is a dict probe guarded by ``Plan.env_version``;
    ``observe(mask)`` feeds the top-observed candidate masks of the next
    refill.
    """

    def __init__(self, plan: Plan, *, k_per_exit: int = 4,
                 policy: Optional[ContingencyPolicy] = None):
        self.plan = plan
        self.k_per_exit = int(k_per_exit)
        self.policy = policy if policy is not None else ContingencyPolicy()
        tg = self.policy.tier_groups
        self.tier_groups: List[Tuple[int, ...]] = (
            tier_groups_of(plan.network) if tg == "auto"
            else [tuple(int(n) for n in g) for g in tg])
        self.stats = ContingencyStats()
        self._entries: Dict[bytes, ContingencyEntry] = {}
        self._observed: Counter = Counter()
        self._observed_masks: Dict[bytes, np.ndarray] = {}
        #: the plan environment the entries were built against; -1 means
        #: never refilled (everything misses until the first refill)
        self._env_version = -1

    # ------------------------------------------------------------ properties
    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def stale(self) -> bool:
        """Did a non-mask delta (channel/slice/backhaul) move the plan's
        environment since the last refill?"""
        return self._env_version != self.plan.env_version

    # ----------------------------------------------------------------- probe
    def observe(self, mask: np.ndarray) -> None:
        """Record a mask occurrence — the ``top_observed`` most frequent
        observed masks become candidates of subsequent refills."""
        m = np.asarray(mask, dtype=bool)
        key = m.tobytes()
        self._observed[key] += 1
        if key not in self._observed_masks:
            self._observed_masks[key] = m.copy()
        self.stats.observed += 1

    def lookup(self, mask: np.ndarray) -> Optional[ContingencyEntry]:
        """The entry for an absolute failure mask, or None (miss).  A hit
        is only served while the plan's environment is unchanged since the
        refill — every other DP/post-pass input equal is exactly the
        precondition under which the entry is bit-exact vs a warm solve."""
        m = np.asarray(mask, dtype=bool)
        self.observe(m)
        if self.stale:
            self.stats.misses += 1
            self.stats.stale_misses += 1
            return None
        entry = self._entries.get(m.tobytes())
        if entry is None:
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        return entry

    # ----------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """The observed-mask counters as plain arrays (insertion order —
        part of the tie-break of ``most_common``).  Entries themselves are
        NOT serialized: they are derived state, rebuilt bit-exactly by
        ``refill()`` against the restored plan."""
        keys = list(self._observed.keys())
        N = self.plan.network.n_nodes
        masks = (np.stack([self._observed_masks[k] for k in keys])
                 if keys else np.zeros((0, N), dtype=bool))
        counts = np.asarray([self._observed[k] for k in keys],
                            dtype=np.int64)
        return {"obs_masks": masks, "obs_counts": counts}

    def restore_state(self, d: dict) -> None:
        """Restore :meth:`state_dict`; call ``refill()`` afterwards to
        rebuild the entries around the restored plan state."""
        masks = np.asarray(d["obs_masks"], dtype=bool)
        counts = np.asarray(d["obs_counts"], dtype=np.int64)
        if masks.ndim != 2 or masks.shape[0] != len(counts):
            raise ValueError(f"observed-mask checkpoint shapes "
                             f"{masks.shape} / {counts.shape} disagree")
        self._observed = Counter()
        self._observed_masks = {}
        for m, c in zip(masks, counts):
            key = m.tobytes()
            self._observed[key] = int(c)
            self._observed_masks[key] = m.copy()
        self._env_version = -1     # entries are stale until the next refill

    # ---------------------------------------------------------------- refill
    @staticmethod
    def _toggle_to(plan: Plan, target: np.ndarray) -> None:
        cur = plan._masked.copy()
        for n in np.nonzero(target & ~cur)[0]:
            plan.mask_node(int(n))
        for n in np.nonzero(cur & ~target)[0]:
            plan.unmask_node(int(n))

    @staticmethod
    def _current_dps(plan: Plan) -> Optional[List[object]]:
        if (plan._dp_cache is not None
                and plan._dp_cache[0] == plan._quant_version):
            return plan._dp_cache[1]
        return None

    def refill(self, base_config: Optional[Config] = None, *,
               extra_masks: Sequence[np.ndarray] = ()) -> int:
        """Rebuild every entry around the plan's CURRENT (mask, channel)
        state.  ``base_config`` is the currently deployed placement the
        migration costs are priced against (defaults to the plan's
        incumbent).  ``extra_masks`` adds operator-supplied absolute
        failure masks to the candidates ahead of the observed ones (a
        maintenance window, a forecast outage); they count against
        ``max_masks`` like any candidate.  Returns the number of entries
        built.

        This is the background half of the protocol: the engine runs it
        off the failover critical path (deferred to the next serving step
        or orchestrator tick), so a hit never pays for its own refill.
        """
        plan = self.plan
        if base_config is None and plan.solution is not None:
            base_config = plan.solution.config
        base_mask = plan._masked.copy()
        snap_solution = plan._solution
        snap_argmin = plan._argmin_solution
        snap_solves = plan.stats.solves

        obs = [np.asarray(m, dtype=bool).copy() for m in extra_masks] \
            + [self._observed_masks[k] for k, _c in
               self._observed.most_common(self.policy.top_observed)]
        cands = candidate_masks(
            base_mask, plan.network.source_node,
            single_node=self.policy.single_node,
            tier_groups=self.tier_groups, observed=obs,
            include_base=True, max_masks=self.policy.max_masks)

        entries: Dict[bytes, ContingencyEntry] = {}
        for mask in cands:
            self._toggle_to(plan, mask)
            sol = plan.solve()
            dps = self._current_dps(plan)
            fr = plan.frontier(k_per_exit=self.k_per_exit)
            moved, bits = migration_delta(
                plan.profile, base_config,
                sol.config if sol.feasible else None)
            entries[mask.tobytes()] = ContingencyEntry(
                masked=tuple(int(n) for n in np.nonzero(mask)[0]),
                solution=sol, frontier=fr, dps=dps,
                base_config=base_config, moved=moved, bits=bits)

        # restore the plan bit for bit: base mask, the incumbent/argmin
        # snapshots, and the base-state DP grids re-tagged against the
        # (mask-toggle-advanced) quant version — the base entry holds the
        # grids relaxed at exactly this state, so subsequent solves at the
        # base mask stay relaxation-free
        self._toggle_to(plan, base_mask)
        plan._solution = snap_solution
        plan._argmin_solution = snap_argmin
        plan.stats.solves = snap_solves + len(entries)
        base_entry = entries.get(base_mask.tobytes())
        if base_entry is not None and base_entry.dps is not None:
            plan._dp_cache = (plan._quant_version, base_entry.dps)

        self._entries = entries
        self._env_version = plan.env_version
        self.stats.refills += 1
        self.stats.entries_built += len(entries)
        return len(entries)


class PopulationContingency:
    """Prebuilt failover cohort states for one :class:`Population`.

    ``refill()`` walks the live cohort states, generates each state's
    candidate failure masks, materializes the (pack, candidate-mask)
    signatures that do not exist yet through the population's own
    signature-dedupe registry, and relaxes all the newborn states in one
    chained banded relaxation (counted in ``stats.prebuilt_states``, not
    in ``dp_relaxes`` -- a covered failure tick's relaxation count stays
    zero).  The prebuilt states are pinned through cache compaction until
    the next refill re-derives the pin set.

    ``coverage(node, kind, users)`` is the event-time probe the
    orchestrator calls when a failure/recovery event arrives: per unique
    affected state it checks whether the flipped-mask signature is
    already relaxed.  It runs before the tick's channel ingest, so it is
    optimistic when a fade re-keys a user in the same tick.
    """

    def __init__(self, pop: Population, *,
                 policy: Optional[ContingencyPolicy] = None):
        self.pop = pop
        self.policy = policy if policy is not None else ContingencyPolicy()
        tg = self.policy.tier_groups
        self.tier_groups: List[Tuple[int, ...]] = (
            tier_groups_of(pop.network0) if tg == "auto"
            else [tuple(int(n) for n in g) for g in tg])
        self.stats = ContingencyStats()
        self._observed: Counter = Counter()
        self._observed_masks: Dict[bytes, np.ndarray] = {}

    # ----------------------------------------------------------------- probe
    def observe(self, mask: np.ndarray) -> None:
        m = np.asarray(mask, dtype=bool)
        key = m.tobytes()
        self._observed[key] += 1
        if key not in self._observed_masks:
            self._observed_masks[key] = m.copy()
        self.stats.observed += 1

    def coverage(self, node: int, kind: str,
                 users: Optional[Sequence[int]] = None) -> Tuple[int, int]:
        """Predict a failure/recovery event's library coverage: for every
        unique cohort state the event actually flips, is the flipped-mask
        signature present and relaxed?  Returns (hit_states, miss_states)
        and feeds the observed-mask counter."""
        if kind not in ("fail", "recover"):
            raise ValueError(f"kind must be 'fail' or 'recover', "
                             f"got {kind!r}")
        pop = self.pop
        sel = (np.arange(pop.U) if users is None
               else np.asarray(users, dtype=np.int64))
        val = kind == "fail"
        sel = sel[pop._masked[sel, node] != val]
        hits = misses = 0
        for sid in np.unique(pop._user_state[sel]):
            st = pop._states[int(sid)]
            m = st.mask.copy()
            m[node] = val
            self.observe(m)
            s2 = pop._state_ids.get(pop._state_key(st.stq, m))
            if s2 is not None and pop._states[int(s2)].dps is not None:
                hits += 1
            else:
                misses += 1
        self.stats.hits += hits
        self.stats.misses += misses
        return hits, misses

    # ----------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """The observed-mask counters as plain arrays, in insertion order
        (``Counter.most_common`` breaks count ties by insertion, so the
        order is part of which masks the next refill covers)."""
        keys = list(self._observed.keys())
        N = self.pop.N
        masks = (np.stack([self._observed_masks[k] for k in keys])
                 if keys else np.zeros((0, N), dtype=bool))
        counts = np.asarray([self._observed[k] for k in keys],
                            dtype=np.int64)
        return {"obs_masks": masks, "obs_counts": counts}

    def restore_state(self, d: dict) -> None:
        """Restore :meth:`state_dict` (the prebuilt states themselves ride
        the cohort's own ``state_dict``)."""
        masks = np.asarray(d["obs_masks"], dtype=bool)
        counts = np.asarray(d["obs_counts"], dtype=np.int64)
        if masks.ndim != 2 or masks.shape[0] != len(counts) \
                or (len(masks) and masks.shape[1] != self.pop.N):
            raise ValueError(f"observed-mask checkpoint shapes "
                             f"{masks.shape} / {counts.shape} do not fit "
                             f"a {self.pop.N}-node population")
        self._observed = Counter()
        self._observed_masks = {}
        for m, c in zip(masks, counts):
            key = m.tobytes()
            self._observed[key] = int(c)
            self._observed_masks[key] = m.copy()

    # ---------------------------------------------------------------- refill
    def refill(self, *, extra_masks: Sequence[np.ndarray] = ()) -> int:
        """Prebuild the candidate failover states of every live cohort
        state: find-or-add each (pack, candidate-mask) signature, relax
        every newborn in one chained batched relaxation (prebuilt counter,
        zero ``dp_relaxes``), build the vectorized-post-pass fast tables,
        and pin the whole set through compaction.  ``extra_masks`` adds
        operator-supplied absolute masks ahead of the observed candidates.
        Returns the number of states relaxed (0 = full coverage already).

        The missing signatures are materialized in one ``_add_states``
        batch (one device build of their DP inputs).  A key met twice in
        one refill resolves to its first newborn, and the ids are handed
        out in the order of first sight, as one ``_add_state`` per pair
        would."""
        pop = self.pop
        obs = [np.asarray(m, dtype=bool).copy() for m in extra_masks] \
            + [self._observed_masks[k] for k, _c in
               self._observed.most_common(self.policy.top_observed)]
        pinned: set = set()
        born: Dict[bytes, int] = {}
        items: List[Tuple[bytes, np.ndarray, np.ndarray, int]] = []
        for sid in np.unique(pop._user_state):
            st = pop._states[int(sid)]
            cands = candidate_masks(
                st.mask, pop.src, single_node=self.policy.single_node,
                tier_groups=self.tier_groups, observed=obs,
                include_base=False, max_masks=self.policy.max_masks)
            for mask in cands:
                key = pop._state_key(st.stq, mask)
                s2 = pop._state_ids.get(key)
                if s2 is None:
                    s2 = born.get(key)
                if s2 is None:
                    s2 = born[key] = len(pop._states) + len(items)
                    items.append((key, st.stq.copy(), mask.copy(), -1))
                pinned.add(int(s2))
        sids = pop._add_states(items)
        assert sids == [born[it[0]] for it in items]
        need = sorted(s for s in pinned if pop._states[s].dps is None)
        pop._relax_states(need, prebuilt=True)
        if pop._vector_postpass and pop._proto._admissible:
            for s in pinned:
                st = pop._states[s]
                if st.fast is None:
                    pop._build_fast(st)
        pop._pinned = pinned
        if len(pop._states) > pop.max_states:
            pop._compact_states()
        self.stats.refills += 1
        self.stats.entries_built += len(need)
        return len(need)
