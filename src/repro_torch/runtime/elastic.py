"""Elastic scaling: recover a valid production mesh after chip/pod loss.

Port of ``repro/runtime/elastic.py``.  On a real fleet, losing a host
shrinks the usable device set.  This module
picks the best replacement mesh (largest chip count whose (data, model)
factorization keeps every sharded dimension divisible), and emits a re-shard
plan: which axes change and the collective cost of the migration.  Together
with checkpoint/restart (runtime/checkpoint.py) and warm FIN re-placement
(:func:`fin_failover`, over the persistent ``core.Plan`` IR), this is the
framework's elasticity story: state is restored from the latest
checkpoint under the new mesh, and the serving placement re-solves as a
node-mask delta instead of a pipeline rebuild — on the plan's device (B1,
``cuda:0`` unless the plan was built with ``device="cpu"``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..configs.base import ArchConfig
from ..core.contingency import ContingencyLibrary
from ..core.plan import Plan, migration_delta
from ..core.problem import Config, Solution


@dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    pods: int = 1

    @property
    def chips(self) -> int:
        return self.data * self.model * self.pods


def _divisible_ok(cfg: ArchConfig, model: int) -> bool:
    """Is a model-axis of this size compatible with the config's dims?"""
    if cfg.parallelism_mode == "pure_dp":
        return True
    if cfg.padded_vocab % model:
        return False
    if cfg.d_ff and cfg.d_ff % model:
        return False
    if cfg.d_model % model:
        return False
    return True


def candidate_meshes(cfg: ArchConfig, chips_available: int,
                     *, min_data: int = 1) -> List[MeshPlan]:
    """All (data, model) factorizations of <= chips_available that satisfy
    the config's divisibility constraints, best (largest, most data) first."""
    out: List[MeshPlan] = []
    for total in range(chips_available, 0, -1):
        for model in range(1, total + 1):
            if total % model:
                continue
            data = total // model
            if data < min_data:
                continue
            if _divisible_ok(cfg, model):
                out.append(MeshPlan(data=data, model=model))
        if out:
            break  # largest usable chip count found
    out.sort(key=lambda m: (-m.chips, -m.data))
    return out


@dataclass
class ReshardPlan:
    old: MeshPlan
    new: MeshPlan
    #: parameter bytes that must move (everything whose shard size changes)
    moved_bytes: float
    #: whether the global batch stays divisible (else grad-accum changes)
    batch_ok: bool


def plan_rescale(cfg: ArchConfig, old: MeshPlan, chips_available: int,
                 *, param_bytes: float, global_batch: int
                 ) -> Optional[ReshardPlan]:
    """Pick the best new mesh after degradation and cost the migration."""
    cands = candidate_meshes(cfg, chips_available)
    if not cands:
        return None
    new = cands[0]
    # if the model axis changes, every model-sharded tensor reshards (all
    # bytes move once); if only data shrinks, ZeRO shards re-balance (only
    # the delta moves).
    if new.model != old.model:
        moved = param_bytes
    else:
        frac = abs(new.data - old.data) / max(old.data, 1)
        moved = param_bytes * min(1.0, frac)
    return ReshardPlan(old=old, new=new, moved_bytes=moved,
                       batch_ok=global_batch % (new.data * new.pods) == 0)


# ---------------------------------------------------------------------------
# FIN placement failover over the persistent plan IR
# ---------------------------------------------------------------------------

@dataclass
class FinFailover:
    """Outcome of a warm FIN re-placement after a node event."""

    solution: Solution
    old_config: Optional[Config]
    new_config: Optional[Config]
    blocks_moved: int
    migration_bits: float
    #: True when the solution was installed from a contingency-library
    #: entry (zero DP relaxations) instead of warm re-solved
    library_hit: bool = False

    @property
    def feasible(self) -> bool:
        return self.solution.feasible


def fin_failover(plan: Plan, failed_node: int, *, recover: bool = False,
                 library: Optional[ContingencyLibrary] = None
                 ) -> FinFailover:
    """Re-place after a node failure (or recovery) as a warm plan delta.

    Masks (or unmasks) ``failed_node`` on the plan and issues a warm
    re-solve — the cached extended-graph tensors, quantized banded tensors
    and gather indices are reused, only row/col infinity masks change.  The
    result is bit-exact vs a cold ``solve_fin`` on the reduced network;
    the report carries the migration cost of moving the re-hosted blocks'
    state, the placement analogue of :class:`ReshardPlan`.

    With a ``core.contingency`` ``library`` covering the target mask the
    solution is *installed* from the precomputed entry instead — zero DP
    relaxations, identical result (``library_hit`` flags it); uncovered
    or environment-stale masks fall through to the warm re-solve above.
    """
    old = plan.solution.config if plan.solution is not None else None
    target = plan._masked.copy()
    target[failed_node] = not recover
    entry = library.lookup(target) if library is not None else None
    if recover:
        plan.unmask_node(failed_node)
    else:
        plan.mask_node(failed_node)
    if entry is not None:
        sol = plan.install_solution(entry.solution, dps=entry.dps)
    else:
        sol = plan.solve()
    new = sol.config if sol.feasible else None
    moved, bits = migration_delta(plan.profile, old, new)
    return FinFailover(solution=sol, old_config=old, new_config=new,
                       blocks_moved=moved, migration_bits=bits,
                       library_hit=entry is not None)
