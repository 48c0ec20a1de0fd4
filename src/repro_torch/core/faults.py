"""Deterministic fault injection for the serving stack.

The churn machinery already simulates *network* faults (node failures,
fading, congestion); this module injects faults into the *serving process
itself* so the fault-tolerance layer can be tested and benchmarked
deterministically:

  * telemetry corruption — NaN/Inf/negative readings and frozen (stuck)
    sensors written into a ``(T, U)`` fading-scale trace
    (:meth:`FaultPlan.corrupt`), exercising ``TelemetryPolicy``
    quarantine/clamp and the loud-raise default;
  * trace mangling — dropped and duplicated ticks
    (:meth:`FaultPlan.mangle_trace`), the upstream-feed failure mode;
  * mid-tick crash points — :meth:`FaultPlan.crash_hook` raises
    :class:`InjectedCrash` at a named pipeline stage
    (``ingest``/``relax``/``post``) of a named tick, driving the
    checkpoint/restore oracle without SIGKILL plumbing;
  * simulated host stalls — :meth:`FaultPlan.stall_hook` builds a
    ``MeshRelaxer.fault_hook`` that times out the first ``n`` collective
    dispatch attempts, driving the retry/demotion ladder.

Everything is seeded and pure in the trace: the same ``FaultPlan`` over
the same inputs produces the same corrupted trace, crash points and stall
schedule, so the oracles (quarantined-users-serve-last-known-good,
kill/restore bit-exactness) can compare against clean runs exactly.

Port of ``repro/core/faults.py``, host numpy as there: the seeded streams
(``_rng(salt)``) are the reference's, so one plan over one trace corrupts
and mangles it byte for byte as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["FaultPlan", "FaultSpec", "InjectedCrash"]

#: telemetry-corruption kinds written into a trace by :meth:`corrupt`
_CORRUPT_KINDS = ("nan", "inf", "negative", "stuck")
#: trace-mangling kinds applied by :meth:`mangle_trace`
_MANGLE_KINDS = ("drop_tick", "dup_tick")
#: pipeline stages :meth:`crash_hook` recognizes
CRASH_STAGES = ("ingest", "relax", "post")


class InjectedCrash(RuntimeError):
    """A deliberate mid-tick crash raised by :meth:`FaultPlan.crash_hook`."""


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault.

    ``kind``  one of ``nan``/``inf``/``negative``/``stuck`` (telemetry),
              ``drop_tick``/``dup_tick`` (trace mangling), ``crash``
              (mid-tick exception at ``stage``).
    ``tick``  the trace row / tick index the fault lands on.
    ``user``  the affected user for telemetry kinds (None = ``count``
              seeded random users).
    ``value`` the corrupt reading for ``negative`` (its absolute value is
              negated) — NaN/Inf kinds ignore it.
    ``count`` telemetry: how many users (when ``user`` is None);
              ``stuck``: how many consecutive ticks the reading freezes.
    ``stage`` crash point for ``kind="crash"``: ``ingest``/``relax``/
              ``post``.
    """

    kind: str
    tick: int
    user: Optional[int] = None
    value: float = 1.0
    count: int = 1
    stage: str = "ingest"

    def __post_init__(self):
        known = _CORRUPT_KINDS + _MANGLE_KINDS + ("crash",)
        if self.kind not in known:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {known})")
        if self.kind == "crash" and self.stage not in CRASH_STAGES:
            raise ValueError(f"crash stage must be one of {CRASH_STAGES}, "
                             f"got {self.stage!r}")
        if self.tick < 0 or self.count < 1:
            raise ValueError("tick must be >= 0 and count >= 1")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic set of :class:`FaultSpec`\\ s."""

    seed: int = 0
    specs: Tuple[FaultSpec, ...] = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    def _rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, salt))

    # ------------------------------------------------------------- telemetry
    def corrupt(self, qualities: np.ndarray
                ) -> Tuple[np.ndarray, List[Tuple[int, int, str]]]:
        """Apply the telemetry specs to a ``(T, U)`` trace (copy).

        Returns ``(corrupted, info)`` where ``info`` lists the injected
        ``(tick, user, kind)`` triples (stuck freezes report every frozen
        tick).  Specs whose tick falls outside the trace are ignored, so
        one plan serves traces of different lengths.
        """
        q = np.array(qualities, dtype=np.float64, copy=True)
        if q.ndim != 2:
            raise ValueError(f"qualities must be (T, U), got {q.shape}")
        T, U = q.shape
        info: List[Tuple[int, int, str]] = []
        for si, sp in enumerate(self.specs):
            if sp.kind not in _CORRUPT_KINDS or sp.tick >= T:
                continue
            if sp.user is not None:
                users = [int(sp.user)]
            else:
                # ``count`` means freeze LENGTH for stuck (one user), user
                # count for the point corruptions
                n_u = 1 if sp.kind == "stuck" else min(sp.count, U)
                users = sorted(int(u) for u in self._rng(si).choice(
                    U, size=n_u, replace=False))
            for u in users:
                if sp.kind == "nan":
                    q[sp.tick, u] = np.nan
                    info.append((sp.tick, u, "nan"))
                elif sp.kind == "inf":
                    q[sp.tick, u] = np.inf
                    info.append((sp.tick, u, "inf"))
                elif sp.kind == "negative":
                    q[sp.tick, u] = -abs(sp.value)
                    info.append((sp.tick, u, "negative"))
                else:                           # stuck: freeze the reading
                    stop = min(sp.tick + sp.count, T)
                    q[sp.tick:stop, u] = q[sp.tick, u]
                    for t in range(sp.tick, stop):
                        info.append((t, u, "stuck"))
        return q, info

    # --------------------------------------------------------- trace mangling
    def mangle_trace(self, qualities: np.ndarray) -> np.ndarray:
        """Drop/duplicate whole ticks of a ``(T, U)`` trace (copy).

        ``drop_tick`` removes row ``tick``; ``dup_tick`` feeds row ``tick``
        twice (the duplicate lands right after the original).  Drops are
        applied before duplicates, each against the ORIGINAL tick
        numbering, so a plan reads as "tick 3 never arrived, tick 5 came
        twice" regardless of spec order.
        """
        q = np.asarray(qualities, dtype=np.float64)
        if q.ndim != 2:
            raise ValueError(f"qualities must be (T, U), got {q.shape}")
        T = len(q)
        drops = {sp.tick for sp in self.specs
                 if sp.kind == "drop_tick" and sp.tick < T}
        dups = {sp.tick for sp in self.specs
                if sp.kind == "dup_tick" and sp.tick < T}
        rows = []
        for t in range(T):
            if t in drops:
                continue
            rows.append(q[t])
            if t in dups:
                rows.append(q[t])
        return (np.stack(rows) if rows
                else np.zeros((0,) + q.shape[1:], dtype=q.dtype))

    # ------------------------------------------------------------ crash points
    def crash_hook(self, stage: str, tick: int) -> None:
        """Raise :class:`InjectedCrash` when a crash spec matches.

        The orchestrator calls this at its pipeline boundaries; pass the
        same plan again after a restore only if the crash should re-fire.
        """
        for sp in self.specs:
            if sp.kind == "crash" and sp.tick == tick and sp.stage == stage:
                raise InjectedCrash(
                    f"injected crash at tick {tick} stage {stage!r}")

    def crash_ticks(self) -> List[Tuple[int, str]]:
        """The (tick, stage) crash points, in spec order."""
        return [(sp.tick, sp.stage) for sp in self.specs
                if sp.kind == "crash"]

    # ------------------------------------------------------------- host stalls
    @staticmethod
    def stall_hook(n: int,
                   exc: type = TimeoutError) -> Callable[[int], None]:
        """A ``MeshRelaxer.fault_hook`` that fails the first ``n`` dispatch
        attempts (counted across calls) with ``exc`` — a simulated host
        stall/dropout.  With ``n`` larger than the relaxer's retry budget
        the demotion ladder engages; smaller ``n`` exercises pure retry."""
        left = [int(n)]

        def hook(attempt: int) -> None:
            if left[0] > 0:
                left[0] -= 1
                raise exc(f"injected host stall (attempt {attempt})")
        return hook


def corrupt_specs(ticks: Sequence[int], *, kind: str = "nan",
                  users_per_tick: int = 1, stuck_len: int = 3
                  ) -> List[FaultSpec]:
    """Convenience: one telemetry spec per tick (seeded users)."""
    return [FaultSpec(kind=kind, tick=int(t), count=(stuck_len if
                      kind == "stuck" else users_per_tick))
            for t in ticks]
