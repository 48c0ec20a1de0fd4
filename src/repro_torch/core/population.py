"""Struct-of-arrays population engine: whole-cohort churn ticks.

Port of ``repro/core/population.py``.  One cohort of same-shape users (one
network topology, one DNN profile, one requirements triple, one solver
parameterization) owns its batched state as single contiguous arrays --

  * ``(U, N)`` per-user source-link bandwidth vectors,
  * ``(U, N)`` failure bitmaps,
  * ``(U, L)`` / ``(U,)`` incumbent placements, exits and energies,

and the per-tick pipeline -- channel ingest -> fused requantize+signature
kernel -> in-cell cache check -> chained banded relaxation ->
argmin/post-pass -- runs as whole-array operations with NO per-user Python
on the hot path.  Quantized uplink packs are NOT stored per user: a user's
pack always equals their cohort state's ``stq`` (states are keyed BY the
pack), so the engine keeps one int16 signature row per *state*
(``_stq_enc``) and stale-row requantization compares fresh signatures
against a gather from that table; re-keying touches exactly the rows whose
encoding moved.

Users whose quantized packs (and failure masks) coincide share one *cohort
state*: one (M, L-1, N, N) steepness stack, one relaxed DP grid, one
memoized per-exit minimum, one backtracked candidate list.  A tick relaxes
only the cohort states born this tick, and the exact per-user post-pass
re-reads the *true* bandwidth through the shared candidates.

Where the state lives.  The bandwidth store, masks, incumbents, the state
registry and the DP results stay host numpy: the exact post-pass, the
hysteresis gate and the checkpoint read them bit for bit.  On the cohort's
device (``cuda:0`` unless ``device="cpu"``) live the requantizer constants
(the proto ``Plan``'s packs), a mirror of the signature table that the
ingest compares against (rows of newborn states are copied up once), and
each state's masked steepness stack and init grid.  An ingest sends its
bandwidth rows to the device once; the fused ingest (kernel B2,
``kernels/ee_gate``) writes their signatures there, the compare against
the gathered table runs there, and only the changed-row flags and the
changed rows come back, to be keyed with the reference's ``np.unique`` (so
state ids follow its order).  Newborn states relax in one launch a chunk of
the banded argmin chain (kernel B1), whose results come back to the host
once a launch.

Results are bit-exact against the reference's ``Population`` on the
float64 ``minplus`` backend: the ingest replicates the packed requantizer
elementwise, states materialize through the same scatter formulas, the
relaxation is B1 (bit-equal to the reference's float64 engine) and the
post-pass is the shared host code.  ``backend="f32"`` relaxes in float32
(the reference's ``jnp`` / ``pallas``); ``backend="mesh"`` routes the
chained relaxation through the device-mesh layer
(``sharding/population.py``): one float32 B1 launch a shard of a users
mesh over the visible cards (logical shards on the CPU).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels.ee_gate.population import QuantConsts, quant_signature
from .bellman_ford import (batched_banded_relax_argmin,
                           batched_banded_relax_minarg, device_chunk_rows,
                           relax_chunk_rows)
from .dnn_profile import DNNProfile
from .feasible_graph import build_feasible_graph
from .fin import (_BandedArgDP, _backtrack, _best_feasible, _engine,
                  _exit_dmin)
from .frontier import (ParetoFrontier, eval_config_users, frontier_from_rows,
                       scan_state_users)
from .plan import Plan, _validate_bps_values, _validate_population_bps
from .problem import AppRequirements, Config, ConfigEval, Solution
from .system_model import Network
from .tolerances import dist_tol

__all__ = ["Population", "PopulationStats", "TelemetryPolicy"]


@dataclass(frozen=True)
class TelemetryPolicy:
    """What :meth:`Population.ingest` does with corrupt channel readings.

    Without a policy the engine fails LOUDLY: NaN/Inf/negative bandwidth
    raises a ``ValueError`` naming the offending users — garbage must
    never silently key a shared cohort state.  With a policy the reading
    is absorbed instead:

    ``mode="clamp"``       bad *entries* are replaced by the user's
                           current stored value (entry-wise last known
                           good); the rest of the row ingests normally.
    ``mode="quarantine"``  a user with ANY bad entry (or a stuck sensor,
                           below) holds their entire last-known-good
                           uplink vector — they keep serving their
                           incumbent and rejoin automatically on the
                           first clean reading.  Per-tick transitions are
                           counted in ``PopulationStats.quarantines`` /
                           ``recoveries`` (the orchestrator surfaces them
                           on ``TickReport``).
    ``mode="raise"``       the loud default, as a policy object.

    ``stuck_window > 0`` adds frozen-sensor detection to the quarantine
    mode: a user whose raw reading row repeats EXACTLY for that many
    consecutive ingests is quarantined until the reading moves again.
    """

    mode: str = "quarantine"
    stuck_window: int = 0

    def __post_init__(self):
        if self.mode not in ("raise", "clamp", "quarantine"):
            raise ValueError(f"TelemetryPolicy.mode must be raise/clamp/"
                             f"quarantine, got {self.mode!r}")
        if self.stuck_window < 0:
            raise ValueError("TelemetryPolicy.stuck_window must be >= 0")


@dataclass
class PopulationStats:
    """Aggregate engine counters (diagnostics and benches)."""

    ingests: int = 0             # ingest calls
    uplink_updates: int = 0      # user-slots refreshed by ingest
    quant_changed: int = 0       # user-slots whose quantized pack moved
    dp_relaxes: int = 0          # cohort states relaxed
    dp_cache_hits: int = 0       # user-solves served from an existing state
    solves: int = 0              # user-solves issued
    unique_solves: int = 0       # distinct (state, bandwidth) groups solved
    fastpath_states: int = 0     # states served by the shared fast table
    fallbacks: int = 0           # per-user Plan fallbacks (tighten loop)
    state_evictions: int = 0     # cache compactions
    prebuilt_states: int = 0     # contingency states relaxed off-tick
    fused_relaxes: int = 0       # newborn batches relaxed in ONE launch
    chunked_relaxes: int = 0     # newborn batches split by the residency
    #                              budget (REPRO_RELAX_CHUNK_BYTES)
    bounded_relaxes: int = 0     # states relaxed from a parent's layer slice
    layers_skipped: int = 0      # relax layers skipped by bounded resumes
    mask_reuses: int = 0         # masked states served by a parent's grids
    telemetry_bad: int = 0       # corrupt (user, link) readings seen
    telemetry_clamped: int = 0   # entries clamped to last known good
    quarantines: int = 0         # users entering quarantine
    recoveries: int = 0          # users leaving quarantine
    # per-phase wall clock (accumulated only when the Population was built
    # with timing=True — the counters stay zero-cost when disabled)
    t_ingest_ms: float = 0.0     # channel ingest + requantize
    t_relax_ms: float = 0.0      # banded relaxation launches
    t_post_ms: float = 0.0       # exact post-pass (solve minus relax)
    # post-pass sub-breakdown (subsets of t_post_ms): the general stacked
    # candidate scans, the shared fast-table broadcasts, and the per-user
    # Plan fallbacks.  A fallback issued from inside a scan's no-feasible
    # branch counts in BOTH t_post_scan_ms and t_post_fallback_ms.
    t_post_scan_ms: float = 0.0
    t_post_fast_ms: float = 0.0
    t_post_fallback_ms: float = 0.0


def _group_runs(keys: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group equal keys: (uniq, first, order, bounds).

    ``order[bounds[g]:bounds[g + 1]]`` are the positions of group ``g``
    (first-occurrence-stable); ``first[g]`` is its first position.  One
    home for the unique/stable-argsort/searchsorted idiom the solve,
    incumbent-evaluation and frontier paths all share.

    All-equal keys short-circuit without sorting: a cold-start cohort (one
    bandwidth row tiled U times) and steady single-config ticks are the
    common case at scale, and one vectorized compare beats a million-row
    argsort by orders of magnitude.
    """
    n = len(keys)
    if n > 1 and bool((keys == keys[0]).all()):
        return (keys[:1], np.zeros(1, dtype=np.int64),
                np.arange(n, dtype=np.int64),
                np.array([0, n], dtype=np.int64))
    uniq, first, inv = np.unique(keys, return_index=True,
                                 return_inverse=True)
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
    return uniq, first, order, bounds


def _enc_int16(q: np.ndarray) -> np.ndarray:
    """Checkpoint encoding of the inf-capable integral quantization arrays
    (qpack / state stq): values are either integers in [0, gamma] or +inf
    (gamma < int16 max is a ctor invariant), stored as int16 with -1 for
    inf — 4x smaller than float64 and exactly invertible."""
    e = np.empty(q.shape, dtype=np.int16)
    fin = np.isfinite(q)
    np.copyto(e, q, casting="unsafe", where=fin)
    e[~fin] = -1
    return e


def _dec_int16(e: np.ndarray) -> np.ndarray:
    out = e.astype(np.float64)
    out[e < 0] = np.inf
    return out


class _BwCols:
    """Column-gather view over selected rows of the bandwidth store.

    ``eval_config_users`` touches its bandwidth argument only through
    ``bwv[:, n]`` columns and ``len(bwv)``; gathering one (Us,) column per
    visited link — instead of materializing the whole (Us, N) row gather
    up front — keeps the per-group incumbent re-evaluation's memory
    traffic proportional to the links a configuration actually uses.
    Values are identical to ``bw[rows][:, n]``, so results stay bit-exact.
    """

    __slots__ = ("_bw", "_rows")

    def __init__(self, bw: np.ndarray, rows: np.ndarray):
        self._bw = bw
        self._rows = rows

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, key) -> np.ndarray:
        s, n = key                       # only the bwv[:, n] access pattern
        assert s == slice(None)
        return self._bw[self._rows, n]


class _LazyBwCols:
    """Column view over the LAZY bandwidth store (see ``_bw_lazy``):
    column ``n`` materializes as ``scale * factors[:, n]`` on demand —
    per-element IEEE multiplies identical to the fused dense product's
    column — without ever writing the (U, N) product.  Supports only the
    ``bwv[:, n]`` / ``len(bwv)`` access pattern of ``eval_config_users``.
    """

    __slots__ = ("_sc", "_fac", "_src")

    def __init__(self, sc: np.ndarray, fac: np.ndarray, src: int):
        self._sc = sc
        self._fac = fac
        self._src = src

    def __len__(self) -> int:
        return len(self._sc)

    def __getitem__(self, key) -> np.ndarray:
        s, n = key
        assert s == slice(None)
        if n == self._src:
            return np.full(len(self._sc), np.inf)
        return self._sc * self._fac[:, n]


class _PendingSolve:
    """In-flight tick handle between ``solve_begin`` and ``solve_finish``:
    the begin-time (state, bandwidth) snapshot, the grouped rows and the
    relax future (None when the relaxation ran synchronously)."""

    __slots__ = ("users", "build_solutions", "t0", "sids", "first",
                 "order", "bounds", "bw", "future")

    def __init__(self, users: np.ndarray, build_solutions: bool,
                 t0: float):
        self.users = users
        self.build_solutions = build_solutions
        self.t0 = t0
        self.sids = None
        self.first = None
        self.order = None
        self.bounds = None
        self.bw = None
        self.future = None


class _CandCache:
    """Per-(mode, exit) energy-ordered candidate cache of a cohort state."""

    __slots__ = ("items", "order", "exhausted")

    def __init__(self):
        self.items: List[Tuple[Config, float]] = []
        self.order = None            # (flat argsort, values, n_finite)
        self.exhausted = False


class _FastTable:
    """The state's shared first-candidate frontier decision (vector path).

    Exact energies are bandwidth-independent, so the scalar post-pass's
    control flow over FIRST candidates — which (quantizer pass, exit)
    pairs get scanned, which exit wins, whether the ceil rescue replaces
    the main pass — is a pure function of the cohort state and is computed
    ONCE at state birth.  A tick then only has to check, per user, that
    every scanned first candidate is exactly feasible (stacked-array
    feasibility flags); when it is — the overwhelmingly common case — the
    cached choice broadcasts to every user of the state, and any state
    where it is not falls back to the general vectorized scan.

    ``scan``   [(mi, k, pos)] the shared flow evaluates, in order;
    ``keys``/``cfgs``  the distinct first-candidate configs (pos-indexed);
    ``choice`` (mi, k, pos, energy, e_comp, e_comm, used_ceil) or None
               (None = the tighten-fallback path).
    """

    __slots__ = ("keys", "cfgs", "scan", "choice")

    def __init__(self, keys, cfgs, scan, choice):
        self.keys = keys
        self.cfgs = cfgs
        self.scan = scan
        self.choice = choice


class _CohortState:
    """One unique (quantized pack, failure mask) DP state of the cohort.

    Everything hanging off the state is shared by every user currently in
    it: the masked steepness stack and the init grid (device tensors, the
    relaxation's inputs), the relaxed DP grids (``dps``, host copies), the
    per-exit distance minima (memoized by ``fin._exit_dmin`` on the dp
    objects), the backtracked candidate lists and the first-candidate fast
    table of the vectorized post-pass.
    """

    __slots__ = ("stq", "mask", "steep", "grid", "dps", "cand", "fast",
                 "parent")

    def __init__(self, stq: np.ndarray, mask: np.ndarray,
                 steep: torch.Tensor, grid: torch.Tensor, parent: int = -1):
        self.stq = stq               # (M, 2L-1, N) host
        self.mask = mask             # (N,) bool host
        self.steep = steep           # (M, L-1, N, N) on the device, masked
        self.grid = grid             # (M, N, G+1) on the device, masked
        self.dps: Optional[List[_BandedArgDP]] = None
        self.cand: Dict[Tuple[int, int], _CandCache] = {}
        self.fast: Optional[_FastTable] = None
        #: state id the first user keyed here came FROM — a bounded
        #: re-relaxation *hint* only: the resume path re-validates the
        #: layer-prefix equality against whatever state currently sits at
        #: this index (compaction may remap it), so a stale hint degrades
        #: to a full relax, never to a wrong result
        self.parent = parent


class _TightenResult:
    """Per-user outcome arrays of one batched tighten loop
    (``Population._tighten_batch``)."""

    __slots__ = ("found", "energy", "latency", "e_comp", "e_comm", "exit",
                 "rounds", "delta_eff", "cfgs")

    def __init__(self, n: int, max_tighten: int):
        self.found = np.zeros(n, dtype=bool)
        self.energy = np.full(n, np.inf)
        self.latency = np.zeros(n)
        self.e_comp = np.zeros(n)
        self.e_comm = np.zeros(n)
        self.exit = np.full(n, -1, dtype=np.int64)
        #: failed-round count == the succeeding round's index (Plan's
        #: ``meta["tighten_rounds"]``); max_tighten+1 when exhausted
        self.rounds = np.full(n, max_tighten + 1, dtype=np.int64)
        self.delta_eff = np.full(n, np.nan)
        self.cfgs: List[Optional[Config]] = [None] * n


class Population:
    """Struct-of-arrays engine for a cohort of same-shape users.

    One cohort shares (network topology, DNN profile, requirements, solver
    parameters); per-user state is the source-link bandwidth vector, the
    quantized uplink pack, the failure bitmap and the incumbent.  Mixed
    populations (several apps / topologies) are lists of cohorts — see
    ``online.population_cohorts``.

    ``backend``: ``minplus``/``banded`` (float64, bit-exact vs the
    reference's numpy engine and ``Plan.solve()``), ``f32`` (the float32
    relaxation, the reference's ``jnp``/``pallas``) or ``mesh`` (float32,
    sharded over the users axis of a device mesh, ``MeshRelaxer``).
    ``device`` is where the relaxation and the fused ingest run
    (``cuda:0`` by default, raising without a card; ``"cpu"`` runs the
    kernels' plain versions).
    ``fused_ingest``: ``device`` (kernel B2 on the cohort's device) or
    ``numpy`` (the host oracle).
    """

    def __init__(self, network: Network, profile: DNNProfile,
                 req: AppRequirements, n_users: int, *, gamma: int = 10,
                 lam: Optional[int] = None, quantize: str = "floor",
                 max_tighten: int = 6, tighten_factor: float = 0.85,
                 backend: str = "minplus", check_aggregate_load: bool = False,
                 user_ids: Optional[Sequence[int]] = None,
                 max_states: int = 65536, vector_postpass: bool = True,
                 bounded_rerelax: bool = True, timing: bool = False,
                 telemetry: Optional[TelemetryPolicy] = None,
                 fused_ingest: str = "device", device: DeviceLike = None):
        if n_users <= 0:
            raise ValueError(f"n_users must be positive, got {n_users}")
        #: backend of the rare per-user Plan fallback (same engine family;
        #: the mesh's is the float32 one, the reference's ``jnp``)
        plan_backend = "f32" if backend == "mesh" else backend
        engine = _engine(plan_backend)
        if engine not in ("banded", "f32"):
            raise ValueError("Population requires a banded engine; the "
                             "dense backends exist for equivalence testing "
                             "only (use minplus/banded/f32/mesh)")
        if gamma >= np.iinfo(np.int16).max:
            raise ValueError(f"gamma {gamma} overflows the int16 state "
                             f"encoding")
        if fused_ingest == "jnp":
            raise ValueError("fused_ingest 'jnp' is the reference's jitted "
                             "XLA launch; the port's counterpart is "
                             "fused_ingest='device' (kernel B2)")
        if fused_ingest not in ("device", "numpy"):
            raise ValueError(f"unknown fused_ingest backend "
                             f"{fused_ingest!r} (expected device or numpy)")
        self.device = resolve_device(device)
        self.backend = backend
        self._plan_backend = plan_backend
        self._engine = engine
        self._dist_tol = dist_tol(self._engine)

        # the prototype Plan owns every *shared* stage-1/2 tensor: the
        # pristine extended graph, the packed-requantizer constants and the
        # base quantized steepness stack that per-user states scatter their
        # source-node rows/cols into.  Building it through Plan (rather
        # than duplicating the builders) is what makes population state
        # equal per-plan state by construction.
        self._proto = Plan(network, profile, req, gamma=gamma, lam=lam,
                           quantize=quantize, max_tighten=max_tighten,
                           tighten_factor=tighten_factor, n_best=1,
                           backend=self._plan_backend,
                           check_aggregate_load=check_aggregate_load,
                           device=self.device)
        self.profile = profile
        self.req = req
        self.gamma = gamma
        self.lam = self._proto.lam
        self.quantize = quantize
        self.max_tighten = max_tighten
        self.tighten_factor = tighten_factor
        self.check_aggregate_load = check_aggregate_load
        self.network0 = self._proto.network      # pristine base (live view)
        self.max_states = max_states

        N = self.network0.n_nodes
        L = profile.n_blocks
        self.U = int(n_users)
        self.N, self.L = N, L
        self.M = len(self._proto._modes)
        self.src = self.network0.source_node
        self.user_ids = (np.arange(self.U, dtype=np.int64)
                         if user_ids is None
                         else np.asarray(user_ids, dtype=np.int64))
        assert len(self.user_ids) == self.U

        # per-user SoA state (quantized packs live on the cohort states —
        # a user's pack IS their state's ``stq``, see the module doc)
        base_row = self._proto._bw[self.src].copy()
        base_row[self.src] = np.inf
        self._bw_vec = np.tile(base_row, (self.U, 1))          # (U, N)
        #: lazy bandwidth store: when set to (scale, factors) the DENSE
        #: ``_bw_vec`` contents are stale and the true store is the
        #: deferred product ``scale[:, None] * factors`` (src column inf).
        #: The dense-tick gate reads columns and the resolve subset reads
        #: rows, so the full (U, N) multiply — the single biggest memory
        #: pass of a steady tick — only happens if a dense consumer
        #: (checkpoint, partial ingest, slice reprice) actually shows up.
        #: All accessors (``_bw_dense``/``_bw_rows``/``_bw_cols``) produce
        #: values bit-identical to the eager multiply.
        self._bw_lazy: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._masked = np.zeros((self.U, N), dtype=bool)
        self._stale = np.zeros(self.U, dtype=bool)   # deferred requants
        self._user_state = np.full(self.U, -1, dtype=np.int64)
        self._solved = np.zeros(self.U, dtype=bool)
        self._inc_place = np.full((self.U, L), -1, dtype=np.int32)
        self._inc_exit = np.full(self.U, -1, dtype=np.int32)
        self._inc_energy = np.full(self.U, np.inf)
        self._solutions = np.full(self.U, None, dtype=object)
        #: whether any Solution object is live (lets the incumbent-only
        #: recording path skip the (U,) object-array clear entirely)
        self._any_solutions = False
        #: uniform-incumbent flag: the (exit, placement) every user is
        #: solved with, or None when unknown/mixed — lets the dense
        #: hysteresis gate skip the per-tick grouping key build
        self._inc_single: Optional[Tuple] = None

        # telemetry sanitization (see :class:`TelemetryPolicy`): quarantine
        # flags and frozen-sensor counters are always allocated (cheap);
        # the raw-reading history only when stuck detection is on
        self._telemetry = telemetry
        self._quarantined = np.zeros(self.U, dtype=bool)
        self._stuck_count = np.zeros(self.U, dtype=np.int32)
        self._last_raw = (np.full((self.U, N), np.nan)
                          if telemetry is not None
                          and telemetry.stuck_window > 0 else None)
        #: internal re-ingests (``update_slice`` replaying the stored
        #: bandwidths) must not look like telemetry ticks
        self._suspend_telemetry = False

        # cohort-state table (the cross-user DP dedupe)
        self._states: List[_CohortState] = []
        self._state_ids: Dict[bytes, int] = {}
        #: contingency-prebuilt state ids pinned through compaction
        #: (``core/contingency.py``; cleared when the state table is)
        self._pinned: set = set()
        #: cohort-wide exact-energy memo (energy is bandwidth-independent):
        #: (exit, placement) -> (energy, e_comp, e_comm); cleared with the
        #: state table on compute-slice churn
        self._cfg_energy: Dict[Tuple, Tuple[float, float, float]] = {}
        self._fallback_plan: Optional[Plan] = None
        #: vectorized frontier post-pass (core/frontier.py): all (candidate,
        #: user) pairs of a cohort state scored as stacked arrays instead of
        #: one scalar ``_best_feasible`` per unique (state, bandwidth) —
        #: bit-exact either way; False keeps the scalar path (the oracle).
        self._vector_postpass = bool(vector_postpass)
        #: bounded re-relaxation (affected-layer-onward resumes and whole-
        #: grid reuse for masked-out unreached nodes); False forces every
        #: newborn state through the full layer chain — the oracle switch
        #: the equivalence tests and benches flip
        self._bounded = bool(bounded_rerelax)
        #: live masked-entry count — lets the hot incumbent gate skip the
        #: (U, N) bitmap scan entirely when no user has a failure
        self._mask_count = 0
        self._timing = bool(timing)
        self._relax_executor = None      # lazy 1-thread pool (streaming)
        #: the mesh backend's relaxer (``sharding/population.py``), built
        #: on first use; the orchestrator reads its retry / demotion
        #: counters and demotes it on straggler flags
        self._mesh_relaxer = None
        #: wall seconds of the most recent relaxation launch — the
        #: streaming pipeline's adaptive-overlap signal (see
        #: ``online.run_arrays``); always recorded, timing flag or not
        self._last_relax_s = 0.0
        self._ingest_backend = fused_ingest
        self._quant_consts: Optional[QuantConsts] = None
        #: tighten-cell dedupe for the batched fallback (see
        #: ``_tighten_batch``): relaxed single-mode states keyed by
        #: (round, signature@delta_eff, mask) plus the per-round base
        #: steepness stack.  Marginal users drift within a handful of
        #: quantization cells, so steady-state ticks hit these caches and
        #: the whole tighten herd costs scans, not relaxations.
        self._tighten_cache: Dict[Tuple[int, bytes, bytes],
                                  _CohortState] = {}
        self._tighten_base: Dict[int, torch.Tensor] = {}
        self.stats = PopulationStats()
        #: bytes this cohort copied host -> device and device -> host (the
        #: ingest rows and signatures, the signature-table mirror, state
        #: tensors, relaxation results); diagnostics only, zero on the CPU
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        # uniform cold start: every user holds the proto pack and an empty
        # failure mask, which is ONE cohort state — register it directly
        # instead of encoding/hashing U identical signature rows (the 1e7
        # cold start used to spend ~50 s here)
        self._enc_w = self.M * (2 * L - 1) * N
        self._stq_enc = np.empty((0, self._enc_w), dtype=np.int16)
        #: device mirror of the signature table: the ingest's compare
        #: gathers from it; its first ``_enc_dev_rows`` rows are current
        #: (``_enc_table`` copies newborn rows up before each gather)
        self._enc_dev = torch.empty((0, self._enc_w), dtype=torch.int16,
                                    device=self.device)
        self._enc_dev_rows = 0
        stq0 = self._proto._qpack.cpu().numpy().copy()
        mask0 = np.zeros(N, dtype=bool)
        self._user_state[:] = self._add_state(self._state_key(stq0, mask0),
                                              stq0, mask0)

    # ------------------------------------------------------------ properties
    @property
    def n_users(self) -> int:
        return self.U

    @property
    def n_states(self) -> int:
        return len(self._states)

    @property
    def depth_window_lo(self) -> Optional[int]:
        return self.gamma - self.lam if self.lam < self.gamma else None

    @property
    def masked_nodes(self) -> List[int]:
        """Nodes masked for EVERY user (the cohort-wide failure set)."""
        return [int(n) for n in np.nonzero(self._masked.all(axis=0))[0]]

    @property
    def inc_found(self) -> np.ndarray:
        """(U,) bool — users whose incumbent is a feasible configuration
        (``_best_feasible`` only ever returns exactly-feasible configs, so
        found == feasible, mirroring ``Solution.feasible``)."""
        return self._inc_exit >= 0

    def solution(self, u: int) -> Optional[Solution]:
        return self._solutions[u]

    def solutions(self, users: Optional[Sequence[int]] = None
                  ) -> List[Optional[Solution]]:
        users = range(self.U) if users is None else users
        return [self._solutions[int(u)] for u in users]

    # --------------------------------------------------------------- ingest
    def ingest(self, bps: Union[float, np.ndarray],
               users: Optional[np.ndarray] = None,
               requant: bool = True) -> Optional[np.ndarray]:
        """Per-tick channel ingest: set the selected users' source-link
        bandwidths and requantize their packs as ONE stacked pipeline.

        ``bps`` is a scalar, a (Us,) per-user scalar or a (Us, N)
        per-target matrix (``users`` defaults to the whole cohort).
        Elementwise identical to ``Plan.update_uplink`` per user; returns
        the (Us,) DP-input-changed flags.  Malformed shapes raise a clear
        ``ValueError`` up front (see ``plan._validate_population_bps``).

        ``requant=False`` defers the requantization: the bandwidths land
        now (incumbent re-evaluation reads only the TRUE bandwidth), the
        packs refresh lazily when a user actually re-solves — under
        hysteresis almost no one does, so the scale path skips ~all of the
        quantization work without changing any decision or solution.
        Returns None in that case (the change flags are not yet known).
        """
        t0 = time.perf_counter() if self._timing else 0.0
        users = (np.arange(self.U) if users is None
                 else np.asarray(users, dtype=np.int64))
        Us = len(users)
        self._bw_dense()      # partial write + last-known-good reads below
        arr = _validate_population_bps(bps, Us, self.N)
        vec = np.empty((Us, self.N))
        vec[:] = arr if arr.ndim == 2 else \
            (np.broadcast_to(np.asarray(arr, dtype=np.float64)
                             .reshape(-1, 1), (Us, self.N)))
        vec[:, self.src] = np.inf                # self-loop (Sec. II-A)
        if not self._suspend_telemetry:
            self._screen_rows(users, vec)
        self._bw_vec[users] = vec
        self.stats.ingests += 1
        self.stats.uplink_updates += Us
        if not requant:
            self._stale[users] = True
            if self._timing:
                self.stats.t_ingest_ms += (time.perf_counter() - t0) * 1e3
            return None
        changed = self._requant_users(users, vec)
        self._stale[users] = False
        if self._timing:
            self.stats.t_ingest_ms += (time.perf_counter() - t0) * 1e3
        return changed

    def ingest_factors(self, scale: np.ndarray, factors: np.ndarray,
                       requant: bool = True) -> Optional[np.ndarray]:
        """Whole-cohort ingest from a per-user scale and a per-user factor
        row: the new bandwidth matrix is ``scale[:, None] * factors``
        written straight into the SoA store (one fused multiply, no
        intermediate (U, N) staging copy).  ``factors`` encodes the static
        per-user link pattern (attachment edge, detach fraction) so a
        dense channel tick only has to supply the (U,) fading scale.

        Semantically identical to ``ingest(scale[:, None] * factors)``
        over all users; same ``requant`` contract.
        """
        if scale.shape != (self.U,) or factors.shape != (self.U, self.N):
            raise ValueError(
                f"ingest_factors expects scale ({self.U},) and factors "
                f"({self.U}, {self.N}); got {scale.shape} and "
                f"{factors.shape}")
        t0 = time.perf_counter() if self._timing else 0.0
        if self._telemetry is None or self._telemetry.mode == "raise":
            # loud default: a corrupt fading scale must not reach the store
            # (factors are orchestrator-owned link patterns, not telemetry)
            _validate_bps_values(scale, what="ingest_factors scale")
            if not requant:
                # defer the (U, N) product: the gate and resolve subset
                # read through the lazy accessors (see ``_bw_lazy``)
                self._bw_lazy = (scale, factors)
            else:
                np.multiply(scale[:, None], factors, out=self._bw_vec)
                self._bw_vec[:, self.src] = np.inf   # self-loop (Sec. II-A)
                self._bw_lazy = None
        else:
            # screened path: stage the product so quarantined/clamped rows
            # can be substituted before they land in the store — values are
            # bit-identical to the fused multiply
            self._bw_dense()       # substitution reads last-known-good rows
            vec = scale[:, None] * factors
            vec[:, self.src] = np.inf
            self._screen_rows(np.arange(self.U), vec)
            self._bw_vec[:] = vec
        self.stats.ingests += 1
        self.stats.uplink_updates += self.U
        if not requant:
            self._stale[:] = True
            if self._timing:
                self.stats.t_ingest_ms += (time.perf_counter() - t0) * 1e3
            return None
        changed = self._requant_users(np.arange(self.U), self._bw_vec)
        self._stale[:] = False
        if self._timing:
            self.stats.t_ingest_ms += (time.perf_counter() - t0) * 1e3
        return changed

    def _screen_rows(self, users: np.ndarray, vec: np.ndarray) -> None:
        """Telemetry screening over a staging ingest batch (in place).

        ``vec`` is the (Us, N) staging matrix about to be written into the
        bandwidth store (src column already inf).  Corrupt entries are
        NaN/Inf/negative outside the src column.  Without a policy (or in
        ``raise`` mode) any corruption raises a ``ValueError`` naming the
        offending users; ``clamp`` substitutes bad entries with the user's
        stored value; ``quarantine`` substitutes the WHOLE row of any
        offender (incl. stuck sensors) with their stored last-known-good
        vector — the subsequent wholesale store + requantize then treats a
        quarantined user exactly like a user whose channel froze, so no
        cohort state is ever keyed on a corrupt pack and held users keep
        serving their incumbent bit-exactly.
        """
        pol = self._telemetry
        bad_ent = ~np.isfinite(vec) | (vec < 0)
        bad_ent[:, self.src] = False
        any_bad = bool(bad_ent.any())
        if any_bad:
            self.stats.telemetry_bad += int(np.count_nonzero(bad_ent))
        if pol is None or pol.mode == "raise":
            if any_bad:
                _validate_bps_values(None, bad=bad_ent, users=users,
                                     what="ingest bps")
            return
        if pol.mode == "clamp":
            if any_bad:
                np.copyto(vec, self._bw_vec[users], where=bad_ent)
                self.stats.telemetry_clamped += \
                    int(np.count_nonzero(bad_ent))
            return
        # quarantine: row-level hold on corrupt or frozen readings
        bad_user = bad_ent.any(axis=1)
        if pol.stuck_window > 0:
            rep = (vec == self._last_raw[users]).all(axis=1)
            cnt = np.where(rep, self._stuck_count[users] + 1, 0)
            self._stuck_count[users] = cnt
            self._last_raw[users] = vec
            bad_user |= cnt >= pol.stuck_window
        was_q = self._quarantined[users]
        newly = bad_user & ~was_q
        healed = was_q & ~bad_user
        if newly.any():
            self._quarantined[users[newly]] = True
            self.stats.quarantines += int(np.count_nonzero(newly))
        if healed.any():
            self._quarantined[users[healed]] = False
            self.stats.recoveries += int(np.count_nonzero(healed))
        if bad_user.any():
            np.copyto(vec, self._bw_vec[users], where=bad_user[:, None])

    # ---------------------------------------------- lazy bandwidth accessors
    def _bw_dense(self) -> np.ndarray:
        """The dense (U, N) bandwidth store, materializing a pending lazy
        product first (one fused multiply — identical to the eager path)."""
        lz = self._bw_lazy
        if lz is not None:
            sc, fac = lz
            np.multiply(sc[:, None], fac, out=self._bw_vec)
            self._bw_vec[:, self.src] = np.inf
            self._bw_lazy = None
        return self._bw_vec

    def _bw_rows(self, users: np.ndarray) -> np.ndarray:
        """Selected users' bandwidth rows — a gather-then-multiply under a
        pending lazy store (per-element IEEE ops identical to multiplying
        first and gathering after), a plain row gather otherwise."""
        lz = self._bw_lazy
        if lz is None:
            return self._bw_vec[users]
        sc, fac = lz
        out = sc[users][:, None] * fac[users]
        out[:, self.src] = np.inf
        return out

    def _bw_cols(self):
        """Whole-store column view for ``eval_config_users`` (it touches
        only ``bwv[:, n]`` / ``len``): the dense array, or a zero-copy
        column materializer over the lazy (scale, factors) pair."""
        lz = self._bw_lazy
        if lz is None:
            return self._bw_vec
        return _LazyBwCols(lz[0], lz[1], self.src)

    def _refresh_states(self, users: np.ndarray) -> None:
        """Flush deferred requantizations (lazy ingest) for these users."""
        sel = users[self._stale[users]]
        if len(sel):
            t0 = time.perf_counter() if self._timing else 0.0
            self._requant_users(sel, self._bw_rows(sel))
            self._stale[sel] = False
            if self._timing:
                self.stats.t_ingest_ms += (time.perf_counter() - t0) * 1e3

    def _quant(self) -> QuantConsts:
        """The fused requantizer's constants bundle — snapshots the proto
        packs, so compute-slice repricings must drop it (they rebuild the
        packs); backhaul repricings are bandwidth-only and keep it."""
        c = self._quant_consts
        if c is None:
            p = self._proto
            c = self._quant_consts = QuantConsts(
                bits_pack=p._bits_pack, C_pack=p._C_pack,
                mask_pack=p._mask_pack, load_pack=p._load_pack,
                modes=tuple(p._modes), gamma=self.gamma,
                delta=self.req.delta)
        return c

    def _requant_users(self, users: np.ndarray,
                       vec: np.ndarray) -> np.ndarray:
        """Fused requantize of the given users' bandwidth rows: ONE
        quantize->int16->signature launch (``kernels/ee_gate``,
        elementwise identical to ``plan.update_uplinks`` + the signature
        encode), compared against a gather from the per-state signature
        table — users whose encoding moved re-key through
        ``_assign_states`` with the fresh rows, everyone else costs one
        int16 row compare.  With the ``device`` ingest the rows go to the
        device once, the compare runs there, and only the changed flags
        and the changed rows come back."""
        c = self._quant()
        if self._ingest_backend == "numpy":
            enc = quant_signature(vec, c, backend="numpy")
            old = self._stq_enc[self._user_state[users]]
            changed = (enc != old).any(axis=1)
            if changed.any():
                self._assign_states(users[changed], enc=enc[changed])
        else:
            enc_t = quant_signature(self._to_dev(vec), c, backend="device")
            old_t = self._enc_table()[self._to_dev(self._user_state[users])]
            ch_t = (enc_t != old_t).any(dim=1)
            changed = self._to_host(ch_t)
            if changed.any():
                self._assign_states(users[changed],
                                    enc=self._to_host(enc_t[ch_t]))
        self.stats.quant_changed += int(np.count_nonzero(changed))
        return changed

    def _signatures(self, vec: np.ndarray, c: QuantConsts) -> np.ndarray:
        """The fused ingest of host rows, as host int16 signature rows (the
        whole-cohort slice reprice and the tighten rounds, which key on
        the host)."""
        if self._ingest_backend == "numpy":
            return quant_signature(vec, c, backend="numpy")
        return self._to_host(quant_signature(self._to_dev(vec), c,
                                             backend="device"))

    # ---------------------------------------------------- device transfers
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the cohort's device (counted in ``h2d_bytes``)."""
        t = torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        if self.device.type != "cpu":
            self.h2d_bytes += t.numel() * t.element_size()
        return t

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A device tensor as a host array (counted in ``d2h_bytes``)."""
        if t.device.type != "cpu":
            self.d2h_bytes += t.numel() * t.element_size()
        return t.cpu().numpy()

    def _enc_table(self) -> torch.Tensor:
        """The signature table on the device: the host table's rows copied
        up once, the newborn ones at the next gather."""
        n = len(self._states)
        if self._enc_dev_rows < n:
            lo = self._enc_dev_rows
            if self._enc_dev.shape[0] < n:
                grown = torch.empty((len(self._stq_enc), self._enc_w),
                                    dtype=torch.int16, device=self.device)
                grown[:lo] = self._enc_dev[:lo]
                self._enc_dev = grown
            self._enc_dev[lo:n] = self._to_dev(self._stq_enc[lo:n])
            self._enc_dev_rows = n
        return self._enc_dev[:n]

    # ------------------------------------------------------------- failures
    def mask_node(self, n: int, users: Optional[Sequence[int]] = None
                  ) -> "Population":
        """Node failure for ``users`` (default: the whole cohort) — same
        semantics as ``Plan.mask_node`` per user."""
        if n == self.src:
            raise ValueError("cannot mask the source-hosting node")
        sel = (np.arange(self.U) if users is None
               else np.asarray(users, dtype=np.int64))
        flip = sel[~self._masked[sel, n]]
        if len(flip):
            self._masked[flip, n] = True
            self._mask_count += len(flip)
            self._assign_states(flip)
        return self

    def unmask_node(self, n: int, users: Optional[Sequence[int]] = None
                    ) -> "Population":
        sel = (np.arange(self.U) if users is None
               else np.asarray(users, dtype=np.int64))
        flip = sel[self._masked[sel, n]]
        if len(flip):
            self._masked[flip, n] = False
            self._mask_count -= len(flip)
            self._assign_states(flip)
        return self

    def update_slice(self, frac: Union[float, np.ndarray]) -> "Population":
        """Cohort-wide compute-slice rescale (``Plan.update_slice`` with
        ``nodes=None`` for every user).  ``frac`` is a scalar or an (N,)
        per-node factor vector (congestion pricing rescales individual
        nodes); either way it applies to every user of the cohort —
        per-user slices would break the cohort's shared energy tensors,
        so model those as separate cohorts.
        """
        self._proto.update_slice(frac)
        t0 = time.perf_counter() if self._timing else 0.0
        # the proto rebuilt its packs and base tensors in place or replaced
        # them; every cached cohort state quantized against the old compute
        # terms is now stale (incl. fast tables), the memoized exact
        # energies moved with the compute terms, and the fallback plan's
        # compute base as well.  Capture the pre-slice signatures first —
        # the quant_changed counter compares against them, and the table
        # (their backing store) is about to clear.
        old_enc = self._stq_enc[self._user_state]
        self._states = []
        self._state_ids = {}
        self._pinned = set()
        self._cfg_energy = {}
        self._fallback_plan = None
        self._quant_consts = None
        self._tighten_cache = {}
        self._tighten_base = {}
        self._stq_enc = np.empty((0, self._enc_w), dtype=np.int16)
        self._enc_dev_rows = 0
        # requantize every user against the new compute terms in one fused
        # launch and re-key everyone — the stored bandwidths were already
        # screened, so this must not look like a telemetry tick
        # (quarantine/stuck state and counters stay untouched)
        enc = self._signatures(self._bw_dense(), self._quant())
        self.stats.ingests += 1
        self.stats.uplink_updates += self.U
        self.stats.quant_changed += \
            int(np.count_nonzero((enc != old_enc).any(axis=1)))
        self._assign_states(np.arange(self.U), enc=enc)
        self._stale[:] = False
        if self._timing:
            self.stats.t_ingest_ms += (time.perf_counter() - t0) * 1e3
        return self

    def update_backhaul(self, scale: Union[float, np.ndarray]
                        ) -> "Population":
        """Cohort-wide backhaul rescale (``Plan.update_backhaul`` for every
        user): non-source links serve ``bw_base * scale`` — the congestion
        pricing delta for shared links.

        The packed uplink requantizer constants are bandwidth-independent,
        so every user's quantized pack keeps its value verbatim — and
        therefore so does the whole (pack, mask) partition: the cohort
        states are rebuilt IN PLACE (fresh steepness/init tensors against
        the repriced base; DP grids, candidate caches and fast tables
        dropped) with their ids, signature keys, user assignment and
        pinned set all preserved.  No per-user pass at all — link
        repricing costs O(states), not O(users), which is what keeps the
        congestion fixed-point loop cheap at population scale.  The
        memoized exact energies survive too — Eq. (2) has no bandwidth
        term.
        """
        self._proto.update_backhaul(scale)
        if self._states:
            steep, grid = self._state_tensors(
                np.stack([s.stq for s in self._states]),
                np.stack([s.mask for s in self._states]))
            for i, s in enumerate(self._states):
                s.steep, s.grid = steep[i], grid[i]
                s.dps = None
                s.cand = {}
                s.fast = None
        self._fallback_plan = None
        # tighten states quantize the repriced non-source links too
        self._tighten_cache = {}
        self._tighten_base = {}
        return self

    # ------------------------------------------------------- state registry
    def _assign_states(self, users: np.ndarray,
                       enc: Optional[np.ndarray] = None) -> None:
        """(Re)key the given users' (quantized pack, mask) signatures into
        cohort states, materializing states never seen before — touching
        ONLY the given rows and merging into the existing table (the
        stale-subset re-key; callers pass exactly the users whose
        signature may have moved).

        ``enc`` is the users' freshly-quantized (Us, M*K2*N) int16 pack
        encoding (the fused ingest kernel's output, on the host); None
        re-keys the users' CURRENT packs (mask flips), read back from the
        per-state signature table — per-user packs are never stored, a
        user's pack always equals their state's.  The keys are deduped
        with ``np.unique`` over the rows' bytes, so newborn states get ids
        in the reference's order; their device tensors are built in one
        batch."""
        Us = len(users)
        if Us == 0:
            return
        old_sids = self._user_state[users]       # bounded-resume hints
        if enc is None:
            enc = self._stq_enc[old_sids]
        W = self._enc_w
        rows = np.empty((Us, W + self.N), dtype=np.int16)
        rows[:, :W] = enc
        rows[:, W:] = self._masked[users]
        v = rows.view(np.dtype((np.void, rows.shape[1] * 2))).ravel()
        K2 = 2 * self.L - 1
        if Us > 1 and bool((v == v[0]).all()):
            # one signature for the whole batch (cold start, uniform
            # scale moves): skip the million-row unique/argsort entirely
            first, inv = np.zeros(1, dtype=np.int64), None
        else:
            _uniq, first, inv = np.unique(v, return_index=True,
                                          return_inverse=True)
        sids = np.empty(len(first), dtype=np.int64)
        born = []
        for i, j in enumerate(first):
            j = int(j)
            key = v[j].tobytes()
            sid = self._state_ids.get(key)
            if sid is None:
                sid = len(self._states) + len(born)
                born.append((key,
                             _dec_int16(enc[j]).reshape(self.M, K2, self.N),
                             self._masked[int(users[j])].copy(),
                             int(old_sids[j])))
            sids[i] = sid
        self._add_states(born)
        self._user_state[users] = sids[0] if inv is None else sids[inv]
        if len(self._states) > self.max_states:
            self._compact_states()

    def _state_key(self, stq: np.ndarray, mask: np.ndarray) -> bytes:
        """The scalar form of ``_assign_states``'s signature encoding —
        byte-identical to the batched path, so an out-of-band caller (the
        contingency prebuilder) can probe/register states a user would be
        keyed into without a user actually holding that (pack, mask)."""
        M, K2, N = self.M, 2 * self.L - 1, self.N
        enc = np.empty(M * K2 * N + N, dtype=np.int16)
        q = np.ascontiguousarray(stq).reshape(-1)
        fin = np.isfinite(q)
        np.copyto(enc[:M * K2 * N], q, casting="unsafe", where=fin)
        enc[:M * K2 * N][~fin] = -1
        enc[M * K2 * N:] = mask
        return enc.tobytes()

    def _state_tensors(self, stq: np.ndarray, mask: np.ndarray,
                       base_steep: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device DP input tensors of a batch of states, ``stq`` (S, M, 2L-1,
        N) and ``mask`` (S, N) on the host: scatter each pack's source-node
        rows/cols into a copy of the base steepness stack and rebuild the
        init grid — the exact formulas of ``Plan._apply_qpack``, with
        ``Plan._quant_state``'s failure masking folded in (values are only
        copied, so they are bit-equal to the reference's).  Returns (steep
        (S, M, L-1, N, N), grid (S, M, N, G+1)).  (Also the
        backhaul-repricing rebuild: the base stack moved, the packs did
        not.)  ``base_steep`` swaps in a different-width base — the tighten
        fallback passes a single-mode delta_eff stack whose pack carries
        only the main quantizer."""
        proto = self._proto
        L, G, src = self.L, self.gamma, self.src
        S = stq.shape[0]
        base = proto._steep if base_steep is None else base_steep
        steep = base[None].expand((S,) + tuple(base.shape)).clone()
        q = self._to_dev(stq)
        steep[:, :, :, src, :] = q[:, :, :L - 1]
        steep[:, :, :, :, src] = q[:, :, L:]
        d = q[:, :, L - 1, :]                        # (S, M, N) init depths
        g = torch.arange(G + 1, dtype=d.dtype, device=d.device)
        hit = ((torch.isfinite(d) & (d <= G))[..., None]
               & (d[..., None] == g))
        grid = torch.where(hit, proto._ext.init_E[:, None], float("inf"))
        if mask.any():
            m = self._to_dev(mask)
            steep.masked_fill_(m[:, None, None, :, None]
                               | m[:, None, None, None, :], float("inf"))
            grid.masked_fill_(m[:, None, :, None], float("inf"))
        return steep, grid

    def _enc_push(self, enc_rows: np.ndarray) -> None:
        """Append the newest states' int16 signature rows to the
        amortized-growing ``_stq_enc`` table (valid rows =
        ``len(self._states)``)."""
        n = len(self._states)
        cap = len(self._stq_enc)
        if n > cap:
            grown = np.empty((max(16, 2 * cap, n), self._enc_w),
                             dtype=np.int16)
            grown[:cap] = self._stq_enc
            self._stq_enc = grown
        self._stq_enc[n - len(enc_rows):n] = enc_rows

    def _add_states(self, items: List[Tuple[bytes, np.ndarray, np.ndarray,
                                            int]]) -> List[int]:
        """Materialize cohort states from (key, stq, mask, parent) items,
        in order (see ``_state_tensors``; one batch of device tensors), and
        record their int16 signature rows.  Returns their ids."""
        if not items:
            return []
        steep, grid = self._state_tensors(np.stack([it[1] for it in items]),
                                          np.stack([it[2] for it in items]))
        sids = []
        for i, (key, stq, mask, parent) in enumerate(items):
            sid = len(self._states)
            self._states.append(_CohortState(stq, mask, steep[i], grid[i],
                                             parent=parent))
            self._state_ids[key] = sid
            sids.append(sid)
        self._enc_push(_enc_int16(np.stack([it[1] for it in items]))
                       .reshape(len(items), -1))
        return sids

    def _add_state(self, key: bytes, stq: np.ndarray,
                   mask: np.ndarray, parent: int = -1) -> int:
        """Materialize one cohort state (see ``_add_states``)."""
        return self._add_states([(key, stq, mask, parent)])[0]

    def _compact_states(self) -> None:
        """Drop cohort states no user references (bounds cache growth under
        adversarial churn; referenced states and their DP grids survive).
        Contingency-pinned states survive too — evicting a prebuilt state
        would silently turn its failover back into a relaxation."""
        live = np.unique(self._user_state)
        if self._pinned:
            live = np.unique(np.concatenate(
                [live, np.fromiter(self._pinned, dtype=np.int64)]))
        remap = {int(s): i for i, s in enumerate(live)}
        self._states = [self._states[int(s)] for s in live]
        self._stq_enc = self._stq_enc[live]
        self._enc_dev_rows = 0
        self._state_ids = {k: remap[s] for k, s in self._state_ids.items()
                           if s in remap}
        self._user_state = np.searchsorted(live, self._user_state)
        self._pinned = {remap[s] for s in self._pinned if s in remap}
        self.stats.state_evictions += 1

    # ------------------------------------------------------------ relaxation
    def _relax_states(self, sids: Sequence[int], *,
                      prebuilt: bool = False) -> None:
        """Chained banded relaxation of the given (unrelaxed) cohort states.

        Newborns split three ways: states whose validated parent hint
        proves a layer-prefix match resume from the parent's saved grid
        slice (bounded re-relaxation); pure-mask deltas on nodes the
        parent never reached share the parent's relaxed grids outright;
        the rest ride the full chain — ONE fused launch of kernel B1 when
        the whole stack fits the chunk budget (``relax_chunk_rows`` on the
        CPU, ``device_chunk_rows`` on CUDA), the chunked fallback when it
        does not.  ``prebuilt`` routes the counter to
        ``stats.prebuilt_states`` (contingency refills relax off the
        failure tick; a covered tick's ``dp_relaxes`` delta stays zero)."""
        states = [self._states[int(s)] for s in sids]
        if not states:
            return
        t0 = time.perf_counter()
        full: List[_CohortState] = []
        resume: Dict[int, List[Tuple[_CohortState, _CohortState]]] = {}
        if self._bounded:
            for s in states:
                hint = self._resume_hint(s)
                if hint is None:
                    full.append(s)
                    continue
                kind, parent, l0 = hint
                if kind == "share":
                    steep_h = self._to_host(s.steep)
                    s.dps = [_BandedArgDP(pd.hist, pd.par_n, steep_h[mi])
                             for mi, pd in enumerate(parent.dps)]
                    self.stats.mask_reuses += 1
                else:
                    resume.setdefault(l0, []).append((s, parent))
        else:
            full = states
        if full:
            self._relax_full(full)
        for l0 in sorted(resume):
            pairs = resume[l0]
            self._relax_resume(l0, pairs)
            self.stats.bounded_relaxes += len(pairs)
            self.stats.layers_skipped += l0 * len(pairs)
        if prebuilt:
            self.stats.prebuilt_states += len(states)
        else:
            self.stats.dp_relaxes += len(states)
        self._last_relax_s = time.perf_counter() - t0
        if self._timing:
            self.stats.t_relax_ms += self._last_relax_s * 1e3

    def _resume_hint(self, s: _CohortState
                     ) -> Optional[Tuple[str, _CohortState, int]]:
        """Validate a newborn's parent hint (see ``_CohortState.parent``).

        Returns None (full relax), ("share", parent, 0) when the parent's
        relaxed grids serve the state verbatim — a pure mask-add delta on
        nodes the parent's chain never reached (all-inf rows at every
        block, so no finite cell and no backtrack can touch them) — or
        ("resume", parent, l0) when layers < l0 are provably identical.
        The hint is re-validated against whatever state sits at the index
        NOW, so compaction/renumbering can only cost speed, not
        correctness; resumes are float64-engine-only (the f32 engines
        round intermediates in-chain, so a spliced prefix is not an
        identity there)."""
        p = s.parent
        if p < 0 or p >= len(self._states):
            return None
        parent = self._states[p]
        if parent is s or parent.dps is None:
            return None
        L = self.L
        if np.array_equal(s.stq, parent.stq):
            added = s.mask & ~parent.mask
            if not added.any() or (parent.mask & ~s.mask).any():
                return None
            for pd in parent.dps:
                if np.isfinite(pd.hist[:, added, :]).any():
                    return None
            return ("share", parent, 0)
        if self._engine != "banded" or self.backend == "mesh":
            return None
        if not np.array_equal(s.mask, parent.mask):
            return None
        # first affected relax layer: pack row r < L-1 scatters into the
        # layer-r source row, row r >= L into the layer-(r-L) source col;
        # a moved init-depth row (r == L-1) moves the layer-0 input, so
        # nothing can be skipped
        diff = (s.stq != parent.stq).any(axis=(0, 2))          # (2L-1,)
        l0 = L - 1
        for r in np.nonzero(diff)[0]:
            r = int(r)
            layer = 0 if r == L - 1 else (r if r < L - 1 else r - L)
            l0 = min(l0, layer)
        if l0 < 1:
            return None
        return ("resume", parent, l0)

    def _relax_full(self, states: List[_CohortState]) -> None:
        """Full-chain relaxation: one fused B1 launch across every state
        when the (D*M, L-1, N, N) stack fits the chunk budget, the chunked
        loop when it does not (on the CPU ``REPRO_RELAX_CHUNK_BYTES``
        shrinks the budget; tiny values force the fallback — see the
        chunking tests).  Each launch's results come to the host once."""
        Ms = [s.steep.shape[0] for s in states]   # per-state mode counts
        B = sum(Ms)                               # (tighten states carry 1)
        N, Gp1 = self.N, self.gamma + 1
        steep = torch.cat([s.steep for s in states])           # (B, ...)
        grid = torch.cat([s.grid for s in states])
        E_one = self._proto._ext.E
        lo = self.depth_window_lo
        chunk = self._relax_chunk()
        if self.backend == "mesh":
            # one B1 launch a shard, whole: the mesh spreads the stack
            rx = self._mesh()
            h0, d0 = rx.h2d_bytes, rx.d2h_bytes
            E = E_one[None].expand((B,) + tuple(E_one.shape))
            hist, par = rx.relax(grid, E, steep, lo)
            self.h2d_bytes += rx.h2d_bytes - h0
            self.d2h_bytes += rx.d2h_bytes - d0
            self.stats.fused_relaxes += 1
        elif B <= chunk:
            hist, par = self._relax_batch(grid, E_one, steep, lo)
            self.stats.fused_relaxes += 1
        else:
            hists, pars = [], []
            for start in range(0, B, chunk):
                sl = slice(start, start + chunk)
                h, p = self._relax_batch(grid[sl], E_one, steep[sl], lo)
                hists.append(h)
                pars.append(p)
            hist = np.concatenate(hists)
            par = np.concatenate(pars)
            self.stats.chunked_relaxes += 1
        steep_h = self._to_host(steep)
        off = 0
        for s, m in zip(states, Ms):
            s.dps = [_BandedArgDP(hist[off + mi], par[off + mi],
                                  steep_h[off + mi]) for mi in range(m)]
            off += m

    def _mesh(self):
        """The mesh backend's relaxer, over every visible card for a cohort
        on CUDA (every rank's, under ``torch.distributed``), or one logical
        CPU shard for a cohort on the CPU."""
        if self._mesh_relaxer is None:
            from ..sharding.population import MeshRelaxer, population_mesh
            self._mesh_relaxer = MeshRelaxer(population_mesh(
                device="cpu" if self.device.type == "cpu" else None))
        return self._mesh_relaxer

    def _relax_chunk(self) -> int:
        """Stack rows a relaxation launch takes: the reference's
        cache-residency budget on the CPU; on CUDA, the device budget of a
        launch's outputs (history plus parents)."""
        N, Gp1 = self.N, self.gamma + 1
        if self.device.type == "cuda":
            item = 8 if self._engine == "banded" else 4
            return device_chunk_rows(self.L * N * Gp1 * (item + 4))
        return relax_chunk_rows(N * N * Gp1 * 16)

    def _relax_batch(self, grid: torch.Tensor, E_one: torch.Tensor,
                     steep: torch.Tensor, lo: Optional[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One B1 launch over stacked rows (``E_one`` is the cohort's one
        (L-1, N, N) energy stack, broadcast over them); (hist float64, par
        int32) on the host."""
        E = E_one[None].expand((len(grid),) + tuple(E_one.shape))
        if self._engine == "banded":
            hist, par = batched_banded_relax_minarg(grid, E, steep, lo)
        else:
            hist, par = batched_banded_relax_argmin(grid, E, steep, lo,
                                                    dtype=torch.float32)
        return (self._to_host(hist).astype(np.float64, copy=False),
                self._to_host(par))

    def _relax_resume(self, l0: int,
                      pairs: List[Tuple[_CohortState, _CohortState]]
                      ) -> None:
        """Bounded re-relaxation: seed a relax over layers ``l0:`` with the
        parents' saved block-``l0`` grid slices and splice the untouched
        hist/par prefixes back in.  Bit-exact vs the full chain because the
        depth-window masking is DEPTH-based, not layer-position-based
        (``bellman_ford._banded_gather_idx``), so the suffix relax applies
        exactly the ops the full chain would from block ``l0`` on."""
        M = self.M
        lo = self.depth_window_lo
        init = self._to_dev(np.stack([pr.dps[mi].hist[l0]
                                      for s, pr in pairs for mi in range(M)]))
        steep = torch.cat([s.steep[:, l0:] for s, _pr in pairs])
        hist, par = self._relax_batch(init, self._proto._ext.E[l0:], steep,
                                      lo)
        steep_h = self._to_host(torch.stack([s.steep for s, _pr in pairs]))
        for i, (s, pr) in enumerate(pairs):
            dps = []
            for mi in range(M):
                pd = pr.dps[mi]
                h = np.concatenate([pd.hist[:l0], hist[i * M + mi]])
                pn = np.concatenate([pd.par_n[:l0], par[i * M + mi]])
                dps.append(_BandedArgDP(h, pn, steep_h[i, mi]))
            s.dps = dps

    # ------------------------------------------------------------- post-pass
    def _exit_candidates(self, state: _CohortState, mi: int, k: int):
        """Lazy energy-ordered candidates at exit ``k`` — the sequence of
        ``fin._iter_configs_at_exit``, cached on the cohort state so every
        user sharing the state shares one backtrack."""
        cache = state.cand.get((mi, k))
        if cache is None:
            cache = state.cand[(mi, k)] = _CandCache()
        i = 0
        while True:
            while i < len(cache.items):
                yield cache.items[i]
                i += 1
            if cache.exhausted:
                return
            self._extend_candidates(state, mi, k, cache)

    def _extend_candidates(self, state: _CohortState, mi: int, k: int,
                           cache: _CandCache) -> None:
        dp = state.dps[mi]
        block = self.profile.exits[k].block
        d = dp.dist[block]                        # (N, G+1, 1)
        if not cache.items:
            # fast path of _iter_configs_at_exit: cheapest state via argmin
            j0 = int(np.argmin(d))
            v0 = float(d.ravel()[j0])
            if not np.isfinite(v0):
                cache.exhausted = True
                return
            n0, g0, r0 = np.unravel_index(j0, d.shape)
            cfg = Config(placement=_backtrack(dp, block, int(n0), int(g0),
                                              int(r0)), final_exit=k)
            cache.items.append((cfg, v0))
            return
        if cache.order is None:
            order = np.argsort(d, axis=None, kind="stable")
            vals = d.ravel()[order]
            cache.order = (order, vals, int(np.searchsorted(vals, np.inf)))
        order, vals, n_finite = cache.order
        j = len(cache.items)
        if j >= n_finite:
            cache.exhausted = True
            return
        n_, g_, r_ = np.unravel_index(int(order[j]), d.shape)
        cfg = Config(placement=_backtrack(dp, block, int(n_), int(g_),
                                          int(r_)), final_exit=k)
        cache.items.append((cfg, float(vals[j])))

    def _candidate(self, state: _CohortState, mi: int, k: int,
                   j: int) -> Optional[Tuple[Config, float]]:
        """Indexed access into the shared per-state candidate frontier:
        the j-th energy-ordered candidate at exit ``k`` (lazily extended),
        or None when the exit's candidates are exhausted."""
        cache = state.cand.get((mi, k))
        if cache is None:
            cache = state.cand[(mi, k)] = _CandCache()
        while len(cache.items) <= j and not cache.exhausted:
            self._extend_candidates(state, mi, k, cache)
        return cache.items[j] if j < len(cache.items) else None

    def _eval_users_factory(self, bwv: np.ndarray):
        """Bind the cohort's shared tensors into a vectorized exact
        evaluator over the given (Us, N) per-user bandwidth rows."""
        prof, req = self.profile, self.req
        nodes = self.network0.nodes
        base_bw = self._proto._bw
        comp = self._proto._compute
        src = self.src
        chk = self.check_aggregate_load

        def ev(cfg: Config, idx: np.ndarray):
            return eval_config_users(prof, req, nodes, base_bw, comp, src,
                                     cfg, bwv[idx],
                                     check_aggregate_load=chk)
        return ev

    def _scan_state_group(self, state: _CohortState, bwv: np.ndarray):
        """``_solve_one``'s control flow vectorized over a whole user batch
        sharing one cohort state: the main-pass scan, the ceil rescue pass
        bounded by the main pass's per-user energies, and the rare
        no-feasible fallback — all (candidate, user) pairs scored as
        stacked arrays (``frontier.scan_state_users``), with per-user
        selections bit-identical to the scalar post-pass.

        Returns (cfgs, energy, lat, e_comp, e_comm, used_ceil, exit_, fb):
        per-user chosen Config references (shared candidate objects, None
        where nothing was found), their exact objective parts, the
        ceil-pass markers and per-user fallback Solutions (None except on
        the tighten path).
        """
        Us = len(bwv)
        adm = self._proto._admissible
        ev = self._eval_users_factory(bwv)
        s0 = scan_state_users(
            state.dps[0], self.profile, adm,
            lambda k, j: self._candidate(state, 0, k, j), ev, Us,
            dist_tol=self._dist_tol)
        cfgs: List[Optional[Config]] = [None] * Us
        fb: List[Optional[Solution]] = [None] * Us
        energy = s0.energy.copy()
        lat = s0.latency.copy()
        e_comp = s0.e_comp.copy()
        e_comm = s0.e_comm.copy()
        exit_ = s0.exit.copy()
        cand_ = s0.cand.copy()
        mi_ = np.zeros(Us, dtype=np.int64)
        used_ceil = np.zeros(Us, dtype=bool)
        fb_mask = ~s0.found & (self.max_tighten > 0)
        fb_idx = np.nonzero(fb_mask)[0]
        no_exit = not adm
        tb = None
        if len(fb_idx):
            # batched Plan.solve tighten loop (round 0 already failed via
            # the s0 scan above — bit-exact, same dp, same scan contract)
            tF = time.perf_counter() if self._timing else 0.0
            self.stats.fallbacks += len(fb_idx)
            if not no_exit:
                tb = self._tighten_batch(bwv[fb_idx], state)
            if self._timing:
                self.stats.t_post_fallback_ms += \
                    (time.perf_counter() - tF) * 1e3
        s1 = None
        if self.quantize != "ceil" and (len(fb_idx) < Us or tb is not None):
            # one ceil rescue scan for everyone: the non-fallback users
            # bounded by their main-pass energies (the old subset scan),
            # the fallback users bounded by their tighten energies —
            # exactly Plan.solve's ``_scan(dps[1], best)``
            bound = np.where(s0.found, s0.energy, np.nan)
            if tb is not None:
                bound[fb_idx] = np.where(tb.found, tb.energy, np.nan)
            s1 = scan_state_users(
                state.dps[1], self.profile, adm,
                lambda k, j: self._candidate(state, 1, k, j),
                ev, Us, dist_tol=self._dist_tol, bound_energy=bound)
            take = s1.found & (~s0.found | (s1.energy < energy)) & ~fb_mask
            t = np.nonzero(take)[0]
            exit_[t] = s1.exit[take]
            cand_[t] = s1.cand[take]
            mi_[t] = 1
            energy[t] = s1.energy[take]
            lat[t] = s1.latency[take]
            e_comp[t] = s1.e_comp[take]
            e_comm[t] = s1.e_comm[take]
            used_ceil[t] = True
        for i in np.nonzero(~fb_mask)[0]:
            if exit_[i] >= 0:
                cfgs[i] = self._candidate(state, int(mi_[i]), int(exit_[i]),
                                          int(cand_[i]))[0]
        if len(fb_idx):
            self._tighten_assemble(fb, fb_idx, tb, s1, state, no_exit)
        return cfgs, energy, lat, e_comp, e_comm, used_ceil, exit_, fb

    def _scan_state(self, state: _CohortState, mi: int, network: Network,
                    bound=None):
        return _best_feasible(
            network, self.profile, self.req, state.dps[mi],
            self._proto._admissible, self.check_aggregate_load,
            oracle=False, bound=bound, dist_tol=self._dist_tol,
            candidates=lambda k: self._exit_candidates(state, mi, k))

    def _user_network(self, bw_row: np.ndarray) -> Network:
        bw = self._proto._bw.copy()
        src = self.src
        bw[src, :] = bw_row
        bw[:, src] = bw_row
        bw[src, src] = np.inf
        return Network(nodes=list(self.network0.nodes), bandwidth=bw,
                       compute=self._proto._compute, source_node=src)

    def _fallback_solve(self, bw_row: np.ndarray,
                        mask: np.ndarray) -> Solution:
        """Exact rare-path solve (tighten loop / no-feasible round 0): one
        persistent warm Plan per cohort replays the user's (bandwidth,
        mask) state and runs the whole ``Plan.solve`` control flow, whose
        warm==cold invariant is property-tested.  Warm deltas on the kept
        plan cost microseconds where a fresh Plan build costs milliseconds
        — and users with no feasible placement hit this path every tick
        they stay dirty."""
        t0 = time.perf_counter() if self._timing else 0.0
        plan = self._fallback_plan
        if plan is None:
            plan = self._fallback_plan = Plan(
                self.network0, self.profile, self.req, gamma=self.gamma,
                lam=self.lam, quantize=self.quantize,
                max_tighten=self.max_tighten,
                tighten_factor=self.tighten_factor, n_best=1,
                backend=self._plan_backend,
                check_aggregate_load=self.check_aggregate_load,
                device=self.device)
        plan.update_uplink(bw_row)
        have = plan._masked.copy()
        for n in np.nonzero(mask & ~have)[0]:
            plan.mask_node(int(n))
        for n in np.nonzero(have & ~mask)[0]:
            plan.unmask_node(int(n))
        self.stats.fallbacks += 1
        sol = plan.solve()
        if self._timing:
            self.stats.t_post_fallback_ms += \
                (time.perf_counter() - t0) * 1e3
        return sol

    def _tighten_consts(self, delta_eff: float) -> QuantConsts:
        """Single-mode constants bundle for one tighten round: the same
        bandwidth-independent packs as the base requantizer, quantized
        against ``delta_eff`` with only the main quantizer mode."""
        base = self._quant()
        return QuantConsts(bits_pack=base.bits_pack, C_pack=base.C_pack,
                           mask_pack=base.mask_pack,
                           load_pack=base.load_pack,
                           modes=(self.quantize,), gamma=self.gamma,
                           delta=float(delta_eff))

    def _tighten_state(self, round_: int, enc_row: np.ndarray,
                       mask: np.ndarray, delta_eff: float) -> _CohortState:
        """A (relaxable) single-mode cohort state for one tighten cell:
        non-source steepness from a per-round ``build_feasible_graph`` at
        ``delta_eff`` (shared by every user — those links' bandwidths are
        cohort-wide), source rows/cols and init depths scattered from the
        user pack, exactly ``Plan._feasible``'s tensors.  Cached by
        (round, signature, mask) OUTSIDE the main state table — a
        tightened signature must never collide with a base-delta key."""
        key = (round_, enc_row.tobytes(), mask.tobytes())
        st = self._tighten_cache.get(key)
        if st is not None:
            return st
        base = self._tighten_base.get(round_)
        if base is None:
            self._proto._flush_ext()
            fg = build_feasible_graph(self._proto._ext, self.gamma,
                                      lam=self.lam, quantize=self.quantize,
                                      delta_eff=delta_eff)
            base = self._tighten_base[round_] = fg.steep[None].clone()
        stq = _dec_int16(enc_row).reshape(1, 2 * self.L - 1, self.N)
        steep, grid = self._state_tensors(stq[None], mask[None],
                                          base_steep=base)
        st = _CohortState(stq, mask, steep[0], grid[0])
        if len(self._tighten_cache) >= 8192:   # adversarial-churn bound
            self._tighten_cache.clear()
        self._tighten_cache[key] = st
        return st

    def _tighten_batch(self, bwv_fb: np.ndarray,
                       state: _CohortState) -> "_TightenResult":
        """``Plan.solve``'s tighten loop batched over every no-feasible
        user of one cohort state.  Per round: ONE fused requantize of the
        still-unsolved rows at the round's ``delta_eff``, dedupe into
        tighten cells, ONE fused relaxation of the unseen cells, and one
        vectorized scan per cell — per-user results bit-exact vs the
        scalar per-user ``Plan.solve`` replay (rounds are per-user
        independent, the dp for a signature is unique, and the scan is
        ``frontier.scan_state_users``).  Steady-state churn revisits the same
        cells, so the cache turns the whole herd into pure scans."""
        F = len(bwv_fb)
        res = _TightenResult(F, self.max_tighten)
        adm = self._proto._admissible
        alive = np.arange(F)
        delta_eff = self.req.delta
        for r in range(1, self.max_tighten + 1):
            delta_eff *= self.tighten_factor    # Plan's own accumulation
            if not len(alive):
                break
            enc = np.ascontiguousarray(self._signatures(
                bwv_fb[alive], self._tighten_consts(delta_eff)))
            v = enc.view(np.dtype((np.void,
                                   enc.shape[1] * enc.dtype.itemsize)))
            _uniq, inv = np.unique(v.ravel(), return_inverse=True)
            groups = [np.nonzero(inv == g)[0] for g in range(len(_uniq))]
            sts = [self._tighten_state(r, enc[g[0]], state.mask, delta_eff)
                   for g in groups]
            fresh = [st for st in sts if st.dps is None]
            if fresh:
                self._relax_full(fresh)
            still = []
            for st, g in zip(sts, groups):
                members = alive[g]
                sc = scan_state_users(
                    st.dps[0], self.profile, adm,
                    lambda k, j, st=st: self._candidate(st, 0, k, j),
                    self._eval_users_factory(bwv_fb[members]), len(members),
                    dist_tol=self._dist_tol)
                hit = sc.found
                hu = members[hit]
                res.found[hu] = True
                res.energy[hu] = sc.energy[hit]
                res.latency[hu] = sc.latency[hit]
                res.e_comp[hu] = sc.e_comp[hit]
                res.e_comm[hu] = sc.e_comm[hit]
                res.exit[hu] = sc.exit[hit]
                res.rounds[hu] = r
                res.delta_eff[hu] = delta_eff
                for p, k, c in zip(hu, sc.exit[hit], sc.cand[hit]):
                    res.cfgs[p] = self._candidate(st, 0, int(k),
                                                  int(c))[0]
                still.append(members[~hit])
            alive = (np.concatenate(still) if still
                     else np.empty(0, dtype=np.int64))
        if len(alive):
            # Plan multiplies once more after the last failed round; the
            # ceil rescue (if it lands) reports that final delta_eff
            res.delta_eff[alive] = delta_eff * self.tighten_factor
        return res

    def _tighten_assemble(self, fb: List[Optional[Solution]],
                          fb_idx: np.ndarray,
                          tb: Optional["_TightenResult"], s1,
                          state: _CohortState, no_exit: bool) -> None:
        """Fold the batched tighten results and the shared ceil-rescue
        scan into per-user ``Solution``s shaped like ``Plan.solve``'s
        (config/eval bit-identical; meta carries the same tighten_rounds /
        delta_eff / used_ceil_pass bookkeeping)."""
        base_meta = {"gamma": self.gamma, "quantize": self.quantize,
                     "backend": self._plan_backend, "warm": True,
                     "population": True}
        if no_exit:
            m = {**base_meta, "tighten_rounds": 0,
                 "reason": "no exit meets alpha (3c)"}
            for i in fb_idx:
                fb[i] = Solution(config=None, eval=None, solve_time=0.0,
                                 solver="fin", meta=m)
            return
        sigma = self.req.sigma
        for p, i in enumerate(fb_idx):
            meta = {**base_meta, "tighten_rounds": int(tb.rounds[p])}
            ceil_take = (s1 is not None and s1.found[i]
                         and (not tb.found[p]
                              or s1.energy[i] < tb.energy[p]))
            if ceil_take:
                k = int(s1.exit[i])
                cfg = self._candidate(state, 1, k, int(s1.cand[i]))[0]
                ev = ConfigEval(energy=float(s1.energy[i]),
                                energy_comp=float(s1.e_comp[i]),
                                energy_comm=float(s1.e_comm[i]),
                                latency=float(s1.latency[i]),
                                accuracy=self.profile.accuracy_of(k),
                                feasible=True, violations=[])
                meta["used_ceil_pass"] = True
            elif tb.found[p]:
                k = int(tb.exit[p])
                cfg = tb.cfgs[p]
                ev = ConfigEval(energy=float(tb.energy[p]),
                                energy_comp=float(tb.e_comp[p]),
                                energy_comm=float(tb.e_comm[p]),
                                latency=float(tb.latency[p]),
                                accuracy=self.profile.accuracy_of(k),
                                feasible=True, violations=[])
            else:
                fb[i] = Solution(config=None, eval=None, solve_time=0.0,
                                 solver="fin",
                                 meta={**meta,
                                       "reason": "no feasible path"})
                continue
            ev._energy_rate = sigma * ev.energy
            meta["delta_eff"] = float(tb.delta_eff[p])
            meta["n_feasible_states"] = 1
            fb[i] = Solution(config=cfg, eval=ev, solve_time=0.0,
                             solver="fin", meta=meta)

    def _solve_one(self, state: _CohortState, bw_row: np.ndarray
                   ) -> Tuple[Optional[Config], Optional[ConfigEval], dict]:
        """``Plan.solve``'s control flow against a shared cohort state and
        one user's true bandwidth (the exact post-pass input)."""
        meta = {"gamma": self.gamma, "quantize": self.quantize,
                "tighten_rounds": 0, "backend": self.backend,
                "warm": True, "population": True}
        if not self._proto._admissible:
            return None, None, {**meta, "reason": "no exit meets alpha (3c)"}
        network = self._user_network(bw_row)
        best = self._scan_state(state, 0, network)
        if best is None and self.max_tighten > 0:
            sol = self._fallback_solve(bw_row, state.mask)
            return sol.config, sol.eval, sol.meta
        if self.quantize != "ceil":
            alt = self._scan_state(state, 1, network, bound=best)
            if alt is not None and (best is None
                                    or alt[1].energy < best[1].energy):
                best = alt
                meta["used_ceil_pass"] = True
        if best is None:
            return None, None, {**meta, "reason": "no feasible path"}
        cfg, ev = best
        meta["delta_eff"] = self.req.delta
        meta["n_feasible_states"] = int(np.isfinite(ev.energy))
        return cfg, ev, meta

    # ----------------------------------------------------------------- solve
    def solve(self, users: Optional[np.ndarray] = None,
              build_solutions: bool = True) -> Optional[List[Solution]]:
        """Warm re-solve of the given users (default: whole cohort).

        Relaxes exactly the cohort states born since their last relax, then
        runs the exact post-pass once per unique (state, true-bandwidth)
        group — users with identical channel state share one solve.  With
        the default vectorized post-pass the unique groups of each cohort
        state are scored together as stacked arrays (``frontier.
        scan_state_users``) — per-user selections are bit-identical to the
        scalar per-group path (``vector_postpass=False``), which the
        ``always_resolve`` benchmarks keep as the same-machine oracle.
        Updates the incumbents in place; returns the per-user Solutions
        when ``build_solutions`` (pass False on million-user ticks to skip
        materializing U Python objects — the incumbent arrays carry the
        results either way).
        """
        return self.solve_finish(
            self.solve_begin(users, build_solutions=build_solutions))

    def attach_many(self, bps: Union[float, np.ndarray, None] = None,
                    users: Optional[np.ndarray] = None, *,
                    build_solutions: bool = False) -> "Population":
        """Bulk cold-start attach: land the given users' source-link
        bandwidths (scalar / (Us,) / (Us, N), like :meth:`ingest`; None
        keeps the base-topology uplink every user is born with) and build
        their signatures, cohort states, fast tables and incumbents in one
        grouped pass — signature hashing runs only over the rows whose
        encoding moved off the shared cold-start state, the newborn states
        relax in one fused launch, and the incumbents land through the
        shared fast tables with no per-user Python.  Defaults to
        ``build_solutions=False`` (the incumbent arrays carry the result;
        at 1e7 users materializing U Solution objects is the cold start).

        Returns ``self`` — ``Population(...).attach_many(rates)`` is the
        whole cold start.
        """
        users = (np.arange(self.U) if users is None
                 else np.asarray(users, dtype=np.int64))
        if bps is not None:
            self.ingest(bps, users=users, requant=False)
        self.solve(users, build_solutions=build_solutions)
        return self

    def solve_begin(self, users: Optional[np.ndarray] = None,
                    build_solutions: bool = True, *,
                    stream: bool = False) -> "_PendingSolve":
        """Phase 1 of a tick's solve: flush deferred requants, snapshot the
        (state, bandwidth) inputs, group identical rows and LAUNCH the
        newborn relaxation.  ``stream=True`` runs the relaxation on a
        background thread so the caller can overlap the NEXT tick's
        numpy-side ingest with this tick's in-flight relax (the streaming
        pipeline); the handle must be redeemed with :meth:`solve_finish`
        before any call that mutates cohort states (ingest with
        ``requant=False`` only touches the bandwidth store and is safe to
        overlap).  Results are bit-identical to :meth:`solve` — the
        post-pass reads this snapshot, not the live bandwidth."""
        t0 = time.perf_counter()
        users = (np.arange(self.U) if users is None
                 else np.asarray(users, dtype=np.int64))
        Us = len(users)
        pend = _PendingSolve(users, build_solutions, t0)
        if Us == 0:
            return pend
        self._refresh_states(users)
        self._last_relax_s = 0.0     # this tick's relax only (EWMA signal)
        sids = self._user_state[users]
        uniq_sids = np.unique(sids)
        need = [int(s) for s in uniq_sids if self._states[int(s)].dps is None]
        if need and stream:
            pend.future = self._executor().submit(self._relax_states, need)
        elif need:
            self._relax_states(need)
        self.stats.dp_cache_hits += Us - len(need)
        self.stats.solves += Us

        # unique (state, bandwidth) groups: identical inputs, one solve
        rows = np.empty((Us, 1 + self.N), dtype=np.float64)
        rows[:, 0] = sids
        rows[:, 1:] = self._bw_rows(users)
        v = np.ascontiguousarray(rows).view(
            np.dtype((np.void, rows.shape[1] * 8))).ravel()
        _, first, order, bounds = _group_runs(v)
        pend.sids = sids
        pend.first, pend.order, pend.bounds = first, order, bounds
        pend.bw = rows[:, 1:]            # the tick's bandwidth snapshot
        return pend

    def solve_finish(self, pend: "_PendingSolve"
                     ) -> Optional[List[Solution]]:
        """Phase 2: join the in-flight relaxation (if streaming) and run
        the exact post-pass against the snapshot taken at begin-time."""
        users = pend.users
        Us = len(users)
        if Us == 0:
            return [] if pend.build_solutions else None
        if pend.future is not None:
            pend.future.result()
            pend.future = None
        t1 = time.perf_counter()
        first, order, bounds = pend.first, pend.order, pend.bounds
        dt_share = (t1 - pend.t0) / Us

        if self._vector_postpass and self._proto._admissible:
            self._solve_vectorized(users, pend.sids, first, order, bounds,
                                   dt_share, pend.build_solutions, pend.bw)
        else:
            for g, j in enumerate(first):
                state = self._states[int(pend.sids[j])]
                cfg, ev, meta = self._solve_one(state, pend.bw[j])
                members = users[order[bounds[g]:bounds[g + 1]]]
                self._record_group(members, cfg, ev, meta, dt_share,
                                   pend.build_solutions)
        self.stats.unique_solves += len(first)
        if self._timing:
            self.stats.t_post_ms += (time.perf_counter() - t1) * 1e3
        return self.solutions(users) if pend.build_solutions else None

    def _executor(self):
        if self._relax_executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._relax_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pop-relax")
        return self._relax_executor

    def _build_fast(self, state: _CohortState) -> _FastTable:
        """Materialize the state's shared first-candidate decision (see
        :class:`_FastTable`): replay the scalar post-pass's control flow
        over the FIRST candidate of each (quantizer pass, admissible exit)
        using the bandwidth-independent exact energies — one exact
        evaluation per distinct configuration, memoized cohort-wide."""
        adm = self._proto._admissible
        prof = self.profile
        keys: List[Tuple] = []
        cfgs: List[Config] = []
        pos_of: Dict[Tuple, int] = {}

        def cand0(mi: int, k: int) -> Optional[int]:
            item = self._candidate(state, mi, k, 0)
            if item is None:
                return None
            cfg = item[0]
            key = (cfg.final_exit, tuple(cfg.placement))
            p = pos_of.get(key)
            if p is None:
                p = pos_of[key] = len(cfgs)
                keys.append(key)
                cfgs.append(cfg)
            return p

        def energy(p: int) -> Tuple[float, float, float]:
            ent = self._cfg_energy.get(keys[p])
            if ent is None:
                e, ec, em, _lat, _v = eval_config_users(
                    prof, self.req, self.network0.nodes, self._proto._bw,
                    self._proto._compute, self.src, cfgs[p],
                    self._bw_rows(np.arange(1)),
                    check_aggregate_load=self.check_aggregate_load)
                ent = self._cfg_energy[keys[p]] = (e, ec, em)
            return ent

        tol = self._dist_tol
        scan: List[Tuple[int, int, int]] = []
        found = None                    # (energy, mi, k, pos, ec, em)
        for k in adm:
            dmin = _exit_dmin(state.dps[0], prof.exits[k].block)
            if found is not None and dmin > found[0] * (1.0 + tol):
                continue
            p = cand0(0, k)
            if p is None:
                continue
            scan.append((0, k, p))
            e, ec, em = energy(p)
            if found is None or e < found[0]:
                found = (e, 0, k, p, ec, em)
        used_ceil = False
        if self.quantize != "ceil":
            bound = found[0] if found is not None else None
            alt = None
            for k in adm:
                dmin = _exit_dmin(state.dps[1], prof.exits[k].block)
                be = alt[0] if alt is not None else bound
                if be is not None and dmin > be * (1.0 + tol):
                    continue
                p = cand0(1, k)
                if p is None:
                    continue
                scan.append((1, k, p))
                e, ec, em = energy(p)
                if alt is None or e < alt[0]:
                    alt = (e, 1, k, p, ec, em)
            if alt is not None and (found is None or alt[0] < found[0]):
                found = alt
                used_ceil = True
        choice = None
        if found is not None:
            e, mi, k, p, ec, em = found
            choice = (mi, k, p, e, ec, em, used_ceil)
        state.fast = _FastTable(keys, cfgs, scan, choice)
        return state.fast

    def _solve_vectorized(self, users: np.ndarray, sids: np.ndarray,
                          first: np.ndarray, order: np.ndarray,
                          bounds: np.ndarray, dt_share: float,
                          build_solutions: bool,
                          bw: Optional[np.ndarray] = None) -> None:
        """Vectorized frontier post-pass over the unique (state, bandwidth)
        representatives.

        Fast path: the distinct first-candidate configurations of every
        touched state are evaluated ONCE each for ALL representatives as
        stacked feasibility arrays; a state whose scanned first candidates
        are feasible for every representative broadcasts its cached
        ``_FastTable`` choice (exact energies are bandwidth-independent, so
        the selection is shared).  States with any first-candidate
        violation fall back to the general per-state scan
        (``_scan_state_group``); both are bit-identical to the scalar
        per-group post-pass.
        """
        tA = time.perf_counter() if self._timing else 0.0
        reps = users[first]
        rep_sids = sids[first]
        uniq_s, _f, s_order, s_bounds = _group_runs(rep_sids)
        states = [self._states[int(s)] for s in uniq_s]
        tables = [st.fast if st.fast is not None else self._build_fast(st)
                  for st in states]

        # distinct scanned configs across states -> one stacked-feasibility
        # evaluation each, over exactly the representatives of the states
        # that reference the config (cohort states sharing a first
        # candidate share the evaluation; disjoint states do not pay for
        # each other's rows — unevaluated (row, rep) cells are never read)
        key2row: Dict[Tuple, int] = {}
        tasks: List[Config] = []
        task_rpos: List[List[np.ndarray]] = []
        for gi, ft in enumerate(tables):
            rpos = s_order[s_bounds[gi]:s_bounds[gi + 1]]
            for key, cfg in zip(ft.keys, ft.cfgs):
                r = key2row.get(key)
                if r is None:
                    r = key2row[key] = len(tasks)
                    tasks.append(cfg)
                    task_rpos.append([])
                task_rpos[r].append(rpos)
        bw_reps = self._bw_rows(reps) if bw is None else bw[first]
        nR = len(reps)
        violM = np.ones((len(tasks), nR), dtype=bool)
        latM = np.empty((len(tasks), nR))
        for r, cfg in enumerate(tasks):
            cols = (task_rpos[r][0] if len(task_rpos[r]) == 1
                    else np.unique(np.concatenate(task_rpos[r])))
            _e, _ec, _em, lat, viol = eval_config_users(
                self.profile, self.req, self.network0.nodes,
                self._proto._bw, self._proto._compute, self.src, cfg,
                bw_reps[cols], check_aggregate_load=self.check_aggregate_load)
            violM[r, cols] = viol
            latM[r, cols] = lat
        if self._timing:
            # shared-table machinery: fast-table builds + the stacked
            # first-candidate feasibility evaluations
            self.stats.t_post_fast_ms += (time.perf_counter() - tA) * 1e3

        base_meta = {"gamma": self.gamma, "quantize": self.quantize,
                     "tighten_rounds": 0, "backend": self.backend,
                     "warm": True, "population": True}
        fast_meta = {**base_meta, "delta_eff": self.req.delta,
                     "n_feasible_states": 1}
        for gi, (state, ft) in enumerate(zip(states, tables)):
            rpos = s_order[s_bounds[gi]:s_bounds[gi + 1]]
            ids = [key2row[k] for k in ft.keys]
            scan_rows = sorted({ids[p] for _mi, _k, p in ft.scan})
            ok = (not scan_rows
                  or not violM[np.ix_(scan_rows, rpos)].any())
            if ok and ft.choice is not None:
                mi, k, p, e, ec, em, used_ceil = ft.choice
                cfg = ft.cfgs[p]
                self.stats.fastpath_states += 1
                if not build_solutions:
                    members = (users[order[bounds[rpos[0]]:
                                           bounds[rpos[0] + 1]]]
                               if len(rpos) == 1 else
                               np.concatenate(
                                   [users[order[bounds[rp]:bounds[rp + 1]]]
                                    for rp in rpos]))
                    self._record_fast(members, cfg, e)
                    continue
                row = ids[p]
                meta = ({**fast_meta, "used_ceil_pass": True} if used_ceil
                        else dict(fast_meta))
                acc = self.profile.accuracy_of(k)
                for rp in rpos:
                    members = users[order[bounds[rp]:bounds[rp + 1]]]
                    ev = ConfigEval(energy=e, energy_comp=ec,
                                    energy_comm=em,
                                    latency=float(latM[row, rp]),
                                    accuracy=acc, feasible=True,
                                    violations=[])
                    ev._energy_rate = self.req.sigma * e
                    self._record_group(members, cfg, ev, meta, dt_share,
                                       True)
                continue
            if ok and ft.choice is None:
                # no DP candidates at any admissible exit: the tighten
                # fallback (or a no-feasible-path record), per the scalar
                # control flow
                for rp in rpos:
                    members = users[order[bounds[rp]:bounds[rp + 1]]]
                    if self.max_tighten > 0:
                        sol = self._fallback_solve(bw_reps[rp], state.mask)
                        self._record_group(members, sol.config, sol.eval,
                                           sol.meta, dt_share,
                                           build_solutions)
                    else:
                        meta = {**base_meta, "reason": "no feasible path"}
                        self._record_group(members, None, None, meta,
                                           dt_share, build_solutions)
                continue
            # general path: full vectorized scan for this state's reps
            tS = time.perf_counter() if self._timing else 0.0
            cfgs, energy, lat, e_comp, e_comm, used_ceil_a, exit_, fb = \
                self._scan_state_group(state, bw_reps[rpos])
            if self._timing:
                self.stats.t_post_scan_ms += \
                    (time.perf_counter() - tS) * 1e3
            for pi, rp in enumerate(rpos):
                members = users[order[bounds[rp]:bounds[rp + 1]]]
                if fb[pi] is not None:
                    sol = fb[pi]
                    self._record_group(members, sol.config, sol.eval,
                                       sol.meta, dt_share, build_solutions)
                    continue
                cfg = cfgs[pi]
                if cfg is None:
                    meta = {**base_meta, "reason": "no feasible path"}
                    self._record_group(members, None, None, meta, dt_share,
                                       build_solutions)
                    continue
                if build_solutions:
                    ev = ConfigEval(
                        energy=float(energy[pi]),
                        energy_comp=float(e_comp[pi]),
                        energy_comm=float(e_comm[pi]),
                        latency=float(lat[pi]),
                        accuracy=self.profile.accuracy_of(int(exit_[pi])),
                        feasible=True, violations=[])
                    ev._energy_rate = self.req.sigma * ev.energy
                    meta = {**base_meta, "delta_eff": self.req.delta,
                            "n_feasible_states": 1}
                    if used_ceil_a[pi]:
                        meta["used_ceil_pass"] = True
                    self._record_group(members, cfg, ev, meta, dt_share,
                                       True)
                else:
                    self._record_fast(members, cfg, float(energy[pi]))

    def _note_incumbent(self, members: np.ndarray,
                        cfg: Optional[Config]) -> None:
        """Maintain the uniform-incumbent flag across a recording: a
        whole-cohort record (re)establishes uniformity, a partial record
        keeps it only when it installs the same configuration."""
        if cfg is None:
            if len(members) == self.U or self._inc_single is not None:
                self._inc_single = None
            return
        key = (cfg.final_exit, tuple(int(n) for n in cfg.placement))
        if len(members) == self.U:
            self._inc_single = key
        elif self._inc_single is not None and self._inc_single != key:
            self._inc_single = None

    def _record_fast(self, members: np.ndarray, cfg: Config,
                     energy: float) -> None:
        """Incumbent-arrays-only recording (build_solutions=False path)."""
        self._solved[members] = True
        nb = len(cfg.placement)
        self._inc_place[members, :nb] = cfg.placement
        self._inc_place[members, nb:] = -1
        self._inc_exit[members] = cfg.final_exit
        self._inc_energy[members] = energy
        if self._any_solutions:
            self._solutions[members] = None
        self._note_incumbent(members, cfg)

    def _record_group(self, members: np.ndarray, cfg: Optional[Config],
                      ev: Optional[ConfigEval], meta: dict, dt: float,
                      build_solutions: bool) -> None:
        self._solved[members] = True
        if cfg is None:
            self._inc_place[members] = -1
            self._inc_exit[members] = -1
            self._inc_energy[members] = np.inf
        else:
            nb = len(cfg.placement)
            self._inc_place[members, :nb] = cfg.placement
            self._inc_place[members, nb:] = -1
            self._inc_exit[members] = cfg.final_exit
            self._inc_energy[members] = ev.energy
        if build_solutions:
            self._solutions[members] = Solution(
                config=cfg, eval=ev, solve_time=dt, solver="fin",
                meta=meta)
            self._any_solutions = True
        elif self._any_solutions:
            self._solutions[members] = None
        self._note_incumbent(members, cfg)

    # -------------------------------------------------------------- frontier
    def frontiers(self, users: np.ndarray, *,
                  k_per_exit: Optional[int] = 4) -> List[ParetoFrontier]:
        """Per-user k-best Pareto frontiers (core/frontier.py).

        The candidate rows are the per-cohort-state energy-ordered
        backtracks (shared across every user in a state — one backtrack
        per candidate for the whole cohort), exact-evaluated against each
        user's true bandwidth as stacked arrays and dominance-pruned per
        user (latency feasibility is per-user, so so is the frontier).
        Each frontier's ``argmin`` row is exactly the user's
        ``Population.solve`` selection — the orchestrator's frontier
        policy degrades to the argmin policy row by row.
        """
        users = np.asarray(users, dtype=np.int64)
        Us = len(users)
        out: List[Optional[ParetoFrontier]] = [None] * Us
        if Us == 0:
            return []
        if not self._proto._admissible:
            return [ParetoFrontier([], None) for _ in range(Us)]
        self._refresh_states(users)
        sids = self._user_state[users]
        need = [int(s) for s in np.unique(sids)
                if self._states[int(s)].dps is None]
        self._relax_states(need)
        self.stats.solves += Us
        uniq_s, _f, s_order, s_bounds = _group_runs(sids)
        sigma = self.req.sigma
        for gi in range(len(uniq_s)):
            pos = s_order[s_bounds[gi]:s_bounds[gi + 1]]
            state = self._states[int(uniq_s[gi])]
            bwv = self._bw_rows(users[pos])
            cfgs, energy, lat, e_comp, e_comm, _used_ceil, exit_, fb = \
                self._scan_state_group(state, bwv)
            # candidate rows in the solver's scan order (exit asc, quantizer
            # pass asc, graph-energy asc) — identical to Plan.frontier's
            items: List[Config] = []
            for k in self._proto._admissible:
                for mi in range(self.M):
                    j = 0
                    while k_per_exit is None or j < k_per_exit:
                        it = self._candidate(state, mi, k, j)
                        if it is None:
                            break
                        items.append(it[0])
                        j += 1
            evals = [eval_config_users(
                self.profile, self.req, self.network0.nodes,
                self._proto._bw, self._proto._compute, self.src, cfg, bwv,
                check_aggregate_load=self.check_aggregate_load)
                for cfg in items]
            for pi, p_ in enumerate(pos):
                if fb[pi] is not None:
                    sol = fb[pi]
                    am = (sol.config, sol.eval) if sol.feasible else None
                elif cfgs[pi] is not None:
                    ev0 = ConfigEval(
                        energy=float(energy[pi]),
                        energy_comp=float(e_comp[pi]),
                        energy_comm=float(e_comm[pi]),
                        latency=float(lat[pi]),
                        accuracy=self.profile.accuracy_of(int(exit_[pi])),
                        feasible=True, violations=[])
                    ev0._energy_rate = sigma * ev0.energy
                    am = (cfgs[pi], ev0)
                else:
                    am = None
                pairs = []
                for cfg, (e, ec, em, latr, violr) in zip(items, evals):
                    if violr[pi]:
                        continue
                    evr = ConfigEval(
                        energy=e, energy_comp=ec, energy_comm=em,
                        latency=float(latr[pi]),
                        accuracy=self.profile.accuracy_of(cfg.final_exit),
                        feasible=True, violations=[])
                    evr._energy_rate = sigma * e
                    pairs.append((cfg, evr))
                out[p_] = frontier_from_rows(pairs, am)
        return out

    def frontier(self, u: int, *,
                 k_per_exit: Optional[int] = 4) -> ParetoFrontier:
        """One user's Pareto frontier (see :meth:`frontiers`)."""
        return self.frontiers(np.array([int(u)]), k_per_exit=k_per_exit)[0]

    def set_incumbents(self, users: np.ndarray,
                       cfgs: Sequence[Optional[Config]],
                       energies: Sequence[float]) -> None:
        """Install externally chosen configurations as incumbents.

        The orchestrator's frontier policy may keep a slightly-costlier
        frontier row (or the previous incumbent) when the energy delta
        does not pay for the migration; this records those choices so the
        next tick's hysteresis gate and migration accounting run against
        what is actually deployed."""
        users = np.asarray(users, dtype=np.int64)
        self._inc_single = None      # externally mixed incumbents
        for u, cfg, e in zip(users, cfgs, energies):
            self._solved[u] = True
            if cfg is None:
                self._inc_place[u] = -1
                self._inc_exit[u] = -1
                self._inc_energy[u] = np.inf
            else:
                nb = len(cfg.placement)
                self._inc_place[u, :nb] = cfg.placement
                self._inc_place[u, nb:] = -1
                self._inc_exit[u] = cfg.final_exit
                self._inc_energy[u] = float(e)
            self._solutions[int(u)] = None

    # ------------------------------------------------ incumbent re-evaluation
    def evaluate_incumbents(self, users: Optional[np.ndarray] = None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized ``Plan.evaluate(incumbent)`` across users.

        Returns (no_incumbent, feasible, energy) — ``feasible``/``energy``
        are meaningful where ``~no_incumbent``.  Users are grouped by
        incumbent configuration; each group evaluates as one vectorized
        pass whose per-user latency accumulation replays ``evaluate_config``
        term by term (bit-identical doubles), with the failure-bitmap
        dead-node check of ``Plan.evaluate`` applied first.

        ``users=None`` evaluates the whole cohort positionally — the dense
        hysteresis gate's hot path: the incumbent columns are read as
        views, the grouping key is radix-sorted int64 (one all-equal
        compare in the steady single-config state) and a single-group
        cohort reads the bandwidth store with zero per-user gathers.
        When the uniform-incumbent flag is set (every user solved with one
        configuration — the steady state at scale) even the grouping-key
        build is skipped: one stacked evaluation against the bandwidth
        store, results bit-identical to the single-group general path.
        """
        if users is None and self._inc_single is not None:
            k, place_t = self._inc_single
            place = list(place_t)
            cfg = Config(placement=place, final_exit=k)
            e_sc, _lat, viol = self._eval_config_users(
                cfg, self._bw_cols())
            feas = ~viol
            energy = np.full(self.U, e_sc)
            if self._mask_count > 0:
                dead = self._masked[:, place].any(axis=1)
                feas[dead] = False
                energy[dead] = np.inf
            return np.zeros(self.U, dtype=bool), feas, energy
        whole = users is None
        if whole:
            exit_all = self._inc_exit
            place_all = self._inc_place
            solved = self._solved
        else:
            users = np.asarray(users, dtype=np.int64)
            exit_all = self._inc_exit[users]
            place_all = self._inc_place[users]
            solved = self._solved[users]
        Us = len(exit_all)
        feas = np.zeros(Us, dtype=bool)
        energy = np.full(Us, np.inf)
        no_inc = ~solved | (exit_all < 0)
        any_no = bool(no_inc.any())
        if any_no and no_inc.all():
            return no_inc, feas, energy
        # pivot-majority fast path (dense gate at scale): sample the modal
        # incumbent, compare positionally (L+1 cheap int passes — no int64
        # key build, no radix sort), evaluate the pivot config ONCE over
        # the full bandwidth store and re-run only the disagreeing rows
        # through the grouped path below via a subset recursion.  Values
        # are elementwise identical to the grouped evaluation: per-user
        # terms never depend on the grouping, only on the (config, row).
        if whole and Us >= 4096:
            samp = np.arange(0, Us, max(1, Us // 31))
            srows = np.empty((len(samp), 1 + self.L), dtype=np.int32)
            srows[:, 0] = np.where(no_inc[samp], -2, exit_all[samp])
            srows[:, 1:] = place_all[samp]
            sv = np.ascontiguousarray(srows).view(
                np.dtype((np.void, srows.shape[1] * 4))).ravel()
            uniq, counts = np.unique(sv, return_counts=True)
            pj = int(samp[np.nonzero(sv == uniq[np.argmax(counts)])[0][0]])
            pk = int(exit_all[pj])
            if pk >= 0 and solved[pj]:
                pp = place_all[pj]
                neq = exit_all != pk
                for i in range(self.L):
                    neq |= place_all[:, i] != pp[i]
                neq |= no_inc
                idx = np.nonzero(neq)[0]
                if len(idx) * 8 <= Us:
                    nb = self.profile.exits[pk].block + 1
                    place = [int(n) for n in pp[:nb]]
                    cfg = Config(placement=place, final_exit=pk)
                    e_sc, _lat, viol = self._eval_config_users(
                        cfg, self._bw_cols())
                    feas = ~viol
                    energy = np.full(Us, e_sc)
                    if self._mask_count > 0:
                        dead = self._masked[:, place].any(axis=1)
                        feas[dead] = False
                        energy[dead] = np.inf
                    if len(idx):
                        _, sub_f, sub_e = self.evaluate_incumbents(idx)
                        feas[idx] = sub_f
                        energy[idx] = sub_e
                    return no_inc, feas, energy
        # group by incumbent configuration; an injective radix-sortable
        # int64 key (digits = shifted exit/placement columns, base N+2
        # covers the -1 padding) replaces the void-row lexsort whenever the
        # profile is narrow enough to fit — the wide-profile fallback keeps
        # the row view.  No-incumbent users collapse into one skipped
        # sentinel group instead of being filtered up front (saves the
        # index/gather round-trip on the common all-solved tick).
        if (self.L + 1) * int(self.N + 2).bit_length() < 63:
            key = exit_all.astype(np.int64) + 1
            for i in range(self.L):
                key *= self.N + 2
                key += place_all[:, i] + 1
            if any_no:
                key[no_inc] = -1
            _, first, order, bounds = _group_runs(key)
        else:
            rows = np.empty((Us, 1 + self.L), dtype=np.int32)
            rows[:, 0] = np.where(no_inc, -2, exit_all) if any_no \
                else exit_all
            rows[:, 1:] = place_all
            v = np.ascontiguousarray(rows).view(
                np.dtype((np.void, rows.shape[1] * 4))).ravel()
            _, first, order, bounds = _group_runs(v)
        any_mask = self._mask_count > 0
        single = len(first) == 1
        for g, j in enumerate(first):
            j = int(j)
            k = int(exit_all[j])
            if k < 0 or not solved[j]:
                continue                 # the no-incumbent sentinel group
            nb = self.profile.exits[k].block + 1
            place = [int(n) for n in place_all[j, :nb]]
            members = None if single else order[bounds[g]:bounds[g + 1]]
            cfg = Config(placement=place, final_exit=k)
            if members is None:
                gl = users if not whole else None
                bwv = (self._bw_cols() if gl is None
                       else self._bw_rows(gl))
            else:
                gl = users[members] if not whole else members
                bwv = self._bw_rows(gl)
            e_sc, lat, viol = self._eval_config_users(cfg, bwv)
            f = ~viol
            en = np.full(Us if members is None else len(members), e_sc)
            if any_mask:
                rows_m = (self._masked if gl is None
                          else self._masked[gl])
                dead = rows_m[:, place].any(axis=1)
                f[dead] = False
                en[dead] = np.inf
            if members is None:
                feas = f
                energy = en
            else:
                feas[members] = f
                energy[members] = en
        return no_inc, feas, energy

    # ---------------------------------------------------------- checkpointing
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Snapshot the full SoA + cohort-state-table state as a flat dict
        of arrays (the checkpoint leaf set — ``runtime/checkpoint.py``
        saves it verbatim).

        DP grids, candidate caches, fast tables and the exact-energy memo
        are NOT saved: they are deterministic functions of the saved
        (pack, mask) signatures and the proto tensors, so
        :meth:`restore_state` rebuilds them bit-exactly on demand.
        ``state_relaxed`` records WHICH states held relaxed grids so the
        restore re-relaxes exactly those — off-tick probes (contingency
        ``coverage``) and the next tick's ``dp_relaxes`` delta then behave
        identically to the uninterrupted run.
        """
        S = len(self._states)
        M, K2, N = self.M, 2 * self.L - 1, self.N
        pinned = np.zeros(S, dtype=bool)
        if self._pinned:
            pinned[list(self._pinned)] = True
        d = {
            "bw_vec": self._bw_dense().copy(),
            # a user's pack equals their state's stq (the table keys BY
            # pack), so the per-user qpack leaf is a signature-table
            # gather — byte-identical to the historical per-user encode,
            # keeping old and new checkpoints interchangeable
            "qpack": self._stq_enc[self._user_state].reshape(
                self.U, M, K2, N),
            "masked": self._masked.copy(),
            "stale": self._stale.copy(),
            "user_state": self._user_state.copy(),
            "solved": self._solved.copy(),
            "inc_place": self._inc_place.copy(),
            "inc_exit": self._inc_exit.copy(),
            "inc_energy": self._inc_energy.copy(),
            "user_ids": self.user_ids.copy(),
            "quarantined": self._quarantined.copy(),
            "stuck_count": self._stuck_count.copy(),
            "state_stq": (_enc_int16(np.stack([s.stq for s in self._states]))
                          if S else np.zeros((0, M, K2, N), dtype=np.int16)),
            "state_mask": (np.stack([s.mask for s in self._states])
                           if S else np.zeros((0, N), dtype=bool)),
            "state_relaxed": np.array([s.dps is not None
                                       for s in self._states], dtype=bool),
            "state_parent": np.array([s.parent for s in self._states],
                                     dtype=np.int64),
            "state_pinned": pinned,
        }
        if self._last_raw is not None:
            d["last_raw"] = self._last_raw.copy()
        return d

    def restore_state(self, d: Dict[str, np.ndarray]) -> "Population":
        """Restore a :meth:`state_dict` snapshot in place.

        The cohort must match the snapshot (same users and solver
        parameterization), and any structural deltas the snapshot was
        taken under (compute-slice / backhaul repricings — e.g. the
        congestion controller's composed price factors) must be re-applied
        BEFORE restoring, so the proto tensors the rebuilt states scatter
        into equal the snapshot-time ones.  The cohort-state table is
        rebuilt in saved order (state ids are preserved verbatim, so
        ``user_state`` and the pinned set stay valid) and the states that
        held relaxed DP grids are re-relaxed in one launch — bit-exact,
        because the grids are deterministic in (pack, mask, proto
        tensors).
        """
        ids = np.asarray(d["user_ids"], dtype=np.int64)
        if ids.shape != self.user_ids.shape or \
                not np.array_equal(ids, self.user_ids):
            raise ValueError("state_dict user_ids do not match this cohort "
                             f"({ids.shape} vs {self.user_ids.shape})")
        U, N = self.U, self.N
        bw = np.asarray(d["bw_vec"], dtype=np.float64)
        if bw.shape != (U, N):
            raise ValueError(f"bw_vec shape {bw.shape} != ({U}, {N})")
        qp_shape = (U, self.M, 2 * self.L - 1, self.N)
        qp = np.asarray(d["qpack"])
        if qp.shape != qp_shape:
            raise ValueError(f"qpack shape {qp.shape} != {qp_shape}")
        # (the values are redundant — user packs are rebuilt from the
        # saved state table + user_state below; the leaf stays in the
        # checkpoint format for compatibility and shape validation)
        self._bw_vec[:] = bw
        self._bw_lazy = None
        self._masked[:] = d["masked"]
        self._mask_count = int(np.count_nonzero(self._masked))
        self._stale[:] = d["stale"]
        self._solved[:] = d["solved"]
        self._inc_place[:] = d["inc_place"]
        self._inc_exit[:] = d["inc_exit"]
        self._inc_energy[:] = d["inc_energy"]
        self._quarantined[:] = d.get("quarantined", False)
        self._stuck_count[:] = d.get("stuck_count", 0)
        if self._last_raw is not None:
            self._last_raw[:] = d.get("last_raw", np.nan)
        self._solutions = np.full(U, None, dtype=object)
        self._any_solutions = False
        # rebuild the cohort-state table in saved order: every state keys
        # through the same scalar signature encoding, so probes against
        # the restored table return the snapshot-time ids
        self._states = []
        self._state_ids = {}
        self._pinned = set()
        self._cfg_energy = {}
        self._fallback_plan = None
        self._tighten_cache = {}
        self._tighten_base = {}
        self._stq_enc = np.empty((0, self._enc_w), dtype=np.int16)
        self._enc_dev_rows = 0
        stq_all = _dec_int16(np.asarray(d["state_stq"]))
        mask_all = np.asarray(d["state_mask"], dtype=bool)
        parent = np.asarray(d["state_parent"], dtype=np.int64)
        items, seen = [], {}
        for i in range(len(stq_all)):
            key = self._state_key(stq_all[i], mask_all[i])
            if key in seen:
                raise ValueError(f"duplicate cohort-state signature at "
                                 f"snapshot index {i} (first at "
                                 f"{seen[key]})")
            seen[key] = i
            items.append((key, stq_all[i].copy(), mask_all[i].copy(),
                          int(parent[i])))
        self._add_states(items)
        us = np.asarray(d["user_state"], dtype=np.int64)
        if len(us) != U or (len(self._states)
                            and us.max(initial=-1) >= len(self._states)):
            raise ValueError("user_state does not index the saved table")
        self._user_state[:] = us
        self._pinned = {int(s) for s in np.nonzero(
            np.asarray(d["state_pinned"], dtype=bool))[0]}
        relaxed = np.nonzero(np.asarray(d["state_relaxed"],
                                        dtype=bool))[0]
        if len(relaxed):
            self._relax_states([int(s) for s in relaxed], prebuilt=True)
        self._inc_single = self._recompute_inc_single()
        return self

    def _recompute_inc_single(self) -> Optional[Tuple]:
        """One O(U) scan re-deriving the uniform-incumbent flag (used on
        checkpoint restore, where the recording history is gone): set iff
        every user is solved with one identical (exit, placement)."""
        if not bool(self._solved.all()):
            return None
        k = int(self._inc_exit[0])
        if k < 0 or bool((self._inc_exit != k).any()):
            return None
        row0 = self._inc_place[0]
        if bool((self._inc_place != row0[None]).any()):
            return None
        nb = self.profile.exits[k].block + 1
        return (k, tuple(int(n) for n in row0[:nb]))

    def _eval_config_users(self, config: Config, bwv: np.ndarray
                           ) -> Tuple[float, np.ndarray, np.ndarray]:
        """Vectorized ``problem.evaluate_config``: one configuration, many
        users differing only in their source-link bandwidth vector.

        Returns (energy, latency (Us,), violated (Us,)) — the shared
        evaluator now lives in ``core/frontier.py`` (it also powers the
        vectorized frontier post-pass); every per-user result is
        bit-identical to ``evaluate_config`` on that user's mutated
        network.
        """
        e, _ec, _em, lat, viol = eval_config_users(
            self.profile, self.req, self.network0.nodes, self._proto._bw,
            self._proto._compute, self.src, config, bwv,
            check_aggregate_load=self.check_aggregate_load)
        return e, lat, viol
