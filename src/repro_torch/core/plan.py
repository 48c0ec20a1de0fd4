"""Persistent plan IR: incremental FIN re-solves for online churn.

Port of ``repro/core/plan.py``.  :class:`Plan` owns the built pipeline
state of one (network, profile, requirements) triple -- the stage-1
extended-graph tensors and the stage-2 quantized banded tensors of the main
and ceil-rescue quantizer passes, on the plan's device -- and exposes typed
deltas that recompute exactly the invalidated slice:

  ``update_uplink(bps)``   the uplink-dependent quantized slice: source-node
                           rows/cols of the steepness tensors and the init
                           vector, as ONE packed (2L-1, N) pipeline against
                           precomputed constants.  Energy tensors are
                           untouched (Eq. 2 has no bandwidth term); the
                           dense stage-1 latency rows refresh lazily.
  ``mask_node(n)``         row/col infinity masks for failures, applied to
                           the cached tensors without re-quantizing;
                           ``unmask_node`` restores the pristine state.
  ``update_slice(frac)``   recompute compute-dependent terms in place.
  ``update_backhaul(sc)``  rescale the non-source links and re-derive the
                           bandwidth-dependent tensors.

``Plan.solve()`` then runs stage 3 and the exact post-pass only.  The main
and ceil quantizer passes relax as one batched chain over the cached
tensors -- the argmin chain (kernel B1) for ``n_best == 1``, the k-slot
chain (B3) for ``n_best > 1`` -- with one device -> host copy per chunk;
parents are stored, so backtracks are O(1) lookups on the host.  The DP
grids are cached against a quantized-state version: a fade that stays in
its quantization cell leaves the DP inputs bit-identical and reuses the
grids outright.  Deltas that move only later layers stash the parent grids
so the next solve resumes the chain from the first affected layer (the
bounded re-relax).  Warm results are bit-exact against a cold
``solve_fin`` on the mutated scenario.

The reference also keeps a gather-index tensor in step with the
steepness; the port's kernels compute ``g - st`` themselves, so the plan
keeps steepness and init grids only.  ``plan.network`` and the post-pass
stay host objects.  ``solve_plans`` / ``update_uplinks`` are the
population forms.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .bellman_ford import batched_banded_relax_argmin
from .dnn_profile import DNNProfile
from .extended_graph import (ExtendedGraph, _profile_tensors,
                             build_extended_graph)
from .feasible_graph import (FeasibleGraph, _check_gamma_lam, _init_grids,
                             _quant, _quant_raw, build_feasible_graph)
from .fin import (DP_BACKENDS, _BandedArgDP, _best_feasible, _engine,
                  _iter_configs_at_exit, _relax_rows, _run_dp_batch,
                  _validate_n_best, relax_rows_per_chunk)
from .frontier import ParetoFrontier, frontier_from_rows
from .problem import (AppRequirements, Config, ConfigEval, Solution,
                      evaluate_config)
from .system_model import Network
from .tolerances import dist_tol

logger = logging.getLogger(__name__)

_F64 = torch.float64
_INF = float("inf")
_NAN = float("nan")

#: backends already warned about (k-best without a warm DP path): the
#: population forms construct many identical plans, so the warning fires
#: once per process per backend
_cold_kbest_warned: set = set()


@dataclass
class PlanStats:
    """Delta / re-solve counters of one plan (diagnostics and benches)."""

    uplink_updates: int = 0
    slice_updates: int = 0
    backhaul_updates: int = 0
    mask_updates: int = 0
    solves: int = 0
    dp_relaxes: int = 0         # round-0 DP relaxations actually run
    dp_cache_hits: int = 0      # round-0 solves served from cached DP grids
    bounded_relaxes: int = 0    # resumed relaxes (affected-layer onward)
    layers_skipped: int = 0     # layer chains reused by bounded resumes
    tighten_rebuilds: int = 0   # rare full requantize passes (tighten loop)


def migration_delta(profile: DNNProfile, old: Optional[Config],
                    new: Optional[Config]) -> Tuple[int, float]:
    """Blocks whose host changed between two configurations, and the bits
    that must move to re-host them (``profile.cut_bits`` per moved block;
    blocks present in only one config count as moved)."""
    if old is None or new is None:
        return 0, 0.0
    moved = 0
    bits = 0.0
    n = max(len(old.placement), len(new.placement))
    for i in range(n):
        a = old.placement[i] if i < len(old.placement) else None
        b = new.placement[i] if i < len(new.placement) else None
        if a != b:
            moved += 1
            bits += float(profile.cut_bits[min(i, profile.n_blocks - 1)])
    return moved, bits


class Plan:
    """Built pipeline state for one (network, profile, requirements) triple.

    The plan owns host copies of the network's bandwidth/compute arrays
    (``plan.network`` is a live view) plus every derived tensor of stages
    1-2 on ``device`` (default ``cuda:0``; ``device="cpu"`` runs the plain
    PyTorch path).  Delta methods mutate exactly the invalidated slices;
    ``solve()`` is then a pure stage-3 + post-pass call, bit-exact vs a
    cold ``solve_fin`` on ``plan.network``.

    Solver parameters mirror :func:`solve_fin`.  The warm DP path (cached
    grids, bounded resume) runs for the float64 ``minplus`` backend, for
    any ``n_best``; ``f32`` relaxes through the shared ``fin`` machinery on
    the cached tensors (still warm at stages 1-2).
    """

    def __init__(self, network: Network, profile: DNNProfile,
                 req: AppRequirements, *, gamma: int = 10,
                 lam: Optional[int] = None, quantize: str = "floor",
                 max_tighten: int = 6, tighten_factor: float = 0.85,
                 n_best: int = 1, backend: str = "minplus",
                 check_aggregate_load: bool = False,
                 device: DeviceLike = None):
        self.lam = _check_gamma_lam(gamma, lam)
        self.profile = profile
        self.req = req
        self.gamma = gamma
        self.quantize = quantize
        self.max_tighten = max_tighten
        self.tighten_factor = tighten_factor
        self.n_best = _validate_n_best(n_best)
        self.backend = backend
        self.check_aggregate_load = check_aggregate_load
        self._dist_tol = dist_tol(_engine(backend))
        self.device = dev = resolve_device(device)

        # owned host network state; ``self.network`` is a live view
        N = network.n_nodes
        self._bw = network.bandwidth.copy()
        #: pristine bandwidths: the reference point of ``update_backhaul``
        #: (repricing is absolute and drift-free; ``update_uplink`` only
        #: ever writes the source rows/cols, which this keeps stale)
        self._bw_base = network.bandwidth.copy()
        self._compute_base = network.compute.copy()
        self._slice_frac = np.ones(N)
        self._compute = network.compute.copy()
        self.network = Network(nodes=list(network.nodes), bandwidth=self._bw,
                               compute=self._compute,
                               source_node=network.source_node)

        # stage 1 (owned device tensors, mutated in place by the deltas;
        # the bandwidth-dependent latency rows refresh lazily, see ``ext``)
        self._ext = build_extended_graph(self.network, profile, req,
                                         device=dev)
        self._stale_src: Optional[int] = None

        # static per-profile / per-node caches shared by every delta
        self._ops, self._surv_in, self._surv_out, self._cut_bits = map(
            self._t, _profile_tensors(profile)[:4])
        self._in_bits = self._t(profile.input_bits)
        self._delta = self._t(req.delta)
        self._p_act = self._t(self.network.power_active)
        e_tx, e_rx = self._t(self.network.e_tx), self._t(self.network.e_rx)
        src = self.network.source_node
        self._node_ids = torch.arange(N, device=dev)
        eye = torch.eye(N, dtype=torch.bool, device=dev)
        pair_e = e_tx[:, None] + e_rx[None, :]
        comm_E = (self._surv_out[:-1, None, None]
                  * self._cut_bits[:-1, None, None] * pair_e[None])
        comm_E[:, eye] = 0.0
        self._comm_E = comm_E                                  # (L-1, N, N)
        self._init_comm = torch.where(self._node_ids == src, 0.0,
                                      (e_tx[src] + e_rx) * self._in_bits)
        self._load = (req.sigma * self._surv_out[:-1]
                      * self._cut_bits[:-1])                   # (L-1,)

        # bandwidth- / compute-derived pruning caches (the formulas of
        # build_extended_graph; refreshed slice-wise by the deltas)
        bw = self._t(self._bw)
        self._comp = self._comp_of(self._t(self._compute))
        self._link_ok = (bw > 0) | eye
        self._bw_fits = ((self._load[:, None, None]
                          <= torch.where(eye, _INF, bw)[None]) | eye[None])
        self._comp_fits = ((req.sigma * self._surv_in[1:, None]
                            * self._ops[1:, None]) <= self._comp[None, :])
        self._b_src = torch.where(self._node_ids == src, _INF, bw[src])

        # stage 2: quantized banded tensors for the main quantizer pass and
        # (row 1) the ceil rescue pass
        self._modes = ([quantize, "ceil"] if quantize != "ceil"
                       else [quantize])
        M, L, Gp1 = len(self._modes), profile.n_blocks, gamma + 1
        self._steep = torch.empty((M, L - 1, N, N), dtype=_F64, device=dev)
        self._init_depth = torch.empty((M, N), dtype=_F64, device=dev)
        self._grid = torch.empty((M, N, Gp1), dtype=_F64, device=dev)
        self._rebuild_packs()
        for mi in range(M):
            self._requant_full(mi)
        # prime the quantized uplink pack so the very first channel fade
        # can already be recognized as an in-cell no-op
        self._requant_uplink(src)

        self._masked = np.zeros(N, dtype=bool)
        self._masked_state: Optional[Tuple[torch.Tensor, ...]] = None
        #: bumped only when the DP inputs (quantized tensors, energies,
        #: masks) change value; in-cell channel fades leave it untouched and
        #: the cached round-0 DP grids are reused (the exact post-pass still
        #: re-runs against the updated true network)
        self._quant_version = 0
        self._dp_cache: Optional[Tuple[int, List[object]]] = None
        self._admissible = [k for k in range(profile.n_exits)
                            if profile.accuracy_of(k) >= req.alpha - 1e-12]
        #: warm DP path: the float64 engine relaxing the cached tensors, the
        #: argmin chain for ``n_best == 1`` or the k-slot chain (the Pareto
        #: frontier's DP); ``f32`` goes through the shared ``fin`` machinery
        self._warm = DP_BACKENDS[backend] == "banded"
        #: the last *solver* solution (``adopt`` replaces only the incumbent
        #: ``_solution``); ``frontier()`` pins its argmin row to this
        self._argmin_solution: Optional[Solution] = None
        if n_best > 1 and not self._warm and backend not in _cold_kbest_warned:
            _cold_kbest_warned.add(backend)
            logger.warning(
                "Plan(n_best=%d, backend=%r): no warm k-best DP path for "
                "this backend -- every solve re-runs the stage-3 relaxation "
                "from the cached tensors (use the minplus backend for warm "
                "k-best re-solves)", n_best, backend)
        self._solution: Optional[Solution] = None
        self.version = 0
        #: bumped by every delta EXCEPT mask/unmask (see ``_bump``): the
        #: validity key of precomputed failover entries keyed by mask
        self.env_version = 0
        self.stats = PlanStats()

    # ------------------------------------------------------------- helpers
    def _t(self, x) -> torch.Tensor:
        """A float64 copy of host data on the plan's device."""
        return torch.tensor(np.asarray(x, dtype=np.float64),
                            device=self.device)

    @staticmethod
    def _comp_of(compute: torch.Tensor) -> torch.Tensor:
        return torch.where(compute > 0, compute, _INF)

    # ------------------------------------------------------------ properties
    @property
    def n_nodes(self) -> int:
        return self.network.n_nodes

    @property
    def ext(self) -> ExtendedGraph:
        """The stage-1 extended graph, with any lazily deferred bandwidth
        rows flushed (the warm solve never reads them)."""
        self._flush_ext()
        return self._ext

    @property
    def solution(self) -> Optional[Solution]:
        """The incumbent: the last solved configuration (None before solve)."""
        return self._solution

    @property
    def masked_nodes(self) -> List[int]:
        return [int(n) for n in np.nonzero(self._masked)[0]]

    @property
    def depth_window_lo(self) -> Optional[int]:
        return self.gamma - self.lam if self.lam < self.gamma else None

    # --------------------------------------------------------- delta updates
    def update_uplink(self, bps: Union[float, np.ndarray]) -> "Plan":
        """Set the source node's up/downlink bandwidth (a scalar for all
        source links, or an (N,) per-target vector) and re-derive exactly
        the dependent slices.  Both link directions are set."""
        N = self.n_nodes
        src = self.network.source_node
        vec = np.broadcast_to(np.asarray(bps, dtype=np.float64), (N,)).copy()
        self._bw[src, :] = vec
        self._bw[:, src] = vec
        self._bw[src, src] = np.inf
        self._stale_src = src            # dense stage-1 rows refresh lazily
        changed = self._requant_uplink(src)
        self.stats.uplink_updates += 1
        self._bump(dp_dirty=changed)
        return self

    def _check_node(self, n: int) -> int:
        """Validate a node index for mask/unmask deltas (a negative index
        would silently wrap)."""
        if not isinstance(n, (int, np.integer)):
            raise ValueError(f"node index must be an int, got "
                             f"{type(n).__name__}")
        if not 0 <= int(n) < self.n_nodes:
            raise ValueError(f"node index {int(n)} out of range for a "
                             f"{self.n_nodes}-node network")
        return int(n)

    def mask_node(self, n: int) -> "Plan":
        """Node failure: infinity row/col masks over the cached tensors --
        nothing is re-quantized."""
        n = self._check_node(n)
        if n == self.network.source_node:
            raise ValueError("cannot mask the source-hosting node")
        if not self._masked[n]:
            self._masked[n] = True
            self.stats.mask_updates += 1
            self._bump(mask_only=True)
        return self

    def unmask_node(self, n: int) -> "Plan":
        """Recovery: drop the failure mask of node ``n`` (no recompute)."""
        n = self._check_node(n)
        if self._masked[n]:
            self._masked[n] = False
            self.stats.mask_updates += 1
            self._bump(mask_only=True)
        return self

    def update_slice(self, frac: Union[float, np.ndarray],
                     nodes: Optional[Sequence[int]] = None) -> "Plan":
        """Re-scale per-node compute slices (relative to the slices captured
        at construction) and re-derive the compute-dependent terms in place.
        ``nodes=None`` applies ``frac`` to every node."""
        if nodes is None:
            self._slice_frac[:] = frac
        else:
            self._slice_frac[list(nodes)] = frac
        snap = (self._steep.clone(), self._grid.clone(), self._ext.E.clone())
        stash0 = self._dp_resume         # survives the pack rebuild below
        self._refresh_compute()
        self._dp_resume = stash0
        self._stash_resume_tensors(*snap)
        self.stats.slice_updates += 1
        self._bump()
        return self

    def update_backhaul(self, scale: Union[float, np.ndarray]) -> "Plan":
        """Re-scale the non-source backhaul links (relative to the
        bandwidths captured at construction) and re-derive the
        bandwidth-dependent tensors.  ``scale`` is a scalar or an (N, N)
        per-link factor; the source row/column and the diagonal are
        ignored.  Application is absolute w.r.t. the pristine snapshot."""
        N = self.n_nodes
        src = self.network.source_node
        sc = np.broadcast_to(np.asarray(scale, dtype=np.float64),
                             (N, N)).copy()
        if not np.all(np.isfinite(sc)) or np.any(sc <= 0):
            raise ValueError("backhaul scale factors must be finite and > 0")
        sc[src, :] = 1.0
        sc[:, src] = 1.0
        np.fill_diagonal(sc, 1.0)
        off = np.ones((N, N), dtype=bool)
        off[src, :] = False
        off[:, src] = False
        np.fill_diagonal(off, False)
        self._bw[off] = self._bw_base[off] * sc[off]
        snap = (self._steep.clone(), self._grid.clone(), None)
        self._refresh_bw_full()
        self._stash_resume_tensors(*snap)
        self.stats.backhaul_updates += 1
        self._bump()
        return self

    def _bump(self, dp_dirty: bool = True, mask_only: bool = False) -> None:
        self._masked_state = None
        self.version += 1
        if dp_dirty:
            self._quant_version += 1
        if not mask_only:
            # anything that changes the DP or post-pass inputs other than
            # the failure mask (fades -- in-cell ones too, since the exact
            # post-pass reads the true bandwidth -- slice and backhaul churn)
            self.env_version += 1

    # ------------------------------------------------- slice-recompute cores
    def _flush_ext(self) -> None:
        if self._stale_src is not None:
            src, self._stale_src = self._stale_src, None
            self._refresh_bw_slices(src)

    def _refresh_bw_slices(self, src: int) -> None:
        """Re-derive the bandwidth-dependent stage-1 tensors on rows/cols
        ``src`` with build_extended_graph's formulas elementwise.  The
        uplink writes are symmetric, so the row-direction intermediates are
        reused for the column direction."""
        ext = self._ext
        bw = self._bw
        cut = self._cut_bits[:-1, None]                        # (L-1, 1)
        symmetric = np.array_equal(bw[src, :], bw[:, src])
        for axis in (0, 1):            # 0: row [src, :], 1: col [:, src]
            if axis == 0 or not symmetric:
                b = self._t(bw[src, :] if axis == 0 else bw[:, src])
                ok_eye = b > 0
                ok_eye[src] = True                             # (bw>0) | eye
                eff = torch.where(ok_eye, b, _NAN)
                eff[src] = _INF
                t = cut / eff[None, :]
                t = torch.where(torch.isnan(t), _INF, t)
                t[:, src] = 0.0
                w = b.clone()
                w[src] = _INF                                  # eye -> inf
                fits = self._load[:, None] <= w[None, :]
                fits[:, src] = True                            # |= eye
            if axis == 0:
                self._link_ok[src, :] = ok_eye
                ext.T[:, src, :] = t
                ext.TT[:, src, :] = t + ext.C[1:, :]
                self._bw_fits[:, src, :] = fits
                ext.mask[:, src, :] = (ok_eye[None, :] & fits
                                       & self._comp_fits)
            else:
                self._link_ok[:, src] = ok_eye
                ext.T[:, :, src] = t
                ext.TT[:, :, src] = t + ext.C[1:, src][:, None]
                self._bw_fits[:, :, src] = fits
                ext.mask[:, :, src] = (ok_eye[None, :] & fits
                                       & self._comp_fits[:, src][:, None])
        self._b_src = torch.where(self._node_ids == src, _INF,
                                  self._t(bw[src]))
        self._refresh_init()

    def _refresh_bw_full(self) -> None:
        """Re-derive EVERY bandwidth-dependent tensor from ``self._bw``
        (backhaul churn touches arbitrary links), then requantize both
        passes and re-prime the uplink pack; compute-dependent caches are
        reused verbatim."""
        ext = self._ext
        bw = self._t(self._bw)
        N = self.n_nodes
        src = self.network.source_node
        eye = torch.eye(N, dtype=torch.bool, device=self.device)
        self._stale_src = None            # superseded by the full refresh
        self._link_ok = (bw > 0) | eye
        bw_eff = torch.where(self._link_ok, torch.where(eye, _INF, bw), _NAN)
        T = self._cut_bits[:-1, None, None] / bw_eff[None]
        T = torch.where(torch.isnan(T), _INF, T)
        T[:, eye] = 0.0
        ext.T[:] = T
        ext.TT[:] = T + ext.C[1:, :][:, None, :]
        self._bw_fits = ((self._load[:, None, None]
                          <= torch.where(eye, _INF, bw)[None]) | eye[None])
        ext.mask[:] = (self._link_ok[None] & self._bw_fits
                       & self._comp_fits[:, None, :])
        self._b_src = torch.where(self._node_ids == src, _INF, bw[src])
        self._refresh_init()
        for mi in range(len(self._modes)):
            self._requant_full(mi)
        self._requant_uplink(src, stash=False)   # re-prime the pack

    def _refresh_compute(self) -> None:
        """Re-derive every compute-dependent tensor in place (slice churn).
        The comm-energy term and all bandwidth caches are reused."""
        self._flush_ext()
        ext = self._ext
        req = self.req
        np.multiply(self._compute_base, self._slice_frac, out=self._compute)
        self._comp = comp = self._comp_of(self._t(self._compute))
        ext.C[:] = self._ops[:, None] / comp[None, :]
        comp_E = (self._surv_in[1:, None] * self._p_act[None, :]
                  * ext.C[1:, :])
        ext.E[:] = self._comm_E + comp_E[:, None, :]
        ext.TT[:] = ext.T + ext.C[1:, :][:, None, :]
        self._comp_fits = ((req.sigma * self._surv_in[1:, None]
                            * self._ops[1:, None]) <= comp[None, :])
        ext.mask[:] = (self._link_ok[None] & self._bw_fits
                       & self._comp_fits[:, None, :])
        self._refresh_init()
        ext.init_E[:] = (self._init_comm
                         + self._surv_in[0] * self._p_act * ext.C[0])
        self._rebuild_packs()
        for mi in range(len(self._modes)):
            self._requant_full(mi)
        self._requant_uplink(self.network.source_node,   # re-prime the pack
                             stash=False)

    def _refresh_init(self) -> None:
        ext = self._ext
        sigma = self.req.sigma
        b_src = self._b_src
        init_T = (self._in_bits / torch.where(b_src > 0, b_src, _NAN)
                  + ext.C[0])
        ext.init_T[:] = torch.where(torch.isnan(init_T), _INF, init_T)
        ext.init_mask[:] = ((b_src > 0)
                            & (sigma * self._in_bits <= b_src)
                            & (sigma * self._surv_in[0] * self._ops[0]
                               <= self._comp))

    # -------------------------------------------------- stage-2 requantizers
    def _rebuild_packs(self) -> None:
        """Constant packs of the fused uplink requantizer.

        The source-node row steeps (src -> n'), the init vector and the
        source-node column steeps (n -> src) are elementwise functions of
        the SAME bandwidth vector, so they evaluate as one packed (2L-1, N)
        pipeline: rows 0..L-2 the row steeps, row L-1 the init, rows
        L..2L-2 the column steeps.  Everything bandwidth-independent is
        precomputed here and refreshed only on compute-slice churn.
        """
        N = self.n_nodes
        L = self.profile.n_blocks
        src = self.network.source_node
        ext = self._ext
        cut = self._cut_bits[:-1]
        self._bits_pack = torch.cat([cut, self._in_bits[None], cut])[:, None]
        Cp = torch.empty((2 * L - 1, N), dtype=_F64, device=self.device)
        Cp[:L - 1] = ext.C[1:]
        Cp[L - 1] = ext.C[0]
        Cp[L:] = ext.C[1:, src][:, None]
        self._C_pack = Cp
        mp = torch.empty((2 * L - 1, N), dtype=torch.bool, device=self.device)
        mp[:L - 1] = self._comp_fits
        mp[L - 1] = (self.req.sigma * self._surv_in[0] * self._ops[0]
                     <= self._comp)
        mp[L:] = self._comp_fits[:, src][:, None]
        self._mask_pack = mp
        lp = torch.empty(2 * L - 1, dtype=_F64, device=self.device)
        lp[:L - 1] = self._load
        lp[L - 1] = self.req.sigma * self.profile.input_bits
        lp[L:] = self._load
        self._load_pack = lp[:, None]
        self._qpack: Optional[torch.Tensor] = None   # last quantized pack
        #: bounded re-relaxation stash: (parent DP grids, first affected
        #: layer, the quant version they resume INTO).  Any delta that bumps
        #: ``_quant_version`` past the stashed target invalidates it.
        self._dp_resume: Optional[Tuple[List[object], int, int]] = None

    def _requant_uplink(self, src: int, stash: bool = True) -> bool:
        """Uplink delta: requantize the source-node slice as one packed
        pipeline and scatter it into the cached tensors only when the
        quantized values moved.  Returns whether any DP input changed.
        ``stash=False`` (a full refresh re-priming the pack) drops the
        bounded-resume stash: the caller's whole-tensor diff owns it."""
        G = self.gamma
        bwv = self._bw[src].copy()                   # (N,)
        bwv[src] = np.inf                            # self-loop (Sec. II-A)
        bwv = self._t(bwv)
        bwm = torch.where(bwv > 0, bwv, _NAN)
        sc = self._bits_pack / bwm                   # (2L-1, N)
        sc = sc + self._C_pack                       # = TT rows / init_T
        sc = sc * G
        sc = sc / self._delta                        # = gamma * TT / delta
        # a zero-bandwidth (no-link) target yields sc = nan -> invalid
        valid = (torch.isfinite(sc) & self._mask_pack
                 & (self._load_pack <= bwv))
        qs = torch.stack([_quant_raw(sc, mode) for mode in self._modes])
        stq = torch.where(valid & (qs <= G), qs, _INF)
        if self._qpack is not None and torch.equal(stq, self._qpack):
            return False
        if stash:
            self._stash_resume(stq)
        else:
            self._dp_resume = None
        self._apply_qpack(src, stq)
        return True

    def _dp_base(self, final_l0: int) -> Optional[Tuple[List[object], int]]:
        """The DP grids a bounded resume can start from, and the first layer
        already invalidated in them: the cached grids of the current quant
        version (nothing invalidated yet: ``final_l0``), or the grids of a
        stash that targets it."""
        if (self._dp_cache is not None
                and self._dp_cache[0] == self._quant_version):
            return self._dp_cache[1], final_l0
        if (self._dp_resume is not None
                and self._dp_resume[2] == self._quant_version):
            return self._dp_resume[0], self._dp_resume[1]
        return None

    def _stash_resume(self, stq: torch.Tensor) -> None:
        """Record the first layer this uplink delta touches, with the
        pre-delta DP grids, so the next warm solve can resume the chain
        from that layer.  Pack row ``r < L-1`` feeds layer ``r``, ``r ==
        L-1`` the init grid (no resume), ``r >= L`` layer ``r - L``.
        Consecutive uplink deltas chain by taking the min affected layer
        against the SAME parent grids."""
        if self._qpack is None or not (self._warm and self.n_best == 1):
            self._dp_resume = None
            return
        L = self.profile.n_blocks
        based = self._dp_base(L)
        if based is None:
            self._dp_resume = None
            return
        base, l0 = based
        moved = (stq != self._qpack).any(dim=2).any(dim=0)
        for r in torch.nonzero(moved).flatten().tolist():
            l0 = min(l0, 0 if r == L - 1 else (r if r < L - 1 else r - L))
        if l0 < 1:
            self._dp_resume = None
            return
        self._dp_resume = (base, int(l0), self._quant_version + 1)

    def _stash_resume_tensors(self, old_steep: torch.Tensor,
                              old_grid: torch.Tensor,
                              old_E: Optional[torch.Tensor]) -> None:
        """Whole-tensor form of :meth:`_stash_resume` for the full-refresh
        deltas (slice, backhaul): diff the pre-delta steepness stack / init
        grid (and, for compute churn, the energy tensor) per layer.  Called
        before ``_bump``: the current quant version still names the parent
        grids."""
        Lm1 = self.profile.n_blocks - 1
        based = self._dp_base(Lm1)
        self._dp_resume = None
        if based is None or not (self._warm and self.n_best == 1):
            return
        if not torch.equal(self._grid, old_grid):
            return                      # init grid moved: layer 0 affected
        base, l0 = based
        ch = (self._steep != old_steep).reshape(
            len(self._modes), Lm1, -1).any(dim=2).any(dim=0)
        if old_E is not None:
            ch |= (self._ext.E != old_E).reshape(Lm1, -1).any(dim=1)
        moved = torch.nonzero(ch).flatten().tolist()
        if moved:
            l0 = min(l0, moved[0])
        if l0 < 1:
            return
        self._dp_resume = (base, int(l0), self._quant_version + 1)

    def _try_resume_dp(self) -> Optional[List[object]]:
        """Bounded re-relaxation: if a valid stash targets the current quant
        version, relax only layers ``l0..L-1`` from the parent grids'
        layer-``l0`` slice (one B1 launch) and splice the untouched prefix;
        bit-exact because the depth window is depth-based and the per-layer
        schedule is identical."""
        st = self._dp_resume
        if st is None:
            return None
        dps, l0, ver = st
        self._dp_resume = None
        if ver != self._quant_version:
            return None
        steep, _, _ = self._quant_state()
        M = len(self._modes)
        init = self._t(np.stack([dps[mi].hist[l0] for mi in range(M)]))
        E_tail = self._ext.E[l0:]
        E = E_tail[None].expand((M,) + tuple(E_tail.shape))
        hist, par = batched_banded_relax_argmin(init, E, steep[:, l0:],
                                                self.depth_window_lo,
                                                dtype=_F64)
        hist, par, steep_h = (hist.cpu().numpy(), par.cpu().numpy(),
                              steep.cpu().numpy())
        new: List[object] = []
        for mi in range(M):
            h = np.concatenate([dps[mi].hist[:l0], hist[mi]])
            pn = np.concatenate([dps[mi].par_n[:l0], par[mi]])
            new.append(_BandedArgDP(h, pn, steep_h[mi]))
        self._dp_cache = (self._quant_version, new)
        self.stats.dp_relaxes += 1
        self.stats.bounded_relaxes += 1
        self.stats.layers_skipped += l0
        return new

    def _apply_qpack(self, src: int, stq: torch.Tensor) -> None:
        """Scatter a quantized uplink pack (M, 2L-1, N) into the cached
        steepness / init tensors: rows 0..L-2 the source-node ROW steeps,
        row L-1 the init vector, rows L..2L-2 the COLUMN steeps."""
        L = self.profile.n_blocks
        self._qpack = stq
        self._steep[:, :, src, :] = stq[:, :L - 1]
        self._steep[:, :, :, src] = stq[:, L:]
        d = stq[:, L - 1, :]                          # (M, N) init depths
        self._init_depth[:] = d
        M = d.shape[0]
        self._grid[:] = _init_grids(d, self._ext.init_E[None].expand(M, -1),
                                    self.gamma)

    def _requant_full(self, mi: int) -> None:
        """Full stage-2 requantize of mode ``mi`` (construction and
        compute-slice churn; uplink churn uses ``_requant_uplink``)."""
        mode = self._modes[mi]
        ext = self._ext
        G = self.gamma
        q = _quant(G * ext.TT / self._delta, mode)
        q = torch.where(ext.mask, q, _INF)
        self._steep[mi] = torch.where(q <= G, q, _INF)
        qd = _quant(G * ext.init_T / self._delta, mode)
        qd = torch.where(ext.init_mask, qd, _INF)
        d = torch.where(qd <= G, qd, _INF)
        self._init_depth[mi] = d
        self._grid[mi] = _init_grids(d[None], ext.init_E[None], G)[0]

    # ------------------------------------------------------- masked tensors
    def _quant_state(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(steep, grid, init_depth) stacks with node masks applied: the
        cached tensors without failures, else a lazily cached copy with
        infinity rows/cols (the kernels treat an infinite steepness as a
        pruned edge, so no other mask is needed)."""
        if not self._masked.any():
            return self._steep, self._grid, self._init_depth
        if self._masked_state is None:
            m = torch.as_tensor(self._masked, device=self.device)
            steep = self._steep.clone()
            grid = self._grid.clone()
            idep = self._init_depth.clone()
            steep[:, :, m, :] = _INF
            steep[:, :, :, m] = _INF
            grid[:, m, :] = _INF
            idep[:, m] = _INF
            self._masked_state = (steep, grid, idep)
        return self._masked_state

    def _feasible(self, mode: str,
                  delta_eff: Optional[float] = None) -> FeasibleGraph:
        """A FeasibleGraph view over the cached (masked) tensors; a
        non-default ``delta_eff`` (the tighten loop) re-quantizes fresh."""
        if delta_eff is None:
            steep, _, idep = self._quant_state()
            mi = self._modes.index(mode)
            return FeasibleGraph(ext=self._ext, gamma=self.gamma,
                                 lam=self.lam, quantize=mode,
                                 delta_eff=self.req.delta,
                                 steep=steep[mi], init_depth=idep[mi])
        self._flush_ext()
        fg = build_feasible_graph(self._ext, self.gamma, lam=self.lam,
                                  quantize=mode, delta_eff=delta_eff)
        if self._masked.any():
            m = torch.as_tensor(self._masked, device=self.device)
            fg.steep[:, m, :] = _INF
            fg.steep[:, :, m] = _INF
            fg.init_depth[m] = _INF
        self.stats.tighten_rebuilds += 1
        return fg

    # ---------------------------------------------------------------- solve
    def evaluate(self, config: Config) -> ConfigEval:
        """Exact (3a)-(3e) evaluation against the plan's *current* network;
        placements touching a failed (masked) node are infeasible."""
        dead = [n for n in config.placement if self._masked[n]]
        if dead:
            return ConfigEval(energy=np.inf, energy_comp=np.inf,
                              energy_comm=np.inf, latency=np.inf,
                              accuracy=self.profile.accuracy_of(
                                  config.final_exit),
                              feasible=False,
                              violations=[f"node {n} failed" for n in dead])
        return evaluate_config(self.network, self.profile, self.req, config,
                               check_aggregate_load=self.check_aggregate_load)

    def _scan(self, dp, bound: Optional[Tuple[Config, ConfigEval]] = None):
        return _best_feasible(self.network, self.profile, self.req, dp,
                              self._admissible, self.check_aggregate_load,
                              bound=bound, dist_tol=self._dist_tol,
                              oracle=self.backend == "python")

    def _dp_round0(self) -> List[object]:
        """Stage-3 DPs for the main + ceil passes at the base delta, cached
        against ``_quant_version``: deltas that moved no DP input skip the
        relaxation outright."""
        cached = self._dp_cached()
        if cached is not None:
            return cached
        if not self._warm:
            dps = _run_dp_batch([self._feasible(m) for m in self._modes],
                                self.n_best, self.backend)
            self._dp_cache = (self._quant_version, dps)
            self.stats.dp_relaxes += 1
            return dps
        return _warm_round0([self])[0]

    def _dp_cached(self) -> Optional[List[object]]:
        if (self._dp_cache is not None
                and self._dp_cache[0] == self._quant_version):
            self.stats.dp_cache_hits += 1
            return self._dp_cache[1]
        return None

    def solve(self) -> Solution:
        """Warm re-solve: stage 3 + exact post-pass over the cached tensors.

        Control flow mirrors ``solve_fin`` (tighten loop on the main
        quantizer, ceil rescue pass bounded by the main pass's energy), so
        the result is bit-exact vs a cold ``solve_fin(plan.network, ...)``.
        """
        t0 = time.perf_counter()
        meta = {"gamma": self.gamma, "quantize": self.quantize,
                "tighten_rounds": 0, "backend": self.backend,
                "plan_version": self.version, "warm": True}
        if not self._admissible:
            sol = Solution(config=None, eval=None,
                           solve_time=time.perf_counter() - t0, solver="fin",
                           meta={**meta,
                                 "reason": "no exit meets alpha (3c)"})
            self._record(sol)
            return sol

        dps = self._dp_round0()
        delta_eff = self.req.delta
        best: Optional[Tuple[Config, ConfigEval]] = None
        for round_ in range(self.max_tighten + 1):
            if round_ == 0:
                dp = dps[0]
            else:
                fg = self._feasible(self.quantize, delta_eff)
                dp = _run_dp_batch([fg], self.n_best, self.backend)[0]
            best = self._scan(dp)
            if best is not None:
                break
            delta_eff *= self.tighten_factor
            meta["tighten_rounds"] = round_ + 1
        if self.quantize != "ceil":
            alt = self._scan(dps[1], best)
            if alt is not None and (best is None
                                    or alt[1].energy < best[1].energy):
                best = alt
                meta["used_ceil_pass"] = True

        dt = time.perf_counter() - t0
        if best is None:
            sol = Solution(config=None, eval=None, solve_time=dt,
                           solver="fin",
                           meta={**meta, "reason": "no feasible path"})
        else:
            cfg, ev = best
            meta["delta_eff"] = delta_eff
            meta["n_feasible_states"] = int(np.isfinite(ev.energy))
            sol = Solution(config=cfg, eval=ev, solve_time=dt, solver="fin",
                           meta=meta)
        self._record(sol)
        return sol

    def _record(self, sol: Solution) -> None:
        self._solution = sol
        self._argmin_solution = sol
        self.stats.solves += 1

    # ------------------------------------------------------------- frontier
    def frontier(self, *, k_per_exit: Optional[int] = 4) -> ParetoFrontier:
        """The scenario's k-best Pareto frontier (``frontier.py``).

        Backtracks the ``k_per_exit`` cheapest DP candidates per admissible
        exit from the cached round-0 grids of BOTH quantizer passes,
        exact-evaluates each against the plan's current network, and
        dominance-prunes the feasible rows.  The frontier's ``argmin`` row
        is exactly ``solve()``'s selection (the plan is warm-solved first if
        the incumbent is stale).  ``k_per_exit=None`` exhausts every DP end
        state per exit; ``n_best > 1`` adds the k-best alternatives that
        collide on quantized states.
        """
        sol = self._argmin_solution
        if sol is None or sol.meta.get("plan_version") != self.version:
            incumbent = self._solution
            sol = self.solve()
            if incumbent is not None \
                    and incumbent.meta.get("policy") == "frontier":
                self._solution = incumbent    # keep the adopted incumbent
        argmin_pair = (sol.config, sol.eval) if sol.feasible else None
        dps = self._dp_round0()
        pairs: List[Tuple[Config, ConfigEval]] = []
        for k in self._admissible:
            for dp in dps:
                for j, (cfg, _ge) in enumerate(
                        _iter_configs_at_exit(dp, self.profile, k)):
                    if k_per_exit is not None and j >= k_per_exit:
                        break
                    pairs.append((cfg, self.evaluate(cfg)))
        return frontier_from_rows(pairs, argmin_pair)

    def adopt(self, config: Config, ev: Optional[ConfigEval] = None,
              meta: Optional[dict] = None) -> Solution:
        """Install an externally chosen configuration (a frontier row or the
        kept incumbent) as the incumbent; ``ev`` defaults to an exact
        evaluation against the plan's current network."""
        if ev is None:
            ev = self.evaluate(config)
        sol = Solution(config=config, eval=ev, solve_time=0.0, solver="fin",
                       meta={"policy": "frontier",
                             "plan_version": self.version, **(meta or {})})
        self._solution = sol
        return sol

    def install_solution(self, sol: Solution,
                         dps: Optional[List[object]] = None) -> Solution:
        """Install a precomputed solver solution as BOTH the incumbent and
        the argmin solution.  The caller asserts it was produced by
        ``solve()`` on a plan in the current state; ``dps`` optionally
        installs the matching round-0 DP grids.  Counts as a solve, with
        zero ``dp_relaxes``."""
        sol = Solution(config=sol.config, eval=sol.eval,
                       solve_time=sol.solve_time, solver=sol.solver,
                       meta={**sol.meta, "plan_version": self.version,
                             "contingency": True})
        self._record(sol)
        if dps is not None:
            self._dp_cache = (self._quant_version, dps)
        return sol


def _validate_population_bps(bps: Union[float, np.ndarray], U: int,
                             n_nodes: Union[int, Sequence[int]]
                             ) -> np.ndarray:
    """Validate a population uplink argument up front: a scalar (all
    users), a (U,) per-user vector or a (U, N) per-target matrix; anything
    else raises a clear ``ValueError`` (an (N,) vector handed to a U-user
    population must not be read as per-user scalars when U == N)."""
    arr = np.asarray(bps, dtype=np.float64)
    if arr.ndim == 0:
        return arr
    if arr.ndim > 2:
        raise ValueError(
            f"bps must be a scalar, a ({U},) per-user vector or a "
            f"({U}, N) per-target matrix; got ndim={arr.ndim} "
            f"shape {arr.shape}")
    if arr.shape[0] != U:
        raise ValueError(
            f"bps leading dimension must equal the population size {U}; "
            f"got shape {arr.shape}")
    if arr.ndim == 2:
        if isinstance(n_nodes, int):
            if arr.shape[1] != n_nodes:
                raise ValueError(
                    f"bps is ({U}, {arr.shape[1]}) but the cohort has "
                    f"{n_nodes} nodes per user")
            return arr
        bad = [(u, n) for u, n in enumerate(n_nodes) if n != arr.shape[1]]
        if bad:
            u0, n0 = bad[0]
            raise ValueError(
                f"bps is ({U}, {arr.shape[1]}) but user {u0} has "
                f"{n0} nodes; per-target matrices require every user's "
                f"node count to match the trailing dimension")
    return arr


def _validate_bps_values(arr=None, *, bad: Optional[np.ndarray] = None,
                         users: Optional[np.ndarray] = None,
                         src: Optional[int] = None,
                         what: str = "bps") -> None:
    """Reject NaN/Inf/negative bandwidth readings, naming the offenders.

    Pass ``arr`` (a scalar, (U,) vector or (U, N) matrix; ``src`` excludes
    the self-loop column, which is legitimately infinite) or a precomputed
    boolean ``bad`` entry set.  ``users`` maps row positions to user
    indices for the message.  Raises ``ValueError`` listing up to 10
    offending users.
    """
    if bad is None:
        a = np.asarray(arr, dtype=np.float64)
        if a.ndim == 0:
            if not np.isfinite(a) or a < 0:
                raise ValueError(
                    f"{what} is {float(a)!r}: bandwidth readings must be "
                    f"finite and >= 0")
            return
        bad = ~np.isfinite(a) | (a < 0)
        if a.ndim == 2 and src is not None:
            bad[:, src] = False
    bad_user = bad if bad.ndim == 1 else bad.any(axis=1)
    if not bad_user.any():
        return
    idx = np.nonzero(bad_user)[0]
    ids = idx if users is None else np.asarray(users)[idx]
    shown = ", ".join(str(int(u)) for u in ids[:10])
    more = f" (+{len(ids) - 10} more)" if len(ids) > 10 else ""
    raise ValueError(
        f"{what}: NaN/Inf/negative reading(s) for {len(ids)} user(s) "
        f"[{shown}]{more} -- bandwidth must be finite and >= 0")


def update_uplinks(plans: Sequence[Plan],
                   bps: Union[float, np.ndarray]) -> List[bool]:
    """Batched :meth:`Plan.update_uplink` across a user population.

    ``bps`` is a scalar, a (U,) per-plan scalar, or a (U, N) per-target
    matrix.  Plans sharing shape, solver parameters and device are grouped
    and the group's packed requantization runs as ONE stacked
    (U, 2L-1, N) pipeline, with per-plan scatters only for the plans whose
    quantized state moved.  Elementwise identical to calling
    ``update_uplink`` per plan.  Returns the per-plan DP-input-changed
    flags.
    """
    U = len(plans)
    arr = _validate_population_bps(bps, U, [p.n_nodes for p in plans])
    if arr.ndim == 0:
        arr = np.full(U, float(arr))
    changed_out = [False] * U

    groups: Dict[Tuple, List[int]] = {}
    for j, p in enumerate(plans):
        key = (p.profile.n_blocks, p.n_nodes, p.gamma, tuple(p._modes),
               p.network.source_node, p.device)
        groups.setdefault(key, []).append(j)
    for (L, N, G, modes, src, dev), idxs in groups.items():
        D = len(idxs)
        vec = np.empty((D, N))
        for pos, j in enumerate(idxs):
            vec[pos] = arr[j]
        vec[:, src] = np.inf             # self-loop stays infinite
        _validate_bps_values(vec, src=src, users=np.asarray(idxs),
                             what="update_uplinks bps")
        for pos, j in enumerate(idxs):
            p = plans[j]
            p._bw[src, :] = vec[pos]
            p._bw[:, src] = vec[pos]
            p._stale_src = src
        grp = [plans[j] for j in idxs]
        vec_t = torch.tensor(vec, device=dev)
        bwm = torch.where(vec_t > 0, vec_t, _NAN)                 # (D, N)
        sc = torch.stack([p._bits_pack for p in grp]) / bwm[:, None, :]
        sc = sc + torch.stack([p._C_pack for p in grp])         # (D, 2L-1, N)
        sc = sc * G
        sc = sc / torch.stack([p._delta for p in grp])[:, None, None]
        valid = (torch.isfinite(sc)
                 & torch.stack([p._mask_pack for p in grp])
                 & (torch.stack([p._load_pack for p in grp])
                    <= vec_t[:, None, :]))
        qs = torch.stack([_quant_raw(sc, mode) for mode in modes])
        stq = torch.where(valid[None] & (qs <= G), qs, _INF)
        stq = stq.transpose(0, 1).contiguous()                  # (D, M, ..)
        old = torch.stack([p._qpack if p._qpack is not None
                           else torch.full_like(stq[0], -1.0) for p in grp])
        same = (stq == old).reshape(D, -1).all(dim=1).tolist()
        for pos, p in enumerate(grp):
            if not same[pos]:
                p._apply_qpack(src, stq[pos])
        for pos, j in enumerate(idxs):
            p = plans[j]
            p.stats.uplink_updates += 1
            changed_out[j] = not same[pos]
            p._bump(dp_dirty=changed_out[j])
    return changed_out


def _warm_round0(plans: Sequence[Plan]) -> List[List[object]]:
    """Round-0 DP grids (main + ceil quantizer pass) for warm plans.

    Plans whose DP inputs did not move are served from their cached grids,
    and a valid bounded-resume stash relaxes only the affected layers.  The
    rest are grouped by shape and device, and both quantizer passes of
    every plan ride in ONE chained float64 relaxation per chunk over the
    cached (masked) steepness and init grids -- the argmin chain (B1) for
    ``n_best == 1``, the k-slot chain (B3) for ``n_best > 1`` -- with one
    device -> host copy per chunk.  Returns, per plan, its list of per-mode
    DP grids (``fin._BandedArgDP`` / ``fin._BandedKDP``).
    """
    out: List[Optional[List[object]]] = [None] * len(plans)
    groups: Dict[Tuple, List[int]] = {}
    for j, p in enumerate(plans):
        assert p._warm
        cached = p._dp_cached()
        if cached is not None:
            out[j] = cached          # DP inputs unchanged since last relax
            continue
        resumed = p._try_resume_dp()
        if resumed is not None:
            out[j] = resumed         # bounded resume from the stashed layer
        else:
            groups.setdefault((p.profile.n_blocks, p.n_nodes, p.device),
                              []).append(j)
    for (L, N, dev), idxs in groups.items():
        p0 = plans[idxs[0]]
        M = len(p0._modes)
        K = p0.n_best
        lo = p0.depth_window_lo
        Gp1 = p0.gamma + 1
        rows = relax_rows_per_chunk(dev, L, N, Gp1, K, _F64)
        step = max(1, rows // M)
        for start in range(0, len(idxs), step):
            part = idxs[start:start + step]
            states = [plans[j]._quant_state() for j in part]
            steep = torch.cat([s[0] for s in states])    # (d*M, L-1, N, N)
            grid = torch.cat([s[1] for s in states])
            E = torch.cat([plans[j]._ext.E[None].expand((M,) + tuple(
                plans[j]._ext.E.shape)) for j in part])
            rows_dp = _relax_rows(grid, E, steep, lo, _F64, K)
            for pos, j in enumerate(part):
                dps = rows_dp[pos * M:(pos + 1) * M]
                plans[j]._dp_cache = (plans[j]._quant_version, dps)
                plans[j].stats.dp_relaxes += 1
                out[j] = dps
    return out


def solve_plans(plans: Sequence[Plan]) -> List[Solution]:
    """Batched warm re-solve of many plans (the population path).

    Plans sharing solver parameters and device are grouped and their main +
    ceil DP passes relax as stacked chains; each plan's incumbent is
    updated, and results equal per-plan ``Plan.solve()`` calls (and hence a
    cold ``solve_fin`` per mutated scenario).
    """
    groups: Dict[Tuple, List[int]] = {}
    for j, p in enumerate(plans):
        key = (p.gamma, p.lam, p.quantize, p.max_tighten, p.tighten_factor,
               p.n_best, p.backend, p.check_aggregate_load, p.device)
        groups.setdefault(key, []).append(j)
    out: List[Optional[Solution]] = [None] * len(plans)
    for idxs in groups.values():
        for j, sol in zip(idxs, _solve_group([plans[j] for j in idxs])):
            out[j] = sol
    return out


def _solve_group(plans: Sequence[Plan]) -> List[Solution]:
    """solve_many's control flow over a same-parameter group of plans."""
    t0 = time.perf_counter()
    p0 = plans[0]
    B = len(plans)
    quantize, backend = p0.quantize, p0.backend
    base_meta = {"gamma": p0.gamma, "quantize": quantize,
                 "tighten_rounds": 0, "backend": backend, "batch_size": B,
                 "warm": True}
    tighten_rounds = [0] * B
    used_ceil = [False] * B
    best: List[Optional[Tuple[Config, ConfigEval]]] = [None] * B

    active = [b for b in range(B) if plans[b]._admissible]
    delta_eff = [p.req.delta for p in plans]
    pending = list(active)
    ceil_dps: Dict[int, object] = {}
    for round_ in range(p0.max_tighten + 1):
        if not pending:
            break
        if round_ == 0 and p0._warm:
            # warm fast path: both quantizer passes of the whole group relax
            # over the cached tensors (pending == active)
            rows = _warm_round0([plans[b] for b in pending])
            dps = [r[0] for r in rows]
            if quantize != "ceil":
                dps += [r[1] for r in rows]
        else:
            fgs = [plans[b]._feasible(quantize,
                                      delta_eff[b] if round_ else None)
                   for b in pending]
            if round_ == 0 and quantize != "ceil":
                fgs += [plans[b]._feasible("ceil") for b in active]
            dps = _run_dp_batch(fgs, p0.n_best, backend)
        if round_ == 0 and quantize != "ceil":
            ceil_dps = dict(zip(active, dps[len(pending):]))
        still = []
        for b, dp in zip(pending, dps[:len(pending)]):
            f = plans[b]._scan(dp)
            if f is not None:
                best[b] = f
            else:
                delta_eff[b] *= p0.tighten_factor
                tighten_rounds[b] = round_ + 1
                still.append(b)
        pending = still
    if quantize != "ceil":
        for b in active:
            f = plans[b]._scan(ceil_dps[b], best[b])
            if f is not None and (best[b] is None
                                  or f[1].energy < best[b][1].energy):
                best[b] = f
                used_ceil[b] = True

    dt = time.perf_counter() - t0
    out: List[Solution] = []
    for b in range(B):
        meta = {**base_meta, "tighten_rounds": tighten_rounds[b],
                "plan_version": plans[b].version, "batch_time": dt}
        if used_ceil[b]:
            meta["used_ceil_pass"] = True
        if not plans[b]._admissible:
            meta["reason"] = "no exit meets alpha (3c)"
            sol = Solution(config=None, eval=None, solve_time=dt / B,
                           solver="fin", meta=meta)
        elif best[b] is None:
            meta["reason"] = "no feasible path"
            sol = Solution(config=None, eval=None, solve_time=dt / B,
                           solver="fin", meta=meta)
        else:
            cfg, ev = best[b]
            meta["delta_eff"] = delta_eff[b]
            meta["n_feasible_states"] = int(np.isfinite(ev.energy))
            sol = Solution(config=cfg, eval=ev, solve_time=dt / B,
                           solver="fin", meta=meta)
        plans[b]._record(sol)
        out.append(sol)
    return out
