"""FIN solver (Alg. 1): feasible-graph construction + min-cost traversal.

Port of ``repro/core/fin.py``.  The traversal is a layered dynamic program
over states (node, depth), banded in depth, so it runs over the compact
(N, G+1) grid as a shift-by-steep gather + min over source nodes.  The
extended and feasible graphs and the relaxation live on the device; the
exact (3a)-(3e) post-pass and the backtrack are host code on one copy of
each relaxation chunk.  Backends:

  ``minplus``  float64 relaxation (default; alias ``banded``) -- bit-exact
               against the reference's ``backend="minplus"``, for every
               ``n_best``;
  ``f32``      float32 relaxation (prune guard DIST_RTOL_F32), the
               counterpart of the reference's ``jnp`` / ``pallas`` backends
               at ``n_best == 1`` and of its ``pallas`` k-slot kernel at
               ``n_best > 1``;
  ``dense``    the dense flattened-state float64 relaxation over (S, S)
               layer matrices, S = N * (G+1) (alias ``numpy``) -- the
               reference's equivalence backend, bit-exact against its
               ``dense``; at ``n_best > 1`` the dense k-best oracle;
  ``python``   the reference's loop DP, the oracle every other backend is
               validated against; host code on host copies of the graphs.

``n_best == 1`` stores argmin parents; ``n_best > 1`` keeps the K cheapest
paths per state with (node, slot) parents -- the beyond-paper fix for
quantizer state collisions at small gamma, and the DP behind the Pareto
frontier (``frontier.py``).  On CUDA the relaxation of a shape group is one
launch of a hand-written chain kernel (B1 for one slot, B3 for K slots);
the dense backend launches B4 once per layer for a chunk of scenarios.  On
the CPU they run the kernels' plain PyTorch versions in cache-sized
chunks.  The reference's ``jnp`` / ``pallas`` names raise: their float32
engine is the port's ``f32`` backend.

One DP pass yields the best configuration for every candidate final exit,
so accuracy filtering (3c) is a post-pass.  Quantization undershoot
("floor" mode) is handled by an exact post-check of the selected
configuration and, if the true latency violates (3b), re-solving with a
geometrically tightened effective delta -- at most ``max_tighten`` rounds.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .bellman_ford import (DENSE_DTYPES, DEVICE_DENSE_BUDGET_BYTES,
                           batched_banded_relax_argmin,
                           batched_banded_relax_kbest,
                           batched_banded_relax_min,
                           batched_layered_relax_argmin,
                           batched_layered_relax_kbest, device_chunk_rows,
                           layered_relax, relax_chunk_rows)
from .dnn_profile import DNNProfile
from .extended_graph import build_extended_graph, build_extended_graphs
from .feasible_graph import (FeasibleGraph, batch_banded_tensors,
                             batch_layer_tensors, build_feasible_graph,
                             build_feasible_graphs)
from .problem import AppRequirements, Config, ConfigEval, Solution, evaluate_config
from .system_model import Network
from .tolerances import dist_tol

#: solver backend -> relaxation engine.
DP_BACKENDS: Dict[str, str] = {
    "minplus": "banded",
    "banded": "banded",
    "f32": "f32",
    "dense": "dense",
    "numpy": "dense",
    "python": "python",
}

_ENGINE_DTYPE = {"banded": torch.float64, "f32": torch.float32,
                 "dense": torch.float64}


def _engine(backend: str) -> str:
    engine = DP_BACKENDS.get(backend)
    if engine is None:
        raise ValueError(
            f"unknown FIN backend {backend!r}: the port supports "
            f"{sorted(DP_BACKENDS)}; the reference's float32 jnp / pallas "
            f"engines are the port's f32 backend")
    return engine


def _validate_n_best(n_best: int) -> int:
    """``n_best`` is the k-best slot count; a typo'd 0 or -3 raises rather
    than turning into the single-best DP."""
    if n_best < 1:
        raise ValueError(f"n_best must be >= 1, got {n_best}")
    return int(n_best)


class _BandedArgDP:
    """Banded DP result with stored argmin-source-node parents, on the host.

    ``par_n[i-1, n, g]`` is the argmin source node of state (n, g) at block
    i; the parent depth is implied by the band: g - steep[i-1, pn, n].
    """
    __slots__ = ("hist", "par_n", "steep", "dist", "_dmin")

    def __init__(self, hist: np.ndarray, par_n: np.ndarray, steep: np.ndarray):
        self.hist = hist               # (L, N, G+1) float64
        self.par_n = par_n             # (L-1, N, G+1) int32
        self.steep = steep             # (L-1, N, N) float64
        self.dist = hist[..., None]    # (L, N, G+1, 1)
        self._dmin = {}                # block -> min distance (exit prune)

    def parent(self, i: int, n: int, g: int, k: int) -> Tuple[int, int, int]:
        pn = int(self.par_n[i - 1, n, g])
        assert pn >= 0
        return pn, g - int(self.steep[i - 1, pn, n]), 0


class _BandedKDP:
    """Banded k-best DP result with stored (node, slot) parents, on the host.

    ``dist`` is the (L, N, G+1, K) k-slot grid; ``par_n`` / ``par_k``
    (L-1, N, G+1, K) name the source node and slot of each entry, and the
    parent depth is implied by the band: g_src = g - steep[i-1, par_n, n].
    This is the DP state the Pareto frontier's k-best rows come from.
    """
    __slots__ = ("dist", "par_n", "par_k", "steep", "_dmin")

    def __init__(self, hist: np.ndarray, par_n: np.ndarray,
                 par_k: np.ndarray, steep: np.ndarray):
        self.dist = hist               # (L, N, G+1, K) float64
        self.par_n = par_n             # (L-1, N, G+1, K) int32
        self.par_k = par_k             # (L-1, N, G+1, K) int32
        self.steep = steep             # (L-1, N, N) float64
        self._dmin = {}

    def parent(self, i: int, n: int, g: int, k: int) -> Tuple[int, int, int]:
        pn = int(self.par_n[i - 1, n, g, k])
        assert pn >= 0
        return (pn, g - int(self.steep[i - 1, pn, n]),
                int(self.par_k[i - 1, n, g, k]))


class _DPResult:
    """Layered DP over states (block, node, depth) with K slots, on the host.

    dist[i, n, g, k] is the k-th cheapest energy reaching that state;
    par_n / par_g / par_k give the (node, depth, rank) of its predecessor.
    The result of the ``python`` loop DP and of the dense k-best engine.
    """
    __slots__ = ("dist", "par_n", "par_g", "par_k", "_dmin")

    def __init__(self, dist: np.ndarray, par_n: np.ndarray,
                 par_g: np.ndarray, par_k: np.ndarray):
        self.dist = dist               # (L, N, G+1, K) float64
        self.par_n = par_n             # (L, N, G+1, K) int32
        self.par_g = par_g
        self.par_k = par_k
        self._dmin = {}

    def parent(self, i: int, n: int, g: int, k: int) -> Tuple[int, int, int]:
        pn = int(self.par_n[i, n, g, k])
        assert pn >= 0
        return pn, int(self.par_g[i, n, g, k]), int(self.par_k[i, n, g, k])


class _FlatArgDP:
    """Dense DP result with B4's stored parents, on the host (K = 1).

    ``par[i-1, t]`` is the first-occurrence argmin source state of flat
    state t at block i: the column scan over the same float64 sums that the
    reference's lazy ``_FlatDP`` recomputes per backtracked step, so every
    backtrack is identical, and no (L-1, S, S) matrix leaves the device.
    """
    __slots__ = ("hist", "par", "G", "dist", "_dmin")

    def __init__(self, hist: np.ndarray, par: np.ndarray, N: int, G: int):
        self.hist = hist               # (L, S) float64
        self.par = par                 # (L-1, S) int32
        self.G = G
        self.dist = hist.reshape(hist.shape[0], N, G + 1, 1)
        self._dmin = {}

    def parent(self, i: int, n: int, g: int, k: int) -> Tuple[int, int, int]:
        s = int(self.par[i - 1, n * (self.G + 1) + g])
        assert s >= 0
        return s // (self.G + 1), s % (self.G + 1), 0


#: any DP result of this module: backtracked through ``parent`` and
#: scanned through ``dist`` (L, N, G+1, K)
_DPState = Union[_BandedArgDP, _BandedKDP, _FlatArgDP, _DPResult]


def _run_dp(fg: FeasibleGraph, n_best: int = 1) -> _DPResult:
    """The reference's loop DP, the oracle behind ``backend="python"``: host
    code on host copies of the graph tensors."""
    ext = fg.ext
    N, L, G = ext.n_nodes, ext.n_blocks, fg.gamma
    steep = fg.steep.cpu().numpy()
    E = ext.E.cpu().numpy()
    init_E = ext.init_E.cpu().numpy()
    init_depth = fg.init_depth.cpu().numpy()
    K = n_best
    dist = np.full((L, N, G + 1, K), np.inf)
    par_n = np.full((L, N, G + 1, K), -1, dtype=np.int32)
    par_g = np.full((L, N, G + 1, K), -1, dtype=np.int32)
    par_k = np.full((L, N, G + 1, K), -1, dtype=np.int32)

    for n in range(N):
        d0 = init_depth[n]
        if np.isfinite(d0):
            dist[0, n, int(d0), 0] = init_E[n]

    lo = fg.gamma - fg.lam

    def push(i, n2, g2, cand, pn, pg, pk):
        row = dist[i, n2, g2]
        if cand >= row[-1]:
            return
        j = int(np.searchsorted(row, cand))
        dist[i, n2, g2, j + 1:] = row[j:-1]
        par_n[i, n2, g2, j + 1:] = par_n[i, n2, g2, j:-1]
        par_g[i, n2, g2, j + 1:] = par_g[i, n2, g2, j:-1]
        par_k[i, n2, g2, j + 1:] = par_k[i, n2, g2, j:-1]
        dist[i, n2, g2, j] = cand
        par_n[i, n2, g2, j] = pn
        par_g[i, n2, g2, j] = pg
        par_k[i, n2, g2, j] = pk

    for i in range(L - 1):
        st = steep[i]             # (N, N)
        ew = E[i]                 # (N, N)
        for n in range(N):
            for n2 in range(N):
                s = st[n, n2]
                if not np.isfinite(s):
                    continue
                s = int(s)
                cost = ew[n, n2]
                for g in range(G + 1 - s):
                    g2 = g + s
                    if fg.lam < fg.gamma and g2 != g and not (lo <= g2 <= G):
                        continue  # lambda-proximity window (Alg. 1, Fn II)
                    for k in range(K):
                        d = dist[i, n, g, k]
                        if not np.isfinite(d):
                            break
                        push(i + 1, n2, g2, d + cost, n, g, k)
    return _DPResult(dist, par_n, par_g, par_k)


def _dp_from_flat(hist: np.ndarray, par_s: np.ndarray, par_k: np.ndarray,
                  N: int, G: int) -> _DPResult:
    """Reshape flat-state k-best output (L, S, K) into a ``_DPResult``.

    par_s / par_k cover layers 1..L-1 ((L-1, S, K)); layer 0 has no
    parents.
    """
    L, S, K = hist.shape
    dist = hist.reshape(L, N, G + 1, K)
    par_n = np.full((L, S, K), -1, dtype=np.int32)
    par_g = np.full((L, S, K), -1, dtype=np.int32)
    par_k_ = np.full((L, S, K), -1, dtype=np.int32)
    if L > 1:
        valid = par_s >= 0
        np.floor_divide(par_s, G + 1, out=par_n[1:], where=valid,
                        casting="unsafe")
        np.remainder(par_s, G + 1, out=par_g[1:], where=valid,
                     casting="unsafe")
        np.copyto(par_k_[1:], par_k, where=valid, casting="unsafe")
    shape = (L, N, G + 1, K)
    return _DPResult(dist, par_n.reshape(shape), par_g.reshape(shape),
                     par_k_.reshape(shape))


def _relax_dense(fgs: Sequence[FeasibleGraph], K: int
                 ) -> List[Union[_FlatArgDP, _DPResult]]:
    """Relax one same-shape chunk of feasible graphs over their dense
    (S, S) layer matrices, built on the graphs' device: one B4 launch per
    layer on CUDA for K == 1, the plain k-best engine for K > 1; the
    results are copied to the host once."""
    N, G = fgs[0].ext.n_nodes, fgs[0].gamma
    Ws, init = batch_layer_tensors(fgs)
    if K == 1:
        hist, par = batched_layered_relax_argmin(init, Ws)
        del Ws
        hist_h, par_h = hist.cpu().numpy(), par.cpu().numpy()
        return [_FlatArgDP(hist_h[r], par_h[r], N, G)
                for r in range(len(fgs))]
    hist, ps, pk = batched_layered_relax_kbest(init, Ws, K)
    del Ws
    hist_h, ps_h, pk_h = hist.cpu().numpy(), ps.cpu().numpy(), \
        pk.cpu().numpy()
    return [_dp_from_flat(hist_h[r], ps_h[r], pk_h[r], N, G)
            for r in range(len(fgs))]


def _relax_rows(init: torch.Tensor, E: torch.Tensor, steep: torch.Tensor,
                lo: Optional[int], dtype: torch.dtype, K: int
                ) -> List[Union[_BandedArgDP, _BandedKDP]]:
    """Relax stacked scenario rows (one kernel launch on CUDA: the argmin
    chain B1 for K == 1, the k-slot chain B3 for K > 1) and copy the
    results to the host once; one DP object per row."""
    st_h = steep.cpu().numpy()
    if K == 1:
        hist, par = batched_banded_relax_argmin(init, E, steep, lo,
                                                dtype=dtype)
        hist_h = hist.cpu().numpy().astype(np.float64, copy=False)
        par_h = par.cpu().numpy()
        return [_BandedArgDP(hist_h[r], par_h[r], st_h[r])
                for r in range(len(st_h))]
    hist, pn, pk = batched_banded_relax_kbest(init, E, steep, K, lo,
                                              dtype=dtype)
    hist_h = hist.cpu().numpy().astype(np.float64, copy=False)
    pn_h, pk_h = pn.cpu().numpy(), pk.cpu().numpy()
    return [_BandedKDP(hist_h[r], pn_h[r], pk_h[r], st_h[r])
            for r in range(len(st_h))]


def _relax_group(fgs: Sequence[FeasibleGraph], dtype: torch.dtype, K: int
                 ) -> List[Union[_BandedArgDP, _BandedKDP]]:
    """Relax one same-shape chunk of feasible graphs."""
    gE, gst, ginit = batch_banded_tensors(fgs)
    return _relax_rows(ginit, gE, gst, fgs[0].depth_window_lo, dtype, K)


def relax_rows_per_chunk(device: torch.device, L: int, N: int, Gp1: int,
                         K: int, dtype: torch.dtype,
                         engine: str = "banded") -> int:
    """Scenario rows per relaxation chunk.  On CUDA a banded chunk is one
    kernel launch, split only when its outputs (history plus parents) would
    exceed ``DEVICE_RELAX_BUDGET_BYTES``; on the CPU it is cache-resident,
    as in the reference.  A dense chunk counts its inputs too: the
    (L-1, S, S) float64 matrices, the scatter that builds them (an int64
    column and a value per mask entry), the outputs and the per-layer
    candidate tensor of the plain engines (the (S*K, S) pool, its sort and
    indices for K > 1), against ``DEVICE_DENSE_BUDGET_BYTES`` on CUDA.
    No split changes a number."""
    if engine == "dense":
        S = N * Gp1
        row = ((L - 1) * S * S * 8 + (L - 1) * N * S * 16
               + L * S * K * 16 + S * S * K * (8 if K == 1 else 24))
        if device.type == "cuda":
            return device_chunk_rows(row, DEVICE_DENSE_BUDGET_BYTES)
        return relax_chunk_rows(row)
    if device.type == "cuda":
        item = torch.finfo(dtype).bits // 8
        return device_chunk_rows(L * N * Gp1 * K
                                 * (item + (4 if K == 1 else 8)))
    if K == 1:
        return relax_chunk_rows(N * N * Gp1 * (8 + max(L - 1, 1) * 4))
    return relax_chunk_rows(N * N * Gp1 * K * 16)


def _run_dp_batch(fgs: Sequence[FeasibleGraph], n_best: int = 1,
                  backend: str = "minplus") -> List[_DPState]:
    """Batched relaxation for a list of feasible graphs.

    Same-shape scenarios are grouped and each group's banded tensors are
    stacked into one (D, L-1, N, N) chain, relaxed in chunks of
    ``relax_rows_per_chunk`` rows: one kernel launch and one device -> host
    copy per chunk on CUDA.  ``n_best > 1`` runs the k-slot engine.  The
    dense backend scatters each chunk's (D, L-1, S, S) matrices instead;
    ``python`` runs the loop DP per graph.
    """
    K = _validate_n_best(n_best)
    engine = _engine(backend)
    if engine == "python":
        return [_run_dp(fg, K) for fg in fgs]
    dtype = _ENGINE_DTYPE[engine]
    groups: Dict[Tuple[int, int, int, int], List[int]] = {}
    for j, fg in enumerate(fgs):
        groups.setdefault((fg.ext.n_blocks, fg.ext.n_nodes, fg.gamma, fg.lam),
                          []).append(j)
    out: List[Optional[_DPState]] = [None] * len(fgs)
    for (L, N, G, lam), idxs in groups.items():
        chunk = relax_rows_per_chunk(fgs[idxs[0]].steep.device, L, N, G + 1,
                                     K, dtype, engine)
        for start in range(0, len(idxs), chunk):
            part = [fgs[j] for j in idxs[start:start + chunk]]
            dps = (_relax_dense(part, K) if engine == "dense"
                   else _relax_group(part, dtype, K))
            for j, dp in zip(idxs[start:start + chunk], dps):
                out[j] = dp
    return out


def _exit_dmin(dp: _DPState, block: int) -> float:
    """Memoized min DP distance at a block (the exit-prune bound)."""
    v = dp._dmin.get(block)
    if v is None:
        v = dp._dmin[block] = float(dp.dist[block].min())
    return v


def _backtrack(dp, block: int, node: int, depth: int,
               rank: int) -> List[int]:
    place = [node]
    i, n, g, r = block, node, depth, rank
    while i > 0:
        n, g, r = dp.parent(i, n, g, r)
        place.append(n)
        i -= 1
    return place[::-1]


def _configs_at_exit(dp: _DPState, profile: DNNProfile, k: int
                     ) -> List[Tuple[Config, float]]:
    """The reference's eager scan: every DP end state at exit k's block,
    sorted by energy, every path backtracked up front.  Only the ``python``
    oracle backend uses it, as in the reference."""
    block = profile.exits[k].block
    d = dp.dist[block]                      # (N, G+1, K)
    flat = np.argsort(d, axis=None)
    out: List[Tuple[Config, float]] = []
    for idx in flat:
        n, g, r = np.unravel_index(idx, d.shape)
        if not np.isfinite(d[n, g, r]):
            break
        cfg = Config(placement=_backtrack(dp, block, int(n), int(g), int(r)),
                     final_exit=k)
        out.append((cfg, float(d[n, g, r])))
    return out


def _iter_configs_at_exit(dp, profile: DNNProfile, k: int
                          ) -> Iterator[Tuple[Config, float]]:
    """DP end-states at exit k's block, lazily, in energy order.

    Energy weights are not quantized (only latency is), so the DP distance
    is the exact expected energy of the backtracked path.  The cheapest
    state comes first without a sort: ``np.argmin`` and a stable ascending
    argsort share the first-occurrence-of-min tie order.
    """
    block = profile.exits[k].block
    d = dp.dist[block]                      # (N, G+1, K)
    j0 = int(np.argmin(d))
    v0 = float(d.ravel()[j0])
    if not np.isfinite(v0):
        return
    n0, g0, r0 = np.unravel_index(j0, d.shape)
    yield (Config(placement=_backtrack(dp, block, int(n0), int(g0), int(r0)),
                  final_exit=k), v0)
    order = np.argsort(d, axis=None, kind="stable")
    vals = d.ravel()[order]
    n_finite = int(np.searchsorted(vals, np.inf))
    ns_, gs_, rs_ = np.unravel_index(order[:n_finite], d.shape)
    for j in range(1, n_finite):            # order[0] == j0, already yielded
        cfg = Config(placement=_backtrack(dp, block, int(ns_[j]), int(gs_[j]),
                                          int(rs_[j])),
                     final_exit=k)
        yield cfg, float(vals[j])


def _best_feasible(network: Network, profile: DNNProfile,
                   req: AppRequirements, dp,
                   admissible_exits: Sequence[int],
                   check_aggregate_load: bool,
                   bound: Optional[Tuple[Config, ConfigEval]] = None,
                   dist_tol: float = 1e-9, oracle: bool = False,
                   candidates=None
                   ) -> Optional[Tuple[Config, ConfigEval]]:
    """Exact (3a)-(3e) post-pass: cheapest feasible config over all exits.

    Configs are backtracked lazily, and an exit is skipped when its cheapest
    graph state cannot beat the incumbent (or the bounding pass's energy):
    the graph distance IS the exact path energy, and the ``dist_tol``
    relative guard keeps rounding near-ties evaluated exactly.  ``bound``
    carries the bounding pass's (config, eval) pair, reused when a scanned
    candidate is that configuration.  ``oracle=True`` is the reference's
    seed pipeline (the ``python`` backend): eager per-exit config lists and
    no exit pruning.  ``candidates`` optionally replaces the lazy per-exit
    iteration: ``k -> iterator of (Config, graph_energy)`` yielding exactly
    the ``_iter_configs_at_exit`` sequence (the population engine's
    per-state candidate cache).
    """
    bound_energy = bound[1].energy if bound is not None else None
    found: Optional[Tuple[Config, ConfigEval]] = None
    for k in admissible_exits:
        best_e = found[1].energy if found is not None else bound_energy
        if not oracle and best_e is not None:
            if _exit_dmin(dp, profile.exits[k].block) > best_e * (1 + dist_tol):
                continue
        if oracle:
            configs = _configs_at_exit(dp, profile, k)
        elif candidates is not None:
            configs = candidates(k)
        else:
            configs = _iter_configs_at_exit(dp, profile, k)
        for cfg, _graph_e in configs:
            if (bound is not None and cfg.final_exit == bound[0].final_exit
                    and cfg.placement == bound[0].placement):
                ev = bound[1]
            else:
                ev = evaluate_config(
                    network, profile, req, cfg,
                    check_aggregate_load=check_aggregate_load)
            if ev.feasible:
                if found is None or ev.energy < found[1].energy:
                    found = (cfg, ev)
                break  # states are energy-sorted: first feasible is best at k
    return found


def _admissible(profile: DNNProfile, req: AppRequirements) -> List[int]:
    return [k for k in range(profile.n_exits)
            if profile.accuracy_of(k) >= req.alpha - 1e-12]


def solve_fin(network: Network, profile: DNNProfile, req: AppRequirements,
              *, gamma: int = 10, lam: Optional[int] = None,
              quantize: str = "floor", max_tighten: int = 6,
              tighten_factor: float = 0.85, n_best: int = 1,
              backend: str = "minplus",
              check_aggregate_load: bool = False,
              device: DeviceLike = None) -> Solution:
    """FIN (Alg. 1).  Returns the min-energy feasible configuration.

    ``n_best > 1`` keeps the K cheapest paths per (node, depth) state.
    ``device`` defaults to ``cuda:0`` (raising where there is none);
    ``device="cpu"`` runs the plain PyTorch path.
    """
    t0 = time.perf_counter()
    _validate_n_best(n_best)
    tol = dist_tol(_engine(backend))
    dev = resolve_device(device)
    ext = build_extended_graph(network, profile, req, device=dev)

    admissible_exits = _admissible(profile, req)
    if not admissible_exits:
        return Solution(config=None, eval=None,
                        solve_time=time.perf_counter() - t0, solver="fin",
                        meta={"reason": "no exit meets alpha (3c)"})

    def _solve_once(q: str, d_eff: float,
                    bound: Optional[Tuple[Config, ConfigEval]] = None
                    ) -> Optional[Tuple[Config, ConfigEval]]:
        fg = build_feasible_graph(ext, gamma, lam=lam, quantize=q,
                                  delta_eff=d_eff)
        dp = _run_dp_batch([fg], n_best, backend)[0]
        return _best_feasible(network, profile, req, dp, admissible_exits,
                              check_aggregate_load, bound=bound,
                              dist_tol=tol, oracle=backend == "python")

    delta_eff = req.delta
    best: Optional[Tuple[Config, ConfigEval]] = None
    meta = {"gamma": gamma, "quantize": quantize, "tighten_rounds": 0,
            "backend": backend}
    for round_ in range(max_tighten + 1):
        best = _solve_once(quantize, delta_eff)
        if best is not None:
            break
        # quantization undershoot: tighten the effective latency budget
        delta_eff *= tighten_factor
        meta["tighten_rounds"] = round_ + 1
    if quantize != "ceil":
        # conservative pass: ceil quantization is feasible by construction
        # and can rescue state-collision misses of the optimistic quantizer
        alt = _solve_once("ceil", req.delta, best)
        if alt is not None and (best is None or alt[1].energy < best[1].energy):
            best = alt
            meta["used_ceil_pass"] = True

    dt = time.perf_counter() - t0
    if best is None:
        return Solution(config=None, eval=None, solve_time=dt, solver="fin",
                        meta={**meta, "reason": "no feasible path"})
    cfg, ev = best
    meta["delta_eff"] = delta_eff
    meta["n_feasible_states"] = int(np.isfinite(ev.energy))
    return Solution(config=cfg, eval=ev, solve_time=dt, solver="fin", meta=meta)


def _broadcast_scenarios(profiles, networks, requirements
                         ) -> Tuple[List[DNNProfile], List[Network],
                                    List[AppRequirements]]:
    def listify(x, single) -> list:
        return list(x) if not isinstance(x, single) else [x]

    ps = listify(profiles, DNNProfile)
    ns = listify(networks, Network)
    rs = listify(requirements, AppRequirements)
    B = max(len(ps), len(ns), len(rs))
    out = []
    for name, xs in (("profiles", ps), ("networks", ns),
                     ("requirements", rs)):
        if len(xs) == 1:
            xs = xs * B
        if len(xs) != B:
            raise ValueError(f"solve_many: {name} has length {len(xs)}, "
                             f"expected 1 or {B}")
        out.append(xs)
    return tuple(out)


def solve_many(profiles: Union[DNNProfile, Sequence[DNNProfile]],
               networks: Union[Network, Sequence[Network]],
               requirements: Union[AppRequirements, Sequence[AppRequirements]],
               *, gamma: int = 10, lam: Optional[int] = None,
               quantize: str = "floor", max_tighten: int = 6,
               tighten_factor: float = 0.85, n_best: int = 1,
               backend: str = "minplus",
               check_aggregate_load: bool = False,
               device: DeviceLike = None) -> List[Solution]:
    """Batched FIN: solve B scenarios with one stacked relaxation per shape.

    Arguments broadcast: each of ``profiles`` / ``networks`` /
    ``requirements`` may be a single object or a length-B sequence.  Returns
    one ``Solution`` per scenario, equal to what ``solve_fin`` returns for
    it.  Extended graphs are deduplicated across scenarios that share
    (network, profile, sigma); the tighten loop re-batches the still
    unsolved scenarios each round, and the ceil rescue pass (which never
    depends on the tighten loop) rides in round 0's relaxation.
    """
    t0 = time.perf_counter()
    _validate_n_best(n_best)
    tol = dist_tol(_engine(backend))
    dev = resolve_device(device)
    profs, nets, reqs = _broadcast_scenarios(profiles, networks, requirements)
    B = len(profs)

    exts = build_extended_graphs(nets, profs, reqs, device=dev)
    admissible = [_admissible(pf, rq) for pf, rq in zip(profs, reqs)]

    metas = [{"gamma": gamma, "quantize": quantize, "tighten_rounds": 0,
              "backend": backend, "batch_size": B} for _ in range(B)]
    best: List[Optional[Tuple[Config, ConfigEval]]] = [None] * B

    def _scan(b: int, dp, bound: Optional[Tuple[Config, ConfigEval]] = None
              ) -> Optional[Tuple[Config, ConfigEval]]:
        return _best_feasible(nets[b], profs[b], reqs[b], dp, admissible[b],
                              check_aggregate_load, bound=bound, dist_tol=tol,
                              oracle=backend == "python")

    def _fgs(bs: List[int], qmode: str, d_effs: List[float]
             ) -> List[FeasibleGraph]:
        return build_feasible_graphs([exts[b] for b in bs], gamma, lam=lam,
                                     quantize=qmode, delta_effs=d_effs)

    active = [b for b in range(B) if admissible[b]]
    delta_eff = [rq.delta for rq in reqs]
    pending = list(active)
    ceil_dps: Dict[int, _DPState] = {}
    for round_ in range(max_tighten + 1):
        if not pending:
            break
        fgs = _fgs(pending, quantize, [delta_eff[b] for b in pending])
        if round_ == 0 and quantize != "ceil":
            # one (2B, L-1, N, N) relaxation per shape for round 0 and the
            # ceil rescue pass
            fgs += _fgs(active, "ceil", [reqs[b].delta for b in active])
        dps = _run_dp_batch(fgs, n_best, backend)
        if round_ == 0 and quantize != "ceil":
            ceil_dps = dict(zip(active, dps[len(pending):]))
        still = []
        for b, dp in zip(pending, dps[:len(pending)]):
            f = _scan(b, dp)
            if f is not None:
                best[b] = f
            else:
                delta_eff[b] *= tighten_factor
                metas[b]["tighten_rounds"] = round_ + 1
                still.append(b)
        pending = still
    if quantize != "ceil":
        for b in active:
            f = _scan(b, ceil_dps[b], best[b])
            if f is not None and (best[b] is None
                                  or f[1].energy < best[b][1].energy):
                best[b] = f
                metas[b]["used_ceil_pass"] = True

    dt = time.perf_counter() - t0
    out: List[Solution] = []
    for b in range(B):
        if not admissible[b]:
            out.append(Solution(config=None, eval=None, solve_time=dt / B,
                                solver="fin",
                                meta={"reason": "no exit meets alpha (3c)",
                                      "batch_size": B, "batch_time": dt}))
            continue
        meta = {**metas[b], "batch_time": dt}
        if best[b] is None:
            out.append(Solution(config=None, eval=None, solve_time=dt / B,
                                solver="fin",
                                meta={**meta, "reason": "no feasible path"}))
            continue
        cfg, ev = best[b]
        meta["delta_eff"] = delta_eff[b]
        meta["n_feasible_states"] = int(np.isfinite(ev.energy))
        out.append(Solution(config=cfg, eval=ev, solve_time=dt / B,
                            solver="fin", meta=meta))
    return out


def fin_all_exit_costs(network: Network, profile: DNNProfile,
                       req: AppRequirements, *, gamma: int = 10,
                       lam: Optional[int] = None, quantize: str = "floor",
                       backend: str = "numpy",
                       device: DeviceLike = None) -> np.ndarray:
    """Graph cost (not exact eval) per exit -- the relaxation of the paper's
    Table VII scaling path.  ``banded`` relaxes the compact (N, G+1) grid in
    float64 (B1); ``numpy`` / ``dense`` scatter the dense (L-1, S, S)
    matrices first and relax them in float64, one B5 launch per layer;
    ``f32`` does the same in float32, the counterpart of the reference's
    ``jnp`` / ``pallas``."""
    if backend != "banded" and backend not in DENSE_DTYPES:
        raise ValueError(f"unknown backend {backend!r} (expected banded or "
                         f"one of {sorted(DENSE_DTYPES)})")
    ext = build_extended_graph(network, profile, req, device=device)
    fg = build_feasible_graph(ext, gamma, lam=lam, quantize=quantize)
    if backend == "banded":
        E, steep = fg.banded_tensors()
        hist = batched_banded_relax_min(fg.init_grid()[None], E[None],
                                        steep[None], fg.depth_window_lo)
        dist = hist[0].reshape(hist.shape[1], -1)         # (L, N*(G+1))
    else:
        dist = layered_relax(fg.init_vector(), fg.layer_matrices(), backend)
    dist = dist.cpu().numpy()
    out = np.full(profile.n_exits, np.inf)
    for k, e in enumerate(profile.exits):
        out[k] = dist[e.block].min()
    return out
