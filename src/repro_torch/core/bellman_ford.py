"""(min,+) relaxation engines behind FIN's traversal.

Port of ``repro/core/bellman_ford.py``.  Two families, as in the reference:

  * dense  -- (S, S) flattened-state layer matrices, S = N * (G+1): one
              dense (min,+) product per layer, on CUDA a launch of the
              hand-written B5 kernel (distances only) or B4 (with the
              first-occurrence argmin); kept for equivalence testing, for
              the paper's Table VII scaling path (``fin_all_exit_costs``)
              and as the k-best oracle;
  * banded -- the compact (N, G+1) grid (below).

Which engine is bit-exact against which reference engine: in float64,
``minplus_vecmat`` / ``bellman_ford`` / ``layered_relax(backend="numpy")``
/ ``batched_layered_relax_argmin`` / ``batched_layered_relax_min`` /
``batched_layered_relax_kbest`` equal the reference's numpy ones
(``minplus_vecmat_np``, ``bellman_ford_np``, ``layered_relax("numpy")``,
``batched_layered_relax_argmin("numpy")``, ``batched_layered_relax_min``,
``batched_layered_relax_kbest``) bit for bit: every candidate is one IEEE
add, the min does not depend on order, the argmin is the first occurrence,
and the k-best pool is sorted stably.  The ``f32`` backend is the
counterpart of the reference's ``jnp`` / ``pallas`` dense backends (the
same single float32 add per candidate as ``minplus_pallas``).  The banded
engines equal the dense ones in float64 (same candidate sets, same adds,
same tie order).

The feasible graph's transitions are banded in depth: an edge only
connects (n, g) to (n', g + steep[n, n']), so a layer is a shift-by-steep
gather + min over source nodes on the compact (N, G+1) grid:

  new[n', g'] = min_n  dist[n, g' - steep[n, n']] + E[n, n']

(inadmissible where g' - steep < 0, the edge is pruned, or the
lambda-proximity window excludes g').  On CUDA the whole (B, L) chain runs
in one launch of a hand-written kernel (``kernels/minplus``); on the CPU
the same wrapper runs its plain PyTorch version.  The argmin engine stores
the first-occurrence argmin source node as the parent, so float64
distances and parents are bit-equal to the reference's
``batched_banded_relax_minarg`` and float32 ones to its
``batched_banded_relax_argmin(backend="jnp")``.  The k-slot engine keeps
the K cheapest (value, source node, source slot) per state in the order of
a stable sort of the node-major, slot-minor pool, bit-equal in float64 to
the reference's ``batched_banded_relax_kbest``.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.minplus import ops as mp
from ..kernels.minplus.ops import (banded_minplus_chain_history,
                                   banded_minplus_chain_kbest)
from ..kernels.minplus.ref import banded_gather_idx

# ---------------------------------------------------------------------------
# chunking of batched relaxations
# ---------------------------------------------------------------------------

#: default per-chunk budget of a CPU relaxation's candidate tensor; override
#: with the REPRO_RELAX_CHUNK_BYTES environment variable.
_RELAX_CHUNK_BYTES_DEFAULT = 4 << 20

#: device-memory budget of one CUDA chain launch's outputs (history plus
#: parents).  A shape group relaxes in one launch unless its outputs exceed
#: it; the split changes no number.
DEVICE_RELAX_BUDGET_BYTES = 4 << 30

#: device-memory budget of one dense relaxation chunk: its (S, S) layer
#: matrices, the scatter that builds them and its outputs.  At gamma = 25
#: the h1-h4 group of the 15,360-scenario grid (20,480 rows of 540,800 B of
#: matrices each) relaxes as one chunk; the split changes no number.
DEVICE_DENSE_BUDGET_BYTES = 16 << 30


def relax_chunk_bytes() -> int:
    """Cache-residency budget (bytes) for one CPU relaxation chunk.

    A set-but-invalid REPRO_RELAX_CHUNK_BYTES raises immediately (an unset
    or empty variable means the default).
    """
    raw = os.environ.get("REPRO_RELAX_CHUNK_BYTES", "")
    if not raw:
        return _RELAX_CHUNK_BYTES_DEFAULT
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"REPRO_RELAX_CHUNK_BYTES must be a positive integer (bytes), "
            f"got {raw!r}") from None
    if val <= 0:
        raise ValueError(
            f"REPRO_RELAX_CHUNK_BYTES must be a positive integer (bytes), "
            f"got {raw!r}")
    return val


def relax_chunk_rows(bytes_per_row: int) -> int:
    """Scenario rows per cache-resident CPU relaxation chunk (at least 1)."""
    if bytes_per_row <= 0:
        raise ValueError(f"bytes_per_row must be positive, got "
                         f"{bytes_per_row!r}")
    return max(1, relax_chunk_bytes() // bytes_per_row)


def device_chunk_rows(bytes_per_row: int,
                      budget: int = DEVICE_RELAX_BUDGET_BYTES) -> int:
    """Scenario rows per CUDA relaxation chunk under ``budget`` bytes."""
    if bytes_per_row <= 0:
        raise ValueError(f"bytes_per_row must be positive, got "
                         f"{bytes_per_row!r}")
    return max(1, budget // bytes_per_row)


# ---------------------------------------------------------------------------
# dense relaxation over (S, S) layer matrices
# ---------------------------------------------------------------------------

#: dense backend -> working dtype: ``numpy`` / ``dense`` are the exact
#: float64 engines, ``f32`` the counterpart of the reference's jnp / pallas
DENSE_DTYPES = {"numpy": torch.float64, "dense": torch.float64,
                "f32": torch.float32}


def _dense_dtype(backend: str) -> torch.dtype:
    dtype = DENSE_DTYPES.get(backend)
    if dtype is None:
        raise ValueError(f"unknown dense backend {backend!r} (expected one "
                         f"of {sorted(DENSE_DTYPES)})")
    return dtype


def minplus_vecmat(dist: torch.Tensor, W: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """out[t] = min_s dist[s] + W[s, t] and its argmin s, through B4.

    dist: (S,); W: (S, T) in dist's dtype.  The reference's
    ``minplus_vecmat_np``; arg is -1 where t is unreached (the numpy
    version leaves index 0 there, which means nothing).
    """
    out, arg = mp.minplus_vecmat_argmin(dist[None].contiguous(),
                                        W.contiguous())
    return out[0], arg[0]


def bellman_ford(W: torch.Tensor, src: int, *,
                 max_iters: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classic dense Bellman-Ford on an (S, S) weight matrix (inf = no edge).

    Returns (dist (S,) float64, parent (S,) int64, -1 where never
    improved), one B4 launch per iteration, with the reference's
    ``new < dist - 1e-18`` improvement rule.
    """
    S = W.shape[0]
    Wk = W.to(torch.float64).contiguous()
    dist = torch.full((S,), float("inf"), dtype=torch.float64,
                      device=W.device)
    parent = torch.full((S,), -1, dtype=torch.int64, device=W.device)
    dist[src] = 0.0
    iters = max_iters if max_iters is not None else S - 1
    for _ in range(iters):
        new, arg = minplus_vecmat(dist, Wk)
        improved = new < dist - 1e-18
        if not bool(improved.any()):
            break
        parent = torch.where(improved, arg.long(), parent)
        dist = torch.where(improved, new, dist)
    return dist, parent


def layered_relax(init: torch.Tensor, Ws: torch.Tensor,
                  backend: str = "numpy") -> torch.Tensor:
    """Relax through a stack of layer matrices: one B5 launch per layer.

    init: (S,); Ws: (L, S, S).  Returns (L+1, S) distances after each layer
    in the backend's dtype (float64 for ``numpy`` / ``dense``, float32 for
    ``f32``).
    """
    dtype = _dense_dtype(backend)
    d = init.to(dtype).contiguous()
    Wk = Ws.to(dtype).contiguous()
    hist = [d]
    for l in range(Wk.shape[0]):
        d = mp.minplus_vecmat(d[None], Wk[l])[0]
        hist.append(d)
    return torch.stack(hist)


def layered_relax_argmin(init: torch.Tensor, Ws: torch.Tensor,
                         backend: str = "numpy"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-scenario view of :func:`batched_layered_relax_argmin`:
    init (S,), Ws (L, S, S) -> (dist (L+1, S), parent (L, S))."""
    hist, par = batched_layered_relax_argmin(init[None], Ws[None], backend)
    return hist[0], par[0]


def batched_layered_relax_argmin(init: torch.Tensor, Ws: torch.Tensor,
                                 backend: str = "numpy"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched layered relaxation with parents: one (min,+) chain per row.

    init: (B, S); Ws: (B, L, S, S).  Returns (dist (B, L+1, S) in the
    backend's dtype, parent (B, L, S) int32, -1 where the target state is
    unreachable).  One B4 launch per layer relaxes every row against its
    own matrix (the layer of the stack, read in place).
    """
    dtype = _dense_dtype(backend)
    B, S = init.shape
    L = Ws.shape[1]
    hist = torch.empty((B, L + 1, S), dtype=dtype, device=init.device)
    par = torch.empty((B, L, S), dtype=torch.int32, device=init.device)
    d = init.to(dtype).contiguous()
    hist[:, 0] = d
    Wk = Ws.to(dtype).contiguous()
    for l in range(L):
        d, arg = mp.minplus_vecmat_argmin(d, Wk[:, l])
        hist[:, l + 1] = d
        par[:, l] = arg
    return hist, par


def batched_layered_relax_min(init: torch.Tensor, Ws: torch.Tensor
                              ) -> torch.Tensor:
    """Batched float64 layered relaxation, distances only, through B5.

    init: (B, S); Ws: (B, L, S, S).  Returns dist (B, L+1, S).
    """
    B, S = init.shape
    L = Ws.shape[1]
    hist = torch.empty((B, L + 1, S), dtype=torch.float64,
                       device=init.device)
    d = init.to(torch.float64).contiguous()
    hist[:, 0] = d
    Wk = Ws.to(torch.float64).contiguous()
    for l in range(L):
        d = mp.minplus_vecmat(d, Wk[:, l])
        hist[:, l + 1] = d
    return hist


def batched_layered_relax_kbest(init: torch.Tensor, Ws: torch.Tensor, K: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Keep the K cheapest paths per state while relaxing layer by layer.

    init: (B, S); Ws: (B, L, S, S).  Returns (dist (B, L+1, S, K) float64,
    par_s, par_k (B, L, S, K) int32): the k-th cheapest distance at each
    state with the (source state, source rank) that produced it, -1 where
    unused.  Each layer sorts the S*K candidate pool per target stably
    (source-state-major, rank-minor), as the reference's numpy engine does.
    Plain PyTorch on every device: the dense k-best oracle, no kernel.
    """
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    B, S = init.shape
    L = Ws.shape[1]
    dist = torch.full((B, S, K), float("inf"), dtype=torch.float64,
                      device=init.device)
    dist[:, :, 0] = init
    if L == 0:
        none = torch.zeros((B, 0, S, K), dtype=torch.int32,
                           device=init.device)
        return dist[:, None], none, none.clone()
    hist, ps, pk = [dist], [], []
    for l in range(L):
        # (B, S, K, T) candidate pool -> the K smallest per (B, T)
        cand = (dist[:, :, :, None] + Ws[:, l, :, None, :]).reshape(
            B, S * K, S)
        val, idx = torch.sort(cand, dim=1, stable=True)
        new = val[:, :K].transpose(1, 2)                 # (B, T, K)
        src = idx[:, :K].transpose(1, 2)
        ok = torch.isfinite(new)
        ps.append(torch.where(ok, src // K, -1))
        pk.append(torch.where(ok, src % K, -1))
        hist.append(new)
        dist = new
    return (torch.stack(hist, dim=1), torch.stack(ps, dim=1).int(),
            torch.stack(pk, dim=1).int())


# ---------------------------------------------------------------------------
# banded relaxation
# ---------------------------------------------------------------------------

def _banded_gather_idx(steep: torch.Tensor, Gp1: int,
                       lo: Optional[int]) -> torch.Tensor:
    """(..., N, N, G+1) int32 source-depth gather indices for banded layers.

    steep: (..., N, N) float steepness (inf = pruned).  Index g - steep per
    target depth g; every inadmissible candidate (pruned edge, negative
    source depth, lambda window) is routed to the sentinel index ``Gp1``,
    the +inf column of a padded distance grid.
    """
    finite = torch.isfinite(steep)
    # sentinel Gp1 steepness makes every source depth negative -> inf column
    sti = torch.where(finite, steep, float(Gp1)).to(torch.int32)
    return banded_gather_idx(sti, Gp1, lo)


def kernel_inputs(E: torch.Tensor, steep: torch.Tensor, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, st) in the kernel's form: E in ``dtype`` with +inf on pruned
    edges, st int32 with 0 there.  The mask comes first: casting an
    infinite steepness to int32 is undefined."""
    finite = torch.isfinite(steep)
    st = torch.where(finite, steep, 0.0).to(torch.int32).contiguous()
    Ek = torch.where(finite, E, float("inf")).to(dtype).contiguous()
    return Ek, st


def batched_banded_relax_argmin(init: torch.Tensor, E: torch.Tensor,
                                steep: torch.Tensor,
                                lo: Optional[int] = None, *,
                                dtype: torch.dtype = torch.float64
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Banded relaxation with argmin-over-source-node parents.

    init: (B, N, G+1); E/steep: (B, L, N, N) float64 (steep: integer values
    or inf).  ``dtype`` is the relaxation's working type: float64 (exact,
    the ``minplus`` backend) or float32 (the ``f32`` backend).  Returns
    (hist (B, L+1, N, G+1) in ``dtype`` with the init grid at index 0, and
    par_n (B, L, N, G+1) int32, -1 where unreachable).  The parent depth is
    implied by the band: g_src = g - steep[par_n, n].  On CUDA it is one
    launch of B1, which writes the init row itself.
    """
    B, N, Gp1 = init.shape
    L = E.shape[1]
    initk = init.to(dtype).contiguous()
    if L == 0:                       # single-block chain: no transitions
        return (initk[:, None],
                torch.zeros((B, 0, N, Gp1), dtype=torch.int32,
                            device=init.device))
    Ek, st = kernel_inputs(E, steep, dtype)
    return banded_minplus_chain_history(initk, Ek, st, lo=lo)


def batched_banded_relax_kbest(init: torch.Tensor, E: torch.Tensor,
                               steep: torch.Tensor, K: int,
                               lo: Optional[int] = None, *,
                               dtype: torch.dtype = torch.float64
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Banded k-slot relaxation: the K cheapest paths per (node, depth).

    init: (B, N, G+1); E/steep: (B, L, N, N) float64 (steep: integer values
    or inf).  Returns (hist (B, L+1, N, G+1, K) in ``dtype``, with the init
    grid in slot 0 of index 0 and +inf in its other slots, and par_n / par_k
    (B, L, N, G+1, K) int32, -1 where a slot is unused).  The parent depth
    is implied by the band: g_src = g - steep[par_n, n].  In float64 the
    distances and slot order are bit-equal to the reference's
    ``batched_banded_relax_kbest``; on CUDA the chain is one launch of the
    k-slot kernel (B3).
    """
    B, N, Gp1 = init.shape
    L = E.shape[1]
    initk = init.to(dtype).contiguous()
    first = torch.full((B, 1, N, Gp1, K), float("inf"), dtype=dtype,
                       device=init.device)
    first[:, 0, :, :, 0] = initk
    if L == 0:                       # single-block chain: no transitions
        none = torch.zeros((B, 0, N, Gp1, K), dtype=torch.int32,
                           device=init.device)
        return first, none, none.clone()
    Ek, st = kernel_inputs(E, steep, dtype)
    hist, par_n, par_k = banded_minplus_chain_kbest(initk, Ek, st, K, lo=lo)
    return torch.cat([first, hist], dim=1), par_n, par_k


def batched_banded_relax_minarg(init: torch.Tensor, E: torch.Tensor,
                                steep: torch.Tensor, lo: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float64 banded relaxation with stored parents (the reference's
    ``batched_banded_relax_minarg`` contract, int32 parents)."""
    return batched_banded_relax_argmin(init, E, steep, lo,
                                       dtype=torch.float64)


def batched_banded_relax_min(init: torch.Tensor, E: torch.Tensor,
                             steep: torch.Tensor, lo: Optional[int] = None
                             ) -> torch.Tensor:
    """Float64 banded relaxation, distances only: hist (B, L+1, N, G+1)."""
    return batched_banded_relax_minarg(init, E, steep, lo)[0]


def banded_parent_np(dist_prev: np.ndarray, E_l: np.ndarray,
                     st_l: np.ndarray, n: int, g: int, lo: Optional[int]
                     ) -> Tuple[int, int]:
    """Recover the argmin parent of target state (n, g) for one layer.

    Host helper on numpy copies.  dist_prev: (N, G+1) previous-layer
    distances; E_l / st_l: (N, N).  Returns (parent node, parent depth):
    the first-occurrence argmin over source nodes, the tie order of the
    dense flat-state column argmin.
    """
    st = st_l[:, n]                                      # (N,)
    finite = np.isfinite(st)
    sti = np.where(finite, st, 0).astype(np.int64)
    gsrc = g - sti
    ok = finite & (gsrc >= 0)
    if lo is not None:
        ok &= (g >= lo) | (sti == 0)
    cand = np.where(ok, dist_prev[np.arange(len(st)), np.where(ok, gsrc, 0)]
                    + E_l[:, n], np.inf)
    pn = int(np.argmin(cand))
    return pn, g - int(sti[pn])
