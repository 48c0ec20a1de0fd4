"""Depth-banded (min,+) relaxation engines behind FIN's traversal.

Port of the banded half of ``repro/core/bellman_ford.py``.  The feasible
graph's transitions are banded in depth: an edge only connects (n, g) to
(n', g + steep[n, n']), so a layer is a shift-by-steep gather + min over
source nodes on the compact (N, G+1) grid:

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

import torch

from ..kernels.minplus.ops import (banded_minplus_chain,
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


def device_chunk_rows(bytes_per_row: int) -> int:
    """Scenario rows per CUDA chain launch under DEVICE_RELAX_BUDGET_BYTES."""
    if bytes_per_row <= 0:
        raise ValueError(f"bytes_per_row must be positive, got "
                         f"{bytes_per_row!r}")
    return max(1, DEVICE_RELAX_BUDGET_BYTES // bytes_per_row)


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
    implied by the band: g_src = g - steep[par_n, n].
    """
    B, N, Gp1 = init.shape
    L = E.shape[1]
    initk = init.to(dtype).contiguous()
    if L == 0:                       # single-block chain: no transitions
        return (initk[:, None],
                torch.zeros((B, 0, N, Gp1), dtype=torch.int32,
                            device=init.device))
    Ek, st = kernel_inputs(E, steep, dtype)
    hist, par = banded_minplus_chain(initk, Ek, st, lo=lo)
    return torch.cat([initk[:, None], hist], dim=1), par


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
