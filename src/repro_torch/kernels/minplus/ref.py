"""Plain PyTorch versions of the minplus kernels.

The banded ones follow the float64 numpy engines of the reference
(``repro/core/bellman_ford.py:347-511``): gather every candidate from a
distance grid padded with one +inf sentinel column and add the edge energy
(one IEEE add per candidate); then take the min and the first-occurrence
argmin over the source-node axis (B1), or keep the first K of a stable
ascending sort of the source-node-major, slot-minor pool (B3).  The dense
ones (B5, B4) form every candidate ``dist[b, s] + W[s, t]`` and take the
min and the first-occurrence argmin over s.  The CPU path of the port runs
on them, and the CUDA kernels are held bit-equal to them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def banded_gather_idx(st: torch.Tensor, Gp1: int,
                      lo: Optional[int]) -> torch.Tensor:
    """(..., N, N, G+1) int32 source-depth indices for integer steepness.

    Index ``g - st`` per target depth g; a negative source depth, or a
    target outside the lambda window (``g < lo`` on a non-flat edge), is
    routed to the sentinel index ``Gp1`` (the +inf column).
    """
    g = torch.arange(Gp1, dtype=torch.int32, device=st.device)
    sti = st.to(torch.int32)[..., None]
    idx = g - sti
    if lo is not None:
        idx = torch.where((g < lo) & (sti != 0), -1, idx)
    return torch.where(idx < 0, Gp1, idx)


def banded_minplus_chain_ref(dist: torch.Tensor, E: torch.Tensor,
                             st: torch.Tensor, *, lo: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chained banded relaxation (plain version of the B1 kernel).

    dist: [B, N, G+1]; E: [B, L, N, N] (+inf = pruned); st: [B, L, N, N]
    int steepness.  Returns (hist [B, L, N, G+1] in dist's dtype, the grid
    after each layer, and arg [B, L, N, G+1] int32, the first-occurrence
    argmin source node, -1 where unreachable).
    """
    B, N, Gp1 = dist.shape
    L = E.shape[1]
    hist = torch.empty((B, L, N, Gp1), dtype=dist.dtype, device=dist.device)
    arg = torch.empty((B, L, N, Gp1), dtype=torch.int32, device=dist.device)
    pad = torch.full((B, N, 1, Gp1 + 1), float("inf"), dtype=dist.dtype,
                     device=dist.device)
    d = dist
    for l in range(L):
        pad[:, :, 0, :Gp1] = d
        idx = banded_gather_idx(st[:, l], Gp1, lo).long()   # (B, N, N, G+1)
        cand = torch.gather(pad.expand(B, N, N, Gp1 + 1), 3, idx)
        cand = cand + E[:, l, :, :, None]                    # (B, src, tgt, G+1)
        d = cand.amin(dim=1)
        a = cand.argmin(dim=1)
        hist[:, l] = d
        arg[:, l] = torch.where(torch.isfinite(d), a, -1)
    return hist, arg


def banded_minplus_ref(dist: torch.Tensor, E: torch.Tensor, st: torch.Tensor,
                       *, lo: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One banded layer (plain version of the B1u kernel).

    dist: [N, G+1]; E: [N, N] (+inf = pruned); st: [N, N] int steepness ->
    (out [N, G+1], argmin source node [N, G+1] int32, -1 unreachable).
    """
    hist, arg = banded_minplus_chain_ref(dist[None], E[None, None],
                                         st[None, None], lo=lo)
    return hist[0, 0], arg[0, 0]


def banded_minplus_chain_kbest_ref(dist: torch.Tensor, E: torch.Tensor,
                                   st: torch.Tensor, K: int, *,
                                   lo: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Chained banded k-slot relaxation (plain version of the B3 kernel).

    dist: [B, N, G+1] init grids (slot 0; the other K-1 slots start at
    +inf); E: [B, L, N, N] (+inf = pruned); st: [B, L, N, N] int steepness.
    Returns (hist [B, L, N, G+1, K] in dist's dtype, the k-slot grid after
    each layer, and par_n / par_k [B, L, N, G+1, K] int32, -1 where a slot
    is unused).  Per target state the pool is (source node, source slot) in
    node-major, slot-minor order; a stable sort keeps its K smallest, as the
    reference's ``batched_banded_relax_kbest`` does.
    """
    B, N, Gp1 = dist.shape
    L = E.shape[1]
    shape = (B, L, N, Gp1, K)
    hist = torch.empty(shape, dtype=dist.dtype, device=dist.device)
    par_n = torch.empty(shape, dtype=torch.int32, device=dist.device)
    par_k = torch.empty(shape, dtype=torch.int32, device=dist.device)
    pad = torch.full((B, N, Gp1 + 1, K), float("inf"), dtype=dist.dtype,
                     device=dist.device)
    pad[:, :, :Gp1, 0] = dist
    for l in range(L):
        idx = banded_gather_idx(st[:, l], Gp1, lo).long()   # (B, N, N, G+1)
        cand = torch.gather(pad[:, :, None].expand(B, N, N, Gp1 + 1, K), 3,
                            idx[..., None].expand(B, N, N, Gp1, K))
        cand = cand + E[:, l, :, :, None, None]         # (B, src, tgt, G+1, K)
        pool = cand.permute(0, 1, 4, 2, 3).reshape(B, N * K, N, Gp1)
        val, sel = torch.sort(pool, dim=1, stable=True)
        d = val[:, :K].permute(0, 2, 3, 1)               # (B, N, G+1, K)
        src = sel[:, :K].permute(0, 2, 3, 1)
        ok = torch.isfinite(d)
        hist[:, l] = d
        par_n[:, l] = torch.where(ok, src // K, -1)
        par_k[:, l] = torch.where(ok, src % K, -1)
        pad[:, :, :Gp1] = d
    return hist, par_n, par_k


def _missing_to_inf(x: torch.Tensor) -> torch.Tensor:
    """Non-finite entries (+inf, -inf, NaN) are missing edges: +inf."""
    return torch.where(torch.isfinite(x), x, float("inf"))


def minplus_ref(dist: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Dense (min,+) product (plain version of the B5 kernel).

    dist: [B, S]; W: [S, T] shared by every row, or [B, S, T], one matrix
    per row.  Returns out [B, T] in dist's dtype: ``min_s dist[b, s] +
    W[s, t]``, +inf where no finite candidate reaches t.  A non-finite
    input counts as a missing edge.
    """
    cand = _missing_to_inf(dist)[:, :, None] + _missing_to_inf(W)
    return cand.amin(dim=1)


def minplus_argmin_ref(dist: torch.Tensor, W: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (min,+) product with its argmin (plain version of the B4
    kernel).  As :func:`minplus_ref`, plus arg [B, T] int32: the first s
    that attains the min (torch's argmin takes the first occurrence on
    every device), -1 where no finite candidate reaches t."""
    cand = _missing_to_inf(dist)[:, :, None] + _missing_to_inf(W)
    out = cand.amin(dim=1)
    arg = cand.argmin(dim=1).to(torch.int32)
    return out, torch.where(torch.isfinite(out), arg, -1)
