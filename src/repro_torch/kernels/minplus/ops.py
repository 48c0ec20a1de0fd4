"""Wrappers of the banded minplus kernels (B1 and its one-layer unit B1u).

For a CUDA tensor a wrapper launches the hand-written kernel
(``csrc/banded_minplus.cu``) or raises; for a CPU tensor it runs the plain
PyTorch version in ``ref.py``.  Each wrapper counts its kernel launches in
a plain integer attribute, ``launches``, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import load_library
from .ref import banded_minplus_chain_ref, banded_minplus_ref

#: node and depth counts the kernel accepts (a block holds at least one
#: scenario's two (N, G+1) grids in shared memory).  The solver needs
#: N <= 5 and G+1 <= 26; the kernel tests go up to N = 23 and G+1 = 131.
MAX_NODES = 32
MAX_DEPTHS = 256

_DTYPES = (torch.float64, torch.float32)


def _launch_chain(dist: torch.Tensor, E: torch.Tensor, st: torch.Tensor,
                  lo: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    if dist.dim() != 3 or E.dim() != 4:
        raise ValueError(f"expected dist [B, N, G+1] and E/st [B, L, N, N], "
                         f"got {tuple(dist.shape)}, {tuple(E.shape)}")
    B, N, Gp1 = dist.shape
    L = E.shape[1]
    if tuple(E.shape) != (B, L, N, N) or tuple(st.shape) != (B, L, N, N):
        raise ValueError(f"E/st must be [B, L, N, N] = {(B, L, N, N)}, got "
                         f"{tuple(E.shape)} / {tuple(st.shape)}")
    if dist.dtype not in _DTYPES or E.dtype != dist.dtype:
        raise ValueError(f"dist and E must share float64 or float32, got "
                         f"{dist.dtype} / {E.dtype}")
    if st.dtype != torch.int32:
        raise ValueError(f"st must be int32, got {st.dtype}")
    if not (E.device == st.device == dist.device):
        raise ValueError("dist, E and st must lie on one device")
    if not (dist.is_contiguous() and E.is_contiguous()
            and st.is_contiguous()):
        raise ValueError("dist, E and st must be contiguous")
    if not (1 <= N <= MAX_NODES and 1 <= Gp1 <= MAX_DEPTHS):
        raise ValueError(f"the banded kernel takes 1 <= N <= {MAX_NODES} and "
                         f"1 <= G+1 <= {MAX_DEPTHS}, got N={N}, G+1={Gp1}")
    if B >= 2 ** 31:
        raise ValueError(f"batch of {B} rows exceeds the kernel's int32 count")
    hist = torch.empty((B, L, N, Gp1), dtype=dist.dtype, device=dist.device)
    arg = torch.empty((B, L, N, Gp1), dtype=torch.int32, device=dist.device)
    if B == 0 or L == 0:
        return hist, arg
    lib = load_library().lib
    fn = lib.banded_chain_f64 if dist.dtype == torch.float64 \
        else lib.banded_chain_f32
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream(dist.device).cuda_stream
        rc = fn(dist.data_ptr(), E.data_ptr(), st.data_ptr(),
                hist.data_ptr(), arg.data_ptr(), B, L, N, Gp1,
                -1 if lo is None else int(lo), stream)
    if rc != 0:
        raise RuntimeError(f"banded minplus kernel launch failed: CUDA error "
                           f"{rc}")
    return hist, arg


def banded_minplus_chain(dist: torch.Tensor, E: torch.Tensor,
                         st: torch.Tensor, *, lo: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chained banded relaxation: a whole (B, L)-layer batch per call (B1).

    dist: [B, N, G+1]; E: [B, L, N, N] in dist's dtype (+inf = pruned);
    st: [B, L, N, N] int32 steepness; ``lo`` the lambda window or None ->
    (hist [B, L, N, G+1], the grid after each layer, and the argmin source
    node [B, L, N, G+1] int32, -1 where unreachable).  float64 and float32.
    """
    if dist.device.type == "cpu":
        return banded_minplus_chain_ref(dist, E, st, lo=lo)
    if dist.device.type != "cuda":
        raise ValueError(f"no banded minplus kernel for device {dist.device}")
    hist, arg = _launch_chain(dist, E, st, lo)
    if E.shape[0] and E.shape[1]:
        banded_minplus_chain.launches += 1
    return hist, arg


banded_minplus_chain.launches = 0


def banded_minplus_argmin(dist: torch.Tensor, E: torch.Tensor,
                          st: torch.Tensor, lo: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One banded relaxation layer for one scenario (B1u).

    dist: [N, G+1]; E: [N, N] (+inf = pruned); st: [N, N] int32 ->
    (out [N, G+1], argmin source node [N, G+1] int32, -1 unreachable):
    ``out[m, g] = min_n dist[n, g - st[n, m]] + E[n, m]``.  The chain
    kernel launched with B = 1 and L = 1.
    """
    if dist.device.type == "cpu":
        return banded_minplus_ref(dist, E, st, lo=lo)
    if dist.device.type != "cuda":
        raise ValueError(f"no banded minplus kernel for device {dist.device}")
    if dist.dim() != 2 or E.dim() != 2 or st.dim() != 2:
        raise ValueError(f"expected dist [N, G+1], E/st [N, N], got "
                         f"{tuple(dist.shape)}, {tuple(E.shape)}, "
                         f"{tuple(st.shape)}")
    hist, arg = _launch_chain(dist[None], E[None, None], st[None, None], lo)
    banded_minplus_argmin.launches += 1
    return hist[0, 0], arg[0, 0]


banded_minplus_argmin.launches = 0
