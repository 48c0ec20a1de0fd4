"""Wrappers of the minplus kernels: the banded chain B1, its one-layer unit
B1u and the k-slot chain B3; the dense product B5 and its argmin variant B4.

For a CUDA tensor a wrapper launches the hand-written kernel
(``csrc/banded_minplus.cu``, ``csrc/banded_minplus_kbest.cu``,
``csrc/minplus_dense.cu``) or raises; for a CPU tensor it runs the plain
PyTorch version in ``ref.py``.  Each kernel's wrapper counts its launches
in a plain integer attribute, ``launches``, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._build import launch as _launch, sm_count
from .ref import (banded_minplus_chain_kbest_ref, banded_minplus_chain_ref,
                  banded_minplus_ref, minplus_argmin_ref, minplus_ref)

#: node and depth counts the kernels accept (a B1 block holds at least one
#: scenario's two (N, G+1) grids in shared memory).  The solver needs
#: N <= 5 and G+1 <= 26; the kernel tests go up to N = 32 and G+1 = 256.
MAX_NODES = 32
MAX_DEPTHS = 256
#: shared memory a block may opt into on Hopper; B3 needs one scenario's
#: two k-slot grids, its staged parents and two layers' E / st to fit in it.
MAX_SMEM_BYTES = 232448
#: what one SM of an H100 holds at once: threads, shared memory (a block
#: also takes 1 KB of it for the system) and 32-bit registers
SM_THREADS = 2048
SM_SMEM_BYTES = 233472
SM_BLOCK_RESERVED_BYTES = 1024
SM_REGISTERS = 65536
#: depths a B1 thread relaxes for one target node (the kernel's kDepths),
#: threads a B1 block aims for (whole scenarios: the group that fills its
#: warps best) and has at most, and the registers a B1 thread takes (ptxas,
#: ``chip_smoke.py --times chain``), from which the plan counts the blocks
#: an SM holds
CHAIN_DEPTHS = 2
CHAIN_THREAD_TARGET = 512
CHAIN_THREADS = 1024
CHAIN_REGISTERS = 64
#: threads a B3 block aims for (whole scenarios, at least one) and has at
#: most (a block with more states loops over them), and the largest K its
#: packed heads and parents hold
KBEST_THREAD_TARGET = 64
KBEST_THREADS = 512
KBEST_MAX_K = 1024

_DTYPES = (torch.float64, torch.float32)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_chain_inputs(dist: torch.Tensor, E: torch.Tensor,
                        st: torch.Tensor) -> Tuple[int, int, int, int]:
    """(B, L, N, G+1) of a chain launch; raises on what the kernels do not
    take."""
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
    return B, L, N, Gp1


def _pad16(x: int) -> int:
    return _cdiv(x, 16) * 16 + 16


def chain_smem_bytes(spb: int, L: int, N: int, Gp1: int, dtype: torch.dtype,
                     whole: bool) -> int:
    """Shared memory of a B1 block of ``spb`` scenarios, as the kernel
    source states it: a 16-byte +inf slot, then, ``whole``, two input
    stages (a group's init grids, E and st) and two grids a scenario (the
    layer's source and the one it writes); else (one scenario) the
    per-layer ring: two grids and two layers' E and st.  Every region has
    16 bytes of room to start at its device run's address mod 16."""
    item = torch.finfo(dtype).bits // 8
    states, nn = N * Gp1, N * N
    if whole:
        return (16 + 2 * (_pad16(spb * states * item)
                          + _pad16(spb * L * nn * item)
                          + _pad16(spb * L * nn * 4))
                + 2 * _pad16(spb * states * item))
    return (16 + 2 * _pad16(states * item)
            + 2 * (_pad16(nn * item) + _pad16(nn * 4)))


def chain_whole(L: int, N: int, Gp1: int, dtype: torch.dtype) -> bool:
    """Whether one scenario's whole chain fits a B1 block (else the kernel
    takes one scenario at a time through its per-layer ring)."""
    return chain_smem_bytes(1, L, N, Gp1, dtype, True) <= MAX_SMEM_BYTES


def chain_threads(N: int, Gp1: int) -> int:
    """Threads of one B1 scenario: ``ceil((G+1) / CHAIN_DEPTHS)`` a node."""
    return N * _cdiv(Gp1, CHAIN_DEPTHS)


def chain_blocks(B: int, spb: int, L: int, N: int, Gp1: int,
                 dtype: torch.dtype, n_sm: int = 132) -> Tuple[int, int]:
    """(threads a block, blocks) of a B1 launch of ``spb`` scenarios a
    group: one thread a node and ``CHAIN_DEPTHS`` depths, the group's
    threads rounded up to a warp, at most ``CHAIN_THREADS`` (a block with
    more loops over them); as many blocks as ``n_sm`` SMs hold at once
    (threads, shared memory, ``CHAIN_REGISTERS``), at most one a group,
    each walking its groups in turn."""
    threads = min(CHAIN_THREADS, _cdiv(spb * chain_threads(N, Gp1), 32) * 32)
    smem = chain_smem_bytes(spb, L, N, Gp1, dtype,
                            chain_whole(L, N, Gp1, dtype))
    per_sm = max(1, min(SM_THREADS // threads,
                        SM_SMEM_BYTES // (smem + SM_BLOCK_RESERVED_BYTES),
                        SM_REGISTERS // (threads * CHAIN_REGISTERS)))
    return threads, max(1, min(_cdiv(B, spb), n_sm * per_sm))


def chain_plan(B: int, L: int, N: int, Gp1: int, dtype: torch.dtype,
               n_sm: int = 132) -> Tuple[int, int, int]:
    """(scenarios a group, threads a block, blocks) of a B1 launch.

    One thread a (scenario, target node, ``CHAIN_DEPTHS`` depths).  Where a
    scenario's whole chain fits shared memory, a group is the number of
    scenarios, up to ``CHAIN_THREAD_TARGET`` threads (at least one
    scenario) and no more than spread the batch over ``n_sm`` SMs, whose
    threads fill whole warps best (ties to the larger group) and whose
    shared memory (:func:`chain_smem_bytes`) fits ``MAX_SMEM_BYTES``; else
    one scenario through the per-layer ring.  Threads and blocks:
    :func:`chain_blocks`.
    """
    tps = chain_threads(N, Gp1)
    spb = 1
    if chain_whole(L, N, Gp1, dtype):
        cap = max(1, min(CHAIN_THREAD_TARGET // tps, _cdiv(B, n_sm)))
        fits = [s for s in range(1, cap + 1)
                if chain_smem_bytes(s, L, N, Gp1, dtype, True)
                <= MAX_SMEM_BYTES]
        spb = max(fits, key=lambda s: (s * tps / (_cdiv(s * tps, 32) * 32),
                                       s))
    return (spb, *chain_blocks(B, spb, L, N, Gp1, dtype, n_sm))


def _launch_chain(dist: torch.Tensor, E: torch.Tensor, st: torch.Tensor,
                  lo: Optional[int], init_row: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, L, N, Gp1 = _check_chain_inputs(dist, E, st)
    hist = torch.empty((B, L + init_row, N, Gp1), dtype=dist.dtype,
                       device=dist.device)
    arg = torch.empty((B, L, N, Gp1), dtype=torch.int32, device=dist.device)
    if B == 0 or L == 0:
        if init_row:
            hist[:, 0] = dist
        return hist, arg
    spb, threads, blocks = chain_plan(B, L, N, Gp1, dist.dtype,
                                      sm_count(dist.device))
    _launch("banded_chain_f64" if dist.dtype == torch.float64
            else "banded_chain_f32", dist.device, dist.data_ptr(),
            E.data_ptr(), st.data_ptr(), hist.data_ptr(), arg.data_ptr(), B,
            L, N, Gp1, -1 if lo is None else int(lo), int(init_row), spb,
            threads, blocks)
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


def banded_minplus_chain_history(dist: torch.Tensor, E: torch.Tensor,
                                 st: torch.Tensor, *,
                                 lo: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 with the init grid as row 0 of its history, the solver's form.

    As :func:`banded_minplus_chain`, but hist is [B, L+1, N, G+1] with
    ``dist`` at index 0.  On CUDA it is one launch of the kernel in its
    init-row mode, which writes the init row from the grid it already holds
    in shared memory (no copy after the kernel); the launch counts in
    ``banded_minplus_chain.launches``.
    """
    if dist.device.type == "cpu":
        hist, arg = banded_minplus_chain_ref(dist, E, st, lo=lo)
        return torch.cat([dist[:, None], hist], dim=1), arg
    if dist.device.type != "cuda":
        raise ValueError(f"no banded minplus kernel for device {dist.device}")
    hist, arg = _launch_chain(dist, E, st, lo, init_row=True)
    if E.shape[0] and E.shape[1]:
        banded_minplus_chain.launches += 1
    return hist, arg


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


def kbest_smem_bytes(N: int, Gp1: int, K: int, dtype: torch.dtype) -> int:
    """Shared memory of one scenario in the B3 kernel: the source k-slot
    grid and the grid it writes, with an odd row stride ``K | 1``, the
    staged parents packed in 16 bits, and two layers' E and st, each
    padded to 16 bytes."""
    item = torch.finfo(dtype).bits // 8
    rows = N * Gp1 * (K | 1)
    return (2 * _cdiv(rows, 4) * 4 * item + _cdiv(rows, 8) * 8 * 2
            + 2 * _cdiv(N * N, 4) * 4 * (item + 4))


def kbest_plan(B: int, N: int, Gp1: int, K: int, dtype: torch.dtype,
               n_sm: int = 132) -> Tuple[int, int]:
    """(scenarios a block, threads a block) of a B3 launch.

    A block takes whole scenarios, one thread a target state: as many
    scenarios as fill ``KBEST_THREAD_TARGET`` threads (at least one) and
    fit ``MAX_SMEM_BYTES``, and no more than spread the batch over ``n_sm``
    SMs; at most ``KBEST_THREADS`` threads (a block with more states loops
    over them).  Raises ValueError for a shape whose one scenario does not
    fit in shared memory, or a K the packed heads cannot hold.
    """
    if not 1 <= K <= KBEST_MAX_K:
        raise ValueError(f"the k-slot kernel packs a head's slot in 10 bits: "
                         f"1 <= K <= {KBEST_MAX_K}, got K={K}")
    per = kbest_smem_bytes(N, Gp1, K, dtype)
    if per > MAX_SMEM_BYTES:
        raise ValueError(f"the k-slot kernel holds one scenario's grids in "
                         f"shared memory: N={N}, G+1={Gp1}, K={K} in "
                         f"{dtype} need {per} B > {MAX_SMEM_BYTES} B")
    states = N * Gp1
    spb = max(1, min(KBEST_THREAD_TARGET // states, MAX_SMEM_BYTES // per,
                     _cdiv(B, n_sm)))
    return spb, min(KBEST_THREADS, _cdiv(spb * states, 32) * 32)


def banded_minplus_chain_kbest(dist: torch.Tensor, E: torch.Tensor,
                               st: torch.Tensor, K: int, *,
                               lo: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Chained banded k-slot relaxation: the K cheapest paths per state (B3).

    dist: [B, N, G+1] init grids; E: [B, L, N, N] in dist's dtype (+inf =
    pruned); st: [B, L, N, N] int32 steepness; ``lo`` the lambda window or
    None -> (hist [B, L, N, G+1, K], the k-slot grid after each layer, and
    par_n / par_k [B, L, N, G+1, K] int32, the source node and slot of each
    entry, -1 where a slot is unused).  Slot order is that of a stable
    ascending sort of the node-major, slot-minor candidate pool.  float64
    and float32.
    """
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if dist.device.type == "cpu":
        return banded_minplus_chain_kbest_ref(dist, E, st, K, lo=lo)
    if dist.device.type != "cuda":
        raise ValueError(f"no banded minplus kernel for device {dist.device}")
    B, L, N, Gp1 = _check_chain_inputs(dist, E, st)
    spb, threads = kbest_plan(B, N, Gp1, K, dist.dtype, sm_count(dist.device))
    shape = (B, L, N, Gp1, K)
    hist = torch.empty(shape, dtype=dist.dtype, device=dist.device)
    par_n = torch.empty(shape, dtype=torch.int32, device=dist.device)
    par_k = torch.empty(shape, dtype=torch.int32, device=dist.device)
    if B == 0 or L == 0:
        return hist, par_n, par_k
    _launch("banded_chain_kbest_f64" if dist.dtype == torch.float64
            else "banded_chain_kbest_f32", dist.device, dist.data_ptr(),
            E.data_ptr(), st.data_ptr(), hist.data_ptr(), par_n.data_ptr(),
            par_k.data_ptr(), B, L, N, Gp1, int(K),
            -1 if lo is None else int(lo), spb, threads)
    banded_minplus_chain_kbest.launches += 1
    return hist, par_n, par_k


banded_minplus_chain_kbest.launches = 0


# ---------------------------------------------------------------------------
# dense (min,+) products: B5 and B4
# ---------------------------------------------------------------------------

_INT32_MAX = 2 ** 31 - 1
#: rows a block of the dense kernel takes when W is shared (each W load
#: serves them all), targets a block at most, source slices of a tile at
#: most (the cluster size; above 8 it is Hopper's non-portable size), and
#: the fewest sources a slice of its own is worth
DENSE_SHARED_ROWS = 8
DENSE_MAX_THREADS = 256
DENSE_MAX_CLUSTER = 16
DENSE_MIN_SLICE = 8


def dense_plan(B: int, S: int, T: int, shared: bool, n_sm: int = 132
               ) -> Tuple[int, int]:
    """(per, Q) of a dense (min,+) launch: ``per`` targets a block and
    ``Q`` source slices a target tile, merged over a thread-block cluster.

    A batch that gives every SM a block of (row group, tile of up to 256
    targets) takes the whole source range in one block (Q = 1).  A smaller
    one (a Table VII layer has B = 1) gets one-warp target tiles and its
    sources split into Q contiguous slices, so that tiles x Q covers the
    SMs and a slice fits the block's one-warp chunk where the cluster
    allows it, with at least ``DENSE_MIN_SLICE`` sources a slice and no
    empty slice.
    """
    groups = _cdiv(B, DENSE_SHARED_ROWS if shared else 1)
    tiles = _cdiv(T, DENSE_MAX_THREADS)
    if groups * tiles >= n_sm:
        return _cdiv(T, tiles), 1
    tiles = _cdiv(T, 32)
    Q = max(1, min(DENSE_MAX_CLUSTER, _cdiv(S, DENSE_MIN_SLICE),
                   max(_cdiv(n_sm, groups * tiles), _cdiv(S, 32))))
    return _cdiv(T, tiles), _cdiv(S, _cdiv(S, Q))


def _check_dense_inputs(dist: torch.Tensor, W: torch.Tensor
                        ) -> Tuple[int, int, int, int]:
    """(B, S, T, W's batch stride in elements) of a dense launch of B4 or
    B5; raises on what the kernel does not take."""
    if dist.dim() != 2 or W.dim() not in (2, 3):
        raise ValueError(f"expected dist [B, S] and W [S, T] or [B, S, T], "
                         f"got {tuple(dist.shape)}, {tuple(W.shape)}")
    B, S = dist.shape
    T = W.shape[-1]
    if W.shape[-2] != S or (W.dim() == 3 and W.shape[0] != B):
        raise ValueError(f"W must be [{S}, T] or [{B}, {S}, T], got "
                         f"{tuple(W.shape)}")
    if dist.dtype not in _DTYPES or W.dtype != dist.dtype:
        raise ValueError(f"dist and W must share float64 or float32, got "
                         f"{dist.dtype} / {W.dtype}")
    if W.device != dist.device:
        raise ValueError("dist and W must lie on one device")
    mat_ok = (W.is_contiguous() if W.dim() == 2
              else B == 0 or W[0].is_contiguous())
    if not (dist.is_contiguous() and mat_ok):
        raise ValueError("dist must be contiguous and each [S, T] matrix of "
                         "W contiguous")
    if S < 1:
        raise ValueError("the dense (min,+) product needs S >= 1")
    stride = W.stride(0) if W.dim() == 3 and B > 1 else 0
    if max(B, S * T, stride, B * _cdiv(T, DENSE_MAX_THREADS)) > _INT32_MAX:
        raise ValueError(f"B={B}, S*T={S * T}, batch stride {stride} or the "
                         f"blocks of B x T exceed the kernel's int32 sizes")
    return B, S, T, stride


def _launch_dense(dist: torch.Tensor, W: torch.Tensor, argmin: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    B, S, T, stride = _check_dense_inputs(dist, W)
    out = torch.empty((B, T), dtype=dist.dtype, device=dist.device)
    arg = (torch.empty((B, T), dtype=torch.int32, device=dist.device)
           if argmin else None)
    if B and T:
        per, Q = dense_plan(B, S, T, stride == 0 and B > 1,
                            sm_count(dist.device))
        name = ("minplus_argmin" if argmin else "minplus") + (
            "_f64" if dist.dtype == torch.float64 else "_f32")
        _launch(name, dist.device, dist.data_ptr(), W.data_ptr(),
                out.data_ptr(), 0 if arg is None else arg.data_ptr(), B, S,
                T, stride, per, Q)
    return out, arg


def _dense_device(dist: torch.Tensor) -> str:
    if dist.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no dense minplus kernel for device {dist.device}")
    return dist.device.type


def minplus_vecmat(dist: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Dense (min,+) product (B5): ``out[b, t] = min_s dist[b, s] + W[s, t]``.

    dist: [B, S]; W: [S, T] shared by every row (the TPU kernel's
    contract), or [B, S, T] with one matrix per row (the batched dense
    engines; each W[b] contiguous, any batch stride, so a layer of a
    [B, L, S, T] stack goes in without a copy) -> out [B, T] in dist's
    dtype, +inf where no finite candidate reaches t.  A non-finite input is
    a missing edge.  float64 and float32.
    """
    if _dense_device(dist) == "cpu":
        _check_dense_inputs(dist, W)
        return minplus_ref(dist, W)
    out, _ = _launch_dense(dist, W, argmin=False)
    if out.numel():
        minplus_vecmat.launches += 1
    return out


minplus_vecmat.launches = 0


def minplus_matmat(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Tropical matmul ``out[i, j] = min_k A[i, k] + B[k, j]``: the rows of
    A are independent fronts sharing one transition matrix, so it is B5
    (:func:`minplus_vecmat`) under its algebraic name."""
    return minplus_vecmat(A, B)


def minplus_vecmat_argmin(dist: torch.Tensor, W: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (min,+) product with its argmin (B4), the parent-recovery
    variant behind the dense FIN DP.

    As :func:`minplus_vecmat`, plus arg [B, T] int32: the first s that
    attains the min, -1 where no finite candidate reaches t.
    """
    if _dense_device(dist) == "cpu":
        _check_dense_inputs(dist, W)
        return minplus_argmin_ref(dist, W)
    out, arg = _launch_dense(dist, W, argmin=True)
    if out.numel():
        minplus_vecmat_argmin.launches += 1
    return out, arg


minplus_vecmat_argmin.launches = 0
