"""Wrapper of the decode attention kernel B7.

For CUDA tensors ``decode_attn`` launches the hand-written kernel
(``csrc/decode_attn.cu``) or raises; for CPU tensors it runs the plain
PyTorch version in ``ref.py``.  It counts its kernel launches in a plain
integer attribute, ``launches``, so a run can show that its main path went
through the kernel.

The kernel splits the cache of each (sequence, kv-head) over the ``P``
blocks of a thread-block cluster (``split_plan``); block ``r`` takes the
slots ``split_ranges(T, P)[r]`` and the cluster merges the blocks' flash
partials in distributed shared memory.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .._build import launch
from .ref import decode_attn_ref

_ENTRY = {torch.float32: "decode_attn_f32",
          torch.bfloat16: "decode_attn_bf16"}
#: shared memory a block may opt into on Hopper
MAX_SMEM_BYTES = 232448
#: warps of a block, stages of its K / V ring and query heads a cluster
#: takes (``kWarps``, ``kStages``, ``kHeads`` in the source)
WARPS = 8
STAGES = 2
HEADS = 4
#: the portable cluster size: blocks that split one (sequence, kv-head)
MAX_CLUSTER = 8
#: SMs of an H100.  A block (8 warps, a ring of two tiles) fills one; a
#: launch aims for three quarters of them, which on the card streamed a
#: long cache faster than half of them, all of them or two blocks an SM
#: (chip_smoke.py --times, the cluster-size sweep)
NUM_SMS = 132
TARGET_BLOCKS = 3 * NUM_SMS // 4
#: the widest head the kernel takes (q's mma fragments and each lane's
#: share of a row live in registers)
MAX_D = 128


def slots_per_warp(D: int, itemsize: int) -> int:
    """Cache slots a warp takes of each tile (``kSlots``): in bf16 32 up to
    D = 80 and 16 above, in float32 8."""
    if itemsize == 2:
        return 32 if D <= 80 else 16
    return 8


def tile_slots(D: int, itemsize: int) -> int:
    """Cache slots of one stage of a block's K / V ring."""
    return WARPS * slots_per_warp(D, itemsize)


def split_plan(B: int, KV: int, T: int, D: int = 80, itemsize: int = 2
               ) -> int:
    """Blocks ``P`` of the cluster that splits one (sequence, kv-head)'s
    cache: ``B * KV * P`` near ``TARGET_BLOCKS`` where the cache is long
    enough, at most ``MAX_CLUSTER``, and no more than T over the tile, so
    that every range of :func:`split_ranges` holds at least one full tile
    (P = 1 when T is one tile or less).  The defaults are qwen3-4b's bf16
    heads."""
    want = TARGET_BLOCKS // max(1, B * KV)
    return max(1, min(MAX_CLUSTER, want, T // tile_slots(D, itemsize)))


def split_ranges(T: int, P: int) -> List[Tuple[int, int]]:
    """The slot range ``[r*T//P, (r+1)*T//P)`` of each block ``r`` of a
    cluster of ``P``, as the kernel computes it: contiguous, in order, and
    covering ``[0, T)``."""
    return [(r * T // P, (r + 1) * T // P) for r in range(P)]


def smem_bytes(D: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the kernel: 128 bytes of
    alignment, the K / V ring with its mbarriers and cache_pos, then q of
    the cluster's heads, the warps' probabilities of a tile and their max
    and sum (float32)."""
    tile, slots = tile_slots(D, itemsize), slots_per_warp(D, itemsize)
    return (128 + STAGES * (2 * tile * D * itemsize + 8 + 4 * tile)
            + 4 * (HEADS * D + WARPS * (slots + 2) * HEADS))


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cache_pos: torch.Tensor, pos: int,
                *, window: int = 0) -> torch.Tensor:
    """One-token GQA attention over a KV cache.

    q: [B, H, D]; k/v: [B, T, KV, D] in q's dtype (float32 or bfloat16);
    cache_pos: [T] int32, the absolute position of each slot (-1 = empty);
    pos: the current position (an int); ``window > 0`` keeps only slots
    with position > pos - window -> [B, H, D] in q's dtype.
    """
    if q.device.type == "cpu":
        return decode_attn_ref(q, k_cache, v_cache, cache_pos, pos,
                               window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention kernel for device {q.device}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"expected q [B, H, D] and k/v [B, T, KV, D], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (B, T, KV, D) or \
            v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v must both be [B, T, KV, D] = {(B, T, KV, D)},"
                         f" got {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}")
    if tuple(cache_pos.shape) != (T,) or cache_pos.dtype != torch.int32:
        raise ValueError(f"cache_pos must be int32 [{T}], got "
                         f"{cache_pos.dtype} {tuple(cache_pos.shape)}")
    if q.dtype not in _ENTRY or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise ValueError(f"q, k and v must share float32 or bfloat16, got "
                         f"{q.dtype} / {k_cache.dtype} / {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == cache_pos.device):
        raise ValueError("q, k, v and cache_pos must lie on one device")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, cache_pos)):
        raise ValueError("q, k, v and cache_pos must be contiguous")
    if KV == 0 or H % KV:
        raise ValueError(f"H = {H} must be a multiple of KV = {KV}")
    if (D * q.element_size()) % 16 or not 0 < D <= MAX_D or \
            (q.dtype == torch.bfloat16 and D % 16):
        raise ValueError(f"the kernel loads K / V rows in 16-byte words and "
                         f"bf16 heads in 16-wide mma steps: D = {D} must be "
                         f"at most {MAX_D}, D * itemsize a multiple of 16 "
                         f"and, in bf16, D a multiple of 16")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q, k and v must be 16-byte aligned")
    item = q.element_size()
    need = smem_bytes(D, item)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"a block's K / V ring and accumulators need {need} B "
                         f"of shared memory at D={D}, > {MAX_SMEM_BYTES} B")
    blocks = B * KV * -(-(H // KV) // HEADS) * MAX_CLUSTER
    if T == 0 or blocks >= 2 ** 31 or B * T >= 2 ** 31:
        raise ValueError(f"the kernel takes 0 < T, B*T < 2^31 and fewer than "
                         f"2^31 blocks, got T={T}, B={B}, H={H}, KV={KV}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    launch(_ENTRY[q.dtype], q.device, q.data_ptr(), k_cache.data_ptr(),
           v_cache.data_ptr(), cache_pos.data_ptr(), out.data_ptr(), B, T,
           H, KV, D, int(pos), int(window), split_plan(B, KV, T, D, item))
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
