"""Wrapper of the decode attention kernel B7.

For CUDA tensors ``decode_attn`` launches the hand-written kernel
(``csrc/decode_attn.cu``) or raises; for CPU tensors it runs the plain
PyTorch version in ``ref.py``.  It counts its kernel launches in a plain
integer attribute, ``launches``, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import torch

from .._build import launch
from .ref import decode_attn_ref

_ENTRY = {torch.float32: "decode_attn_f32",
          torch.bfloat16: "decode_attn_bf16"}
#: shared memory a block may opt into on Hopper
MAX_SMEM_BYTES = 232448
#: slots of the cache a block stages per tile (``kTile`` in the source)
TILE = 32


def smem_bytes(G: int, D: int) -> int:
    """Shared memory of one block of the kernel: q and the accumulator of a
    group, a K tile (rows padded by one word), a V tile, the scores and the
    running max / sum / rescale per query head."""
    return 4 * (2 * G * D + TILE * (D + 1) + TILE * D + G * TILE + 3 * G)


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
    need = smem_bytes(H // KV, D)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"a block holds one kv-group's q and accumulator in "
                         f"shared memory: G={H // KV}, D={D} need {need} B > "
                         f"{MAX_SMEM_BYTES} B")
    if T == 0 or B * KV >= 2 ** 31:
        raise ValueError(f"the kernel takes 0 < T and B*KV < 2^31, got T={T},"
                         f" B*KV={B * KV}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    launch(_ENTRY[q.dtype], q.device, q.data_ptr(), k_cache.data_ptr(),
           v_cache.data_ptr(), cache_pos.data_ptr(), out.data_ptr(), B, T,
           H, KV, D, int(pos), int(window))
    decode_attn.launches += 1
    return out


decode_attn.launches = 0
