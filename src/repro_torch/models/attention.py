"""Attention for decoding: GQA with RoPE, optional qk-norm, causal /
sliding-window masks, and a KV-cache decode step (a ring buffer under a
sliding window).

Port of the decode half of ``repro/models/attention.py``.
``decode_attention`` is the reference's function of the same name: on CUDA
it launches the hand-written flash-decode kernel B7
(``kernels/decode_attn``), on the CPU it runs that kernel's plain version,
which is the reference's function line for line.  The full-sequence
``chunked_attention`` / ``attn_apply`` (prefill and training) belong to a
later slice.

Caches keep the reference's layout (``k``/``v`` ``[B, T, KV, D]``, ``pos``
``[T]``) but are updated in place: the reference returns new arrays, the
port writes the new slot into the tensors it was given and returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.decode_attn.ops import decode_attn
from .layers import (F32, apply_rope, dense_init, rmsnorm, rmsnorm_init,
                     scalar)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    params = {
        "wq": dense_init(gen, (d, H, hd), d, dtype, device),
        "wk": dense_init(gen, (d, KV, hd), d, dtype, device),
        "wv": dense_init(gen, (d, KV, hd), d, dtype, device),
        "wo": dense_init(gen, (H, hd, d), H * hd, dtype, device),
    }
    if cfg.qk_norm:
        params["q_norm"] = rmsnorm_init(hd, dtype, device)
        params["k_norm"] = rmsnorm_init(hd, dtype, device)
    return params


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` in x's dtype (float32 accumulation)."""
    d, h, k = w.shape
    return torch.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# KV cache + decode step
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KVCacheSpec:
    """Cache geometry for one attention layer (ring buffer if SWA).

    ``quantized=True`` stores K/V as int8 with a per-(slot, kv-head) float32
    scale."""
    batch: int
    max_len: int          # = min(seq_len, window) for SWA
    n_kv: int
    head_dim: int
    quantized: bool = False

    def init(self, dtype, device) -> Dict[str, torch.Tensor]:
        shape = (self.batch, self.max_len, self.n_kv, self.head_dim)
        kv_dtype = torch.int8 if self.quantized else dtype
        out = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
               "v": torch.zeros(shape, dtype=kv_dtype, device=device),
               "pos": torch.full((self.max_len,), -1, dtype=torch.int32,
                                 device=device)}
        if self.quantized:
            sshape = (self.batch, self.max_len, self.n_kv)
            out["k_scale"] = torch.zeros(sshape, dtype=F32, device=device)
            out["v_scale"] = torch.zeros(sshape, dtype=F32, device=device)
        return out


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int) -> KVCacheSpec:
    max_len = seq_len if cfg.sliding_window == 0 else min(seq_len,
                                                          cfg.sliding_window)
    return KVCacheSpec(batch, max_len, cfg.n_kv_heads, cfg.head_dim_,
                       quantized=cfg.kv_cache_dtype == "int8")


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, KV, D] -> (int8 [B, S, KV, D], scale float32 [B, S, KV])."""
    xf = x.to(F32)
    # tensor / tensor: a CUDA tensor divided by a Python scalar is a multiply
    # by the rounded reciprocal, one ulp off the reference's division
    scale = xf.abs().amax(dim=-1) / scalar(127.0, x.device)
    q = torch.round(xf / scale.clamp_min(1e-8)[..., None])
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                   ) -> torch.Tensor:
    return (q.to(F32) * scale[..., None]).to(dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor, pos: int,
                     *, window: int) -> torch.Tensor:
    """One-token attention over the cache.

    q: [B, 1, H, D]; caches: [B, T, KV, D]; cache_pos: [T] absolute
    positions of each slot (-1 = empty); pos: the current position.  Kernel
    B7 on CUDA, its plain version on the CPU.
    """
    return decode_attn(q[:, 0].contiguous(), k_cache, v_cache, cache_pos,
                       pos, window=window)[:, None]


def attn_decode_step(params, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     pos: int) -> Tuple[torch.Tensor, dict]:
    """x: [B, 1, d]; cache: {"k", "v", "pos"[, "k_scale", "v_scale"]};
    pos: the current index (an int).

    Returns (out [B, 1, d], cache), the cache updated in place: slot
    ``pos % T`` takes the new K/V (a ring buffer under a sliding window);
    an int8 cache quantizes the new K/V and dequantizes on read.
    """
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    T = cache["k"].shape[1]
    slot = pos % T
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k"][:, slot] = kq[:, 0]
        cache["v"][:, slot] = vq[:, 0]
        cache["k_scale"][:, slot] = ks[:, 0]
        cache["v_scale"][:, slot] = vs[:, 0]
        k_read = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_read = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        k_read, v_read = cache["k"], cache["v"]
    cache["pos"][slot] = pos
    out = decode_attention(q, k_read, v_read, cache["pos"], pos,
                           window=cfg.sliding_window)
    H, hd, d = params["wo"].shape
    y = torch.matmul(out.reshape(*out.shape[:-2], H * hd),
                     params["wo"].reshape(H * hd, d))
    return y, cache
