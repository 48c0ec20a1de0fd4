"""Attention: GQA with RoPE, optional qk-norm, causal / sliding-window /
bidirectional masks; chunked online-softmax attention for the full-sequence
forward and prefill, and a KV-cache decode step (a ring buffer under a
sliding window).

Port of ``repro/models/attention.py``.  ``chunked_attention`` is the
reference's loop over KV chunks with the running (max, sum, acc) in
float32 and its finite ``NEG_INF``: a chunk masked out for a row leaves a
finite running max there, and the next live chunk wipes its share through
``corr = exp(m - m_new)``.  It stays a loop of plain PyTorch products (an
XLA program in the reference, not a Pallas kernel).
``decode_attention`` is the reference's function of the same name: on CUDA
it launches the hand-written flash-decode kernel B7
(``kernels/decode_attn``), on the CPU it runs that kernel's plain version,
which is the reference's function line for line.

Caches keep the reference's layout (``k``/``v`` ``[B, T, KV, D]``, ``pos``
``[T]``) but are updated in place: the reference returns new arrays, the
port writes the new slot into the tensors it was given and returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.decode_attn.ops import decode_attn
from .layers import (F32, apply_rope, dense_init, rmsnorm, rmsnorm_init,
                     scalar)

NEG_INF = -1e30


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


def out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` in out's dtype (float32 accumulation)."""
    H, hd, d = wo.shape
    return torch.matmul(out.reshape(*out.shape[:-2], H * hd),
                        wo.reshape(H * hd, d))


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (full sequence / prefill)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """[Sq, Sk] float32 additive bias for causal / SWA / bidirectional
    masks; key slots at negative positions (padding) are masked."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = (dk >= 0).expand(dq.shape[0], dk.shape[1])
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dk > dq - window)
    return torch.where(ok, scalar(0.0, ok.device), scalar(NEG_INF, ok.device))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int, chunk: int) -> torch.Tensor:
    """q: [B, Sq, H, D]; k / v: [B, Sk, KV, D]; returns [B, Sq, H, D].

    A loop over KV chunks with the running (max, sum, acc) in float32:
    O(Sq * chunk) live scores.  Sk is padded to a multiple of ``chunk``
    with key position -10**9, which the mask drops.  GQA groups the heads
    as [B, Sq, KV, G, D]."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         f"heads")
    G = H // KV
    scale = D ** -0.5
    if Sk % chunk:
        pad = chunk - Sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-10**9)
        Sk += pad
    qg = q.reshape(B, Sq, KV, G, D).to(F32)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=F32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=F32, device=q.device)
    for c0 in range(0, Sk, chunk):
        kc = k[:, c0:c0 + chunk].to(F32)
        vc = v[:, c0:c0 + chunk]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kc) * scale
        s = s + _mask_bias(q_pos, k_pos[c0:c0 + chunk], causal,
                           window)[:, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(q.dtype).to(F32), vc.to(F32))
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attn_apply(params, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention (forward / prefill). x: [B, S, d];
    positions: [B, S] integer."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = chunked_attention(q, k, v, positions[0], positions[0],
                            causal=cfg.causal, window=cfg.sliding_window,
                            chunk=cfg.attn_chunk)
    return out_proj(out, params["wo"])


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
    return out_proj(out, params["wo"]), cache
