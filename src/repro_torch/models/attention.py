"""Attention: GQA with RoPE, optional qk-norm, causal / sliding-window /
bidirectional masks; chunked online-softmax attention for the full-sequence
forward and prefill, and a KV-cache decode step (a ring buffer under a
sliding window).

Port of ``repro/models/attention.py``.  ``chunked_attention`` is the
reference's loop over KV chunks with the running (max, sum, acc) in
float32 and its finite ``NEG_INF`` (an XLA program in the reference, not a
Pallas kernel): on CUDA it launches the hand-written flash-prefill kernel
B8 (``kernels/prefill_attn``), on the CPU it runs that kernel's plain
version, the reference's loop; its gradient is the plain version's.
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
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ArchConfig
from ..kernels.decode_attn.ops import decode_attn
from ..kernels.prefill_attn.ops import prefill_attention
from ..kernels.prefill_attn.ref import NEG_INF  # noqa: F401 (reference name)
from ..kernels.prefill_attn.ref import mask_bias as _mask_bias  # noqa: F401
from ..sharding.dtensor import (is_dtensor, local_offsets, replicated,
                                write_slot)
from .layers import (F32, apply_rope, dense_init, linear, rmsnorm,
                     rmsnorm_init, scalar)


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
    return linear(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


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
    return linear(out.reshape(*out.shape[:-2], H * hd), wo.reshape(H * hd, d))


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (full sequence / prefill)
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int, chunk: int) -> torch.Tensor:
    """q: [B, Sq, H, D]; k / v: [B, Sk, KV, D]; returns [B, Sq, H, D].

    The reference's loop over KV chunks with the running (max, sum, acc)
    in float32 (``kernels/prefill_attn/ref.py``), through kernel B8 on
    CUDA (which raises on a shape it does not take) and its gradient the
    plain version's; over DTensors on each rank's shard."""
    if is_dtensor(q):
        return _chunked_attention_local(q, k, v, q_pos, k_pos, causal=causal,
                                        window=window, chunk=chunk)
    return prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             q_pos.to(torch.int32).contiguous(),
                             k_pos.to(torch.int32).contiguous(),
                             causal=causal, window=window, chunk=chunk)


def _chunked_attention_local(q, k, v, q_pos, k_pos, *, causal: bool,
                             window: int, chunk: int):
    """``chunked_attention`` over DTensors, on each rank's shard through
    ``local_map``: batch and KV-head shards are local (a query head reads
    only its group's KV head), the sequences are gathered, and where the
    KV heads are replicated the query heads are too."""
    from torch.distributed.tensor.experimental import local_map
    k, v, q_pos, k_pos = (replicated(t, q) for t in (k, v, q_pos, k_pos))
    place = []
    for pq, pk in zip(q.placements, k.placements):
        if pk.is_shard(0) or (pq.is_shard(0) and not pk.is_shard(2)):
            place.append(Shard(0))
        elif pk.is_shard(2):
            place.append(Shard(2))
        else:
            place.append(Replicate())
    place = tuple(place)
    whole = tuple(Replicate() for _ in place)

    def local(ql, kl, vl, qp, kp):
        return chunked_attention(ql, kl, vl, qp, kp, causal=causal,
                                 window=window, chunk=chunk)

    return local_map(local, out_placements=(place,),
                     in_placements=(place, place, place, whole, whole),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v, q_pos, k_pos)


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
    B7 on CUDA, its plain version on the CPU; on DTensors B7 runs on each
    rank's heads (``_decode_attention_local``).
    """
    if is_dtensor(q):
        return _decode_attention_local(q, k_cache, v_cache, cache_pos, pos,
                                       window=window)
    return decode_attn(q[:, 0].contiguous(), k_cache, v_cache, cache_pos,
                       pos, window=window)[:, None]


def kv_heads_read(h0: int, Hl: int, H: int, KV: int, kv0: int,
                  KVl: int) -> Tuple[int, int]:
    """The global KV heads [lo, hi) that query heads [h0, h0 + Hl) of H
    read (GQA, G = H / KV a KV head), checked against what the rank holds
    (KV heads [kv0, kv0 + KVl)) and against B7's grouping, which gives
    local query head j the KV head j // (Hl / (hi - lo)) of the slice:
    right for whole groups, or for heads of one KV head.  Raises
    ``ValueError`` otherwise (B7 is never handed a shard it would pair
    wrongly)."""
    G = H // KV
    lo, hi = h0 // G, (h0 + Hl - 1) // G + 1
    whole = h0 % G == 0 and Hl % G == 0
    if not (kv0 <= lo and hi <= kv0 + KVl and (whole or hi - lo == 1)):
        raise ValueError(
            f"decode attention: query heads [{h0}, {h0 + Hl}) of {H} "
            f"(G = {G}) do not read whole KV heads of the rank's "
            f"[{kv0}, {kv0 + KVl}) of {KV}")
    return lo, hi


def _decode_attention_local(q, k_cache, v_cache, cache_pos, pos: int, *,
                            window: int):
    """``decode_attention`` over DTensors: B7 (or its plain version) on
    each rank's shard, through ``local_map``.

    The cache keeps its batch and KV-head shards; a cache sharded along
    the sequence is all-gathered first (B7 has no split-softmax output to
    combine across ranks).  q is brought to the cache's batch shard, and
    keeps a head shard where the KV heads are replicated (GQA with fewer
    KV heads than the model axis): each rank then hands B7 the KV heads
    its query heads read, by global index."""
    from torch.distributed.tensor.experimental import local_map
    k_cache, v_cache, cache_pos = (replicated(t, q) for t in
                                   (k_cache, v_cache, cache_pos))
    kp = tuple(Replicate() if p.is_shard(1) else p
               for p in k_cache.placements)
    qp = []
    for pq, pk in zip(q.placements, kp):
        if pk.is_shard(0):
            qp.append(Shard(0))
        elif pk.is_shard(2) or (pq.is_shard(2) and pk.is_replicate()):
            qp.append(Shard(2))
        else:
            qp.append(Replicate())
    qp = tuple(qp)
    whole = tuple(Replicate() for _ in qp)
    H, KV = q.shape[2], k_cache.shape[2]
    h0, kv0 = local_offsets(q, qp)[2], local_offsets(k_cache, kp)[2]

    def local(ql, kl, vl, pl):
        lo, hi = kv_heads_read(h0, ql.shape[2], H, KV, kv0, kl.shape[2])
        if kl.shape[2] != hi - lo:
            kl = kl[:, :, lo - kv0:hi - kv0]
            vl = vl[:, :, lo - kv0:hi - kv0]
        return decode_attn(ql[:, 0].contiguous(), kl.contiguous(),
                           vl.contiguous(), pl, pos, window=window)[:, None]

    return local_map(local, out_placements=(qp,),
                     in_placements=(qp, kp, kp, whole),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k_cache, v_cache,
                                               cache_pos)


def attn_decode_step(params, cfg: ArchConfig, x: torch.Tensor, cache: dict,
                     pos: int) -> Tuple[torch.Tensor, dict]:
    """x: [B, 1, d]; cache: {"k", "v", "pos"[, "k_scale", "v_scale"]};
    pos: the current index (an int).

    Returns (out [B, 1, d], cache), the cache updated in place: slot
    ``pos % T`` takes the new K/V (a ring buffer under a sliding window);
    an int8 cache quantizes the new K/V and dequantizes on read.  On a
    DTensor cache the rank holding the slot writes it (``write_slot``).
    """
    positions = replicated(torch.full((x.shape[0], 1), pos,
                                      dtype=torch.int32, device=x.device), x)
    q, k, v = _project_qkv(params, cfg, x, positions)
    T = cache["k"].shape[1]
    slot = pos % T
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        write_slot(cache["k"], 1, slot, kq[:, 0])
        write_slot(cache["v"], 1, slot, vq[:, 0])
        write_slot(cache["k_scale"], 1, slot, ks[:, 0])
        write_slot(cache["v_scale"], 1, slot, vs[:, 0])
        k_read = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_read = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        write_slot(cache["k"], 1, slot, k[:, 0])
        write_slot(cache["v"], 1, slot, v[:, 0])
        k_read, v_read = cache["k"], cache["v"]
    write_slot(cache["pos"], 0, slot, pos)
    out = decode_attention(q, k_read, v_read, cache["pos"], pos,
                           window=cfg.sliding_window)
    return out_proj(out, params["wo"]), cache


def attn_flops_per_token(cfg: ArchConfig, kv_len: int) -> float:
    """Projections + scores + AV per token (decode roofline helper)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    eff = kv_len if cfg.sliding_window == 0 else min(kv_len, cfg.sliding_window)
    proj = 2 * d * hd * (2 * KV + 2 * H)
    scores = 2 * H * hd * eff * 2
    return proj + scores
