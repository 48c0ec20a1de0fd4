"""Plain PyTorch version of the decode attention kernel (B7).

Port of the reference's ``models.attention.decode_attention``
(``repro/models/attention.py:193-215``), the oracle of its Pallas kernel
and the function its serving engine runs: scores in float32, masked slots
at -1e30, a softmax over the whole cache, the probabilities rounded to q's
dtype before the PV product (accumulated in float32), the output in q's
dtype.  The CPU path of the port runs on it, and the CUDA kernel is held to
it on the card.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

NEG_INF = -1e30
#: the kernel's score of a masked slot
KERNEL_NEG = -3.0e38
F32 = torch.float32


def decode_attn_ref(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, cache_pos: torch.Tensor, pos,
                    *, window: int = 0) -> torch.Tensor:
    """q: [B, H, D]; k/v: [B, T, KV, D]; cache_pos: [T] int (-1 = empty
    slot); pos: the current position -> [B, H, D] in q's dtype."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = D ** -0.5
    qg = q.reshape(B, KV, G, D).to(F32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.to(F32)) * scale
    ok = (cache_pos >= 0) & (cache_pos <= pos)
    if window > 0:
        ok &= cache_pos > pos - window
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(q.dtype).to(F32),
                       v_cache.to(F32))
    return out.reshape(B, H, D).to(q.dtype)


def decode_attn_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_pos: torch.Tensor,
                          pos, P: int, *, window: int = 0, tile: int = 256,
                          warps: int = 8) -> torch.Tensor:
    """Float32 mirror of the CUDA kernel's split-and-merge arithmetic, for
    the tests: the cache cut into the ``P`` ranges ``[r*T//P, (r+1)*T//P)``
    of a cluster's blocks, each range into the slots its ``warps`` warps own
    (``tile // warps`` consecutive slots of every ``tile``), a flash partial
    (max m, sum l, acc) per warp, merged per block in warp order and then
    over the blocks in rank order with ``exp(m - M)`` weights.  Masked slots
    score -3e38 as in the kernel; a partial with no slot has m = -inf and
    weighs 0.  Same arguments and result as :func:`decode_attn_ref`."""
    B, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, D).to(F32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.to(F32)) * D ** -0.5
    ok = (cache_pos >= 0) & (cache_pos <= pos)
    if window > 0:
        ok &= cache_pos > pos - window
    s = torch.where(ok, s, KERNEL_NEG)
    v = v_cache.to(F32)
    t = torch.arange(T, device=q.device)
    blocks = []
    for r in range(P):
        lo, hi = r * T // P, (r + 1) * T // P
        warp_of = (t - lo) % tile // (tile // warps)
        blocks.append(_merge([
            _partial(s, v, (t >= lo) & (t < hi) & (warp_of == w))
            for w in range(warps)]))
    _, l, acc = _merge(blocks)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _partial(s: torch.Tensor, v: torch.Tensor, sel: torch.Tensor) -> State:
    """(m, l, acc) of the slots ``sel``: s [B, KV, G, T], v [B, T, KV, D]."""
    s, v = s[..., sel], v[:, sel]
    m = (s.amax(-1) if s.shape[-1]
         else torch.full(s.shape[:-1], float("-inf"), device=s.device))
    p = torch.exp(s - _finite_or_zero(m)[..., None])
    return m, p.sum(-1), torch.einsum("bkgt,btkd->bkgd", p, v)


def _merge(states: List[State]) -> State:
    """Flash partials merged in list order with exp(m - M) weights."""
    M = torch.stack([m for m, _, _ in states]).amax(0)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(states[0][2])
    for m, l_i, acc_i in states:
        f = torch.exp(m - _finite_or_zero(M))
        l = l + f * l_i
        acc = acc + f[..., None] * acc_i
    return M, l, acc


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    """The max a partial subtracts: 0 where it is -inf (no slot), so that
    exp(-inf - m) is 0 and never NaN."""
    return torch.where(m == float("-inf"), 0.0, m)
