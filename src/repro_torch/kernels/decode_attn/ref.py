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

import torch

NEG_INF = -1e30
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
