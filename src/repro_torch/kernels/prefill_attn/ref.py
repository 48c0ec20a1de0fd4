"""Plain PyTorch version of the flash-prefill attention kernel (B8).

Port of the reference's ``models.attention.chunked_attention``
(``repro/models/attention.py:60-113``), an XLA program in the reference:
a loop over KV chunks with the running (max, sum, acc) in float32 and the
finite ``NEG_INF``.  A chunk masked out for a row leaves a finite running
max there, and the next live chunk wipes its share through
``corr = exp(m - m_new)``; a row with no live key in any chunk gives
every key (the zero-padded slots too) the weight 1.  The CPU path of the
port runs on it, the CUDA kernel is held to it on the card, and the
kernel's autograd Function differentiates it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
F32 = torch.float32


def mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
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
    zero = torch.full((), 0.0, dtype=F32, device=ok.device)
    neg = torch.full((), NEG_INF, dtype=F32, device=ok.device)
    return torch.where(ok, zero, neg)


def prefill_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                     causal: bool, window: int, chunk: int) -> torch.Tensor:
    """q: [B, Sq, H, D]; k / v: [B, Sk, KV, D]; q_pos [Sq], k_pos [Sk]
    integer positions -> [B, Sq, H, D] in q's dtype.

    Sk is padded to a multiple of ``chunk`` with key position -10**9,
    which the mask drops.  GQA groups the heads as [B, Sq, KV, G, D]."""
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
        s = s + mask_bias(q_pos, k_pos[c0:c0 + chunk], causal,
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


def tile_map_ref(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                 window: int, q_tile: int, k_tile: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two tile maps as bool [n_q_tiles, n_k_tiles]: ``any``
    is True where key tile kt holds a key that may be live for a row of
    query tile qt (k_pos >= 0, <= the tile's largest q_pos if causal, >
    its smallest q_pos - window; a False tile is masked for every row and
    skipped), ``whole`` where every key of a whole tile is live for every
    row (<= the smallest q_pos if causal, > the largest - window; such a
    tile skips the mask)."""
    Sq, Sk = q_pos.shape[0], k_pos.shape[0]
    n_qt, n_kt = -(-Sq // q_tile), -(-Sk // k_tile)
    qp = q_pos.to(torch.int64)
    kp = F.pad(k_pos.to(torch.int64), (0, n_kt * k_tile - Sk), value=-1)
    any_ = torch.zeros((n_qt, n_kt), dtype=torch.bool, device=q_pos.device)
    whole = torch.zeros_like(any_)
    for qt in range(n_qt):
        rows = qp[qt * q_tile:(qt + 1) * q_tile]
        some, every = kp >= 0, kp >= 0
        if causal:
            some = some & (kp <= rows.max())
            every = every & (kp <= rows.min())
        if window > 0:
            some = some & (kp > rows.min() - window)
            every = every & (kp > rows.max() - window)
        any_[qt] = some.view(n_kt, k_tile).any(dim=1)
        whole[qt] = every.view(n_kt, k_tile).all(dim=1)
    return any_, whole


def packed_tile_positions(G: int, rows: int = 128) -> int:
    """Query positions of one of the bf16 kernel's tiles: its ``rows``
    rows are (position, head) pairs of one kv head, the min(G, rows) heads
    of a position side by side (G > rows is cut into chunks of heads)."""
    return rows // min(G, rows)


def prefill_attn_tiled_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_pos: torch.Tensor,
                           k_pos: torch.Tensor, *, causal: bool, window: int,
                           chunk: int, q_tile: int = 64, k_tile: int = 64,
                           packed_rows: int = 0) -> torch.Tensor:
    """Mirror of the CUDA kernels' arithmetic, for the tests: query tiles
    of ``q_tile`` positions (the float32 kernel's: one head a block), or,
    with ``packed_rows``, the bf16 kernel's tiles of that many (position,
    head) rows of one kv head, ``packed_tile_positions(G, packed_rows)``
    positions a tile; each tile over the key tiles of ``k_tile`` that its
    tile map keeps, masked scores -inf (a tile whose keys are all live has
    nothing to mask), an online softmax a key tile, bf16 probabilities
    rounded before the PV product; a row with no live key (m still -inf)
    takes the reference's sum of every v over ceil(Sk / chunk) * chunk.  A
    row's arithmetic depends only on its own position and its tile's
    positions (which key tiles the map keeps), so the packing is the
    choice of q_tile.  Same arguments and result as
    :func:`prefill_attn_ref`."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if packed_rows:
        q_tile = packed_tile_positions(G, packed_rows)
    qg = q.reshape(B, Sq, KV, G, D).to(F32)
    s_all = torch.einsum("bqkgd,bckd->bqkgc", qg, k.to(F32)) * D ** -0.5
    dq, dk = q_pos[:, None].to(torch.int64), k_pos[None, :].to(torch.int64)
    live = (dk >= 0).expand(Sq, Sk)
    if causal:
        live = live & (dk <= dq)
    if window > 0:
        live = live & (dk > dq - window)
    tiles, _ = tile_map_ref(q_pos, k_pos, causal, window, q_tile, k_tile)
    vf = v.to(F32)
    dead_out = vf.sum(dim=1) / float(-(-Sk // chunk) * chunk)  # [B, KV, D]
    out = torch.empty((B, Sq, KV, G, D), dtype=F32, device=q.device)
    ninf = torch.full((), float("-inf"), dtype=F32, device=q.device)
    for qt in range(tiles.shape[0]):
        r0, r1 = qt * q_tile, min(Sq, (qt + 1) * q_tile)
        m = torch.full((B, r1 - r0, KV, G), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, r1 - r0, KV, G, D), device=q.device)
        for kt in torch.nonzero(tiles[qt]).flatten().tolist():
            c0, c1 = kt * k_tile, min(Sk, (kt + 1) * k_tile)
            s = torch.where(live[r0:r1, None, None, c0:c1],
                            s_all[:, r0:r1, :, :, c0:c1], ninf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            mu = torch.where(m_new == float("-inf"), 0.0, m_new)
            p = torch.exp(s - mu[..., None])
            corr = torch.exp(m - mu)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p.to(q.dtype).to(F32), vf[:, c0:c1])
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        dead = (m == float("-inf"))[..., None]
        out[:, r0:r1] = torch.where(dead, dead_out[:, None, :, None, :], o)
    return out.reshape(B, Sq, H, D).to(q.dtype)
