"""Plain PyTorch version of the training loss kernel B11 (linear_ce), and a
CPU mirror of its launch plan.

B11 computes the reference's ``chunked_cross_entropy``
(``repro/models/layers.py:131-173``) over all rows at once, forward and
backward, from the pre-head hidden states h [N, d] and the head W [d, V]
(V = V_pad, the padded vocabulary):

* logits = h . W in float32; columns >= ``vocab_size`` set to -1e30;
* lse = m + log sum exp(logits - m), m the row max;
* gold = logits[label] (the label clamped at 0), valid = label >= 0;
* tot = sum (lse - gold) valid, cnt = sum valid, loss = tot / max(cnt, 1).

The backward, with cotangent ``scale`` on the loss sum tot (g / max(cnt,
1) for the loss's cotangent g): dlogits = scale * valid * (softmax -
onehot), zero on the padded columns, rounded to h's dtype; dh = dlogits .
W^T and dW = h^T . dlogits with float32 sums, rounded to the operands'
dtypes (the port's plain route does the same:
``models.layers._MatmulF32.backward``).

A vocab-sharded head's rank holds W's columns [col0, col0 + V): a label
outside them counts its row but has no gold logit and no one-hot there.
Its forward is ``linear_ce_partials_ref`` (a row's max, sum exp and gold
over its columns), every rank's partials gathered, then
``linear_ce_combine_ref``; its backward is the formula above on its
columns with the combined lse (dh a partial sum over the ranks).

``linear_ce_fwd_ref`` and ``linear_ce_bwd_ref`` are that formula written
out; the CPU route of ``LinearCE`` runs on them and the kernels are held to
them on the card.  ``linear_ce_plan`` and ``smem_bytes`` repeat, on the
host, what the wrapper and the kernels decide: tiles, vocab splits of the
forward, the split of dh's long K, the persistent grids and the row passes
of the backward; the tests hold them on the CPU.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ...models.layers import no_tf32

F32 = torch.float32

#: the reference's fill of the padded vocabulary columns
MASK = -1e30
#: shared memory a block may opt into on Hopper
MAX_SMEM_BYTES = 232448
#: streaming multiprocessors of an H100 SXM (the wrapper passes the card's
#: own count)
HOPPER_SMS = 132
#: source constants (csrc/linear_ce.cu): the bf16 route's output tile
#: (rows x columns) and k-tile depth, its ring stages; the float32 route's
#: tile
WG_ROWS, WG_COLS, WG_DEPTH, WG_STAGES = 128, 256, 64, 4
#: the bf16 route's staged epilogue (K2, a whole K3 into bf16): a consumer
#: warp's box of rows x 64 columns a TMA store, boxes a warp, consumer warps
WG_OUT_ROWS, WG_OUT_BOXES, WG_CONSUMER_WARPS = 16, 2, 8
SIMT_ROWS, SIMT_COLS, SIMT_DEPTH = 64, 64, 16
#: at most this many splits of dh's K (the vocabulary)
MAX_K_SPLIT = 8


def _logits(h: torch.Tensor, w: torch.Tensor, vocab_size: int
            ) -> torch.Tensor:
    """float32 logits [N, V] of h [N, d] and w [d, V], padded columns
    -1e30.  Both operands in float32 (a bf16 value is exact there) and no
    TF32: the products of exact values summed in float32."""
    with no_tf32():
        logits = h.to(F32) @ w.to(F32)
    if w.shape[-1] != vocab_size:
        logits[:, vocab_size:] = MASK
    return logits


def live_columns(vocab_size: int, col0: int, width: int) -> int:
    """The live columns of a head of ``width`` columns from ``col0`` of a
    vocabulary of ``vocab_size`` (0 for a shard in the padded tail)."""
    return min(max(vocab_size - col0, 0), width)


def _columns(labels: torch.Tensor, col0: int, width: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's label as a column of this head (0 where it has none) and
    whether it has one."""
    c = labels.long() - col0
    mine = (c >= 0) & (c < width)
    return torch.where(mine, c, torch.zeros_like(c)), mine


def linear_ce_partials_ref(h: torch.Tensor, w: torch.Tensor,
                           labels: torch.Tensor, vocab_size: int,
                           col0: int = 0) -> torch.Tensor:
    """K1's partials over w's columns as one split: [3, 1, N] float32, a
    row's max, sum of exp(logit - max) and gold logit (0 where its label is
    not a column of w)."""
    V = w.shape[-1]
    logits = _logits(h, w, live_columns(vocab_size, col0, V))
    m = logits.max(dim=-1).values
    s = torch.exp(logits - m[:, None]).sum(dim=-1)
    idx, mine = _columns(labels, col0, V)
    gold = torch.gather(logits, -1, idx[:, None])[:, 0]
    gold = torch.where(mine, gold, torch.zeros_like(gold))
    return torch.stack([m, s, gold])[:, None]


def linear_ce_combine_ref(part: torch.Tensor, labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The combine: part [3, n_split, N] -> (tot, cnt) float32 scalars and
    lse [N] float32."""
    m = part[0].max(dim=0).values
    lse = m + torch.log((part[1] * torch.exp(part[0] - m)).sum(dim=0))
    valid = (labels >= 0).to(F32)
    return ((lse - part[2].sum(dim=0)) * valid).sum(), valid.sum(), lse


def linear_ce_fwd_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      vocab_size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h [N, d], w [d, V] (either layout), labels [N] int (-1: none) ->
    (tot, cnt) float32 scalars and lse [N] float32."""
    return linear_ce_combine_ref(
        linear_ce_partials_ref(h, w, labels, vocab_size), labels)


def dlogits_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                lse: torch.Tensor, scale: torch.Tensor, vocab_size: int,
                col0: int = 0) -> torch.Tensor:
    """The cotangent on w's columns of the logits, [N, V] in h's dtype:
    scale * valid * (exp(logits - lse) - onehot), exact zeros on the
    padded columns and the unlabelled rows."""
    V = w.shape[-1]
    live = live_columns(vocab_size, col0, V)
    logits = _logits(h, w, live)
    p = torch.exp(logits - lse[:, None])
    idx, mine = _columns(labels, col0, V)
    p.scatter_add_(-1, idx[:, None], -mine.to(F32)[:, None])
    p[:, live:] = 0
    scale = scale.to(F32).reshape(())
    rows = torch.where(labels >= 0, scale, torch.zeros_like(scale))
    return (p * rows[:, None]).to(h.dtype)


def linear_ce_bwd_ref(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, scale: torch.Tensor,
                      vocab_size: int, col0: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh [N, d] in h's dtype, dW [d, V] in w's dtype) under the
    cotangent ``scale`` on the loss sum (g / max(cnt, 1) for the loss's
    cotangent g)."""
    dl = dlogits_ref(h, w, labels, lse, scale, vocab_size, col0).to(F32)
    with no_tf32():
        dh = (dl @ w.to(F32).T).to(h.dtype)
        dw = (h.to(F32).T @ dl).to(w.dtype)
    return dh, dw


@dataclass(frozen=True)
class LinearCEPlan:
    """What one call launches (the source's ``fwd`` / ``dlogits`` /
    ``gemm``): the route ("wgmma": bf16, "simt": float32), the output tile
    (rows x columns) and k-tile depth, the row tiles and vocab tiles of the
    logits, the forward's vocab splits (an item: a row tile and a split's
    contiguous vocab tiles), the backward's rows a pass, dh's split of its
    K (the vocabulary; float32 partials summed in a fixed order), and the
    grids (the bf16 route: a persistent block an SM, at most ``sms``)."""
    route: str
    rows: int
    d: int
    v_pad: int
    tile_rows: int
    tile_cols: int
    depth: int
    row_tiles: int
    vocab_tiles: int
    n_split: int
    fwd_grid: int
    pass_rows: int
    dh_split: int
    dh_tiles: Tuple[int, int]          # (row tiles, d tiles) of a pass
    dw_tiles: Tuple[int, int]          # (d or V tiles, V or d tiles)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_bounds(n_tiles: int, n_split: int, s: int) -> Tuple[int, int]:
    """The vocab tiles [lo, hi) of split s (the source's ``split_lo``)."""
    return s * n_tiles // n_split, (s + 1) * n_tiles // n_split


def _waves(items: int, sms: int) -> int:
    return _cdiv(items, min(items, sms))


@functools.lru_cache(maxsize=256)
def linear_ce_plan(N: int, d: int, V: int, dtype: torch.dtype,
                   dl_bytes: int, tied: bool = False,
                   sms: int = HOPPER_SMS) -> LinearCEPlan:
    """The launch plan for h [N, d], a head of V columns and at most
    ``dl_bytes`` of dlogits a backward pass (the plain program's float32
    chunk logits).  The forward's vocab splits fill the card: an item is a
    row tile and 1 / n_split of the vocab tiles, and the split is the one
    whose busiest block (items a block x tiles an item, plus a quarter
    tile for an item's flush) is least, the fewest splits among equals.
    dh's K split (bf16 route) is chosen the same way, an item costing its
    k-tiles plus 2 for its epilogue and one a split for the sum.  The
    staged epilogue (K2's dl and dW leave by TMA stores) keeps the tile
    and the walk, so the same costs hold: at [train]'s call 8 splits of
    16 row tiles (128 items, one wave of 132 SMs) and dh split 4 (640
    items of 600 k-tiles)."""
    if dtype == torch.bfloat16:
        route, rows, cols, depth = "wgmma", WG_ROWS, WG_COLS, WG_DEPTH
    elif dtype == F32:
        route, rows, cols, depth = "simt", SIMT_ROWS, SIMT_COLS, SIMT_DEPTH
    else:
        raise ValueError(f"no linear_ce kernel for {dtype}")
    n_mt, n_vt = _cdiv(N, rows), _cdiv(V, cols)
    if route == "wgmma":
        best = None
        for s in range(1, min(n_vt, 1024) + 1):
            cost = _waves(n_mt * s, sms) * (_cdiv(n_vt, s) + 0.25)
            if best is None or cost < best[0]:
                best = (cost, s)
        n_split = best[1]
        fwd_grid = min(n_mt * n_split, sms)
    else:
        n_split = min(n_vt, _cdiv(4 * sms, n_mt))
        fwd_grid = n_mt * n_split
    elem = torch.finfo(dtype).bits // 8
    pass_rows = max(1, min(N, dl_bytes // (V * elem)))
    if rows < pass_rows < N:
        pass_rows -= pass_rows % rows
    dh_tiles = (_cdiv(pass_rows, rows), _cdiv(d, cols))
    dh_split = 1
    if route == "wgmma":
        nk = _cdiv(V, depth)
        best = None
        for s in range(1, min(MAX_K_SPLIT, nk) + 1):
            items = dh_tiles[0] * dh_tiles[1] * s
            cost = _waves(items, sms) * (_cdiv(nk, s) + 2 + (s if s > 1
                                                             else 0))
            if best is None or cost < best[0]:
                best = (cost, s)
        dh_split = best[1]
    dw_tiles = ((_cdiv(V, rows), _cdiv(d, cols)) if tied
                else (_cdiv(d, rows), _cdiv(V, cols)))
    return LinearCEPlan(route, N, d, V, rows, cols, depth, n_mt, n_vt,
                        n_split, fwd_grid, pass_rows, dh_split, dh_tiles,
                        dw_tiles)


def smem_bytes(plan: LinearCEPlan) -> int:
    """Shared memory of a block (the source's ``kWgSmem`` and the simt
    kernel's static arrays): bf16, 1,024 bytes of alignment slack, the
    ring (a 128-row k-tile of A and a 256-column k-tile of B, bf16, a
    stage), the staged epilogue's output boxes (two bf16 boxes of 16 rows
    x 64 columns a consumer warp), a full and an empty mbarrier a stage
    and 16 bytes (the split sum's flag); float32, two buffers of the
    transposed A tile (rows + 4 padding) and of the B tile."""
    if plan.route == "wgmma":
        stage = (plan.tile_rows + plan.tile_cols) * plan.depth * 2
        boxes = WG_CONSUMER_WARPS * WG_OUT_BOXES * WG_OUT_ROWS * 64 * 2
        return 1024 + WG_STAGES * stage + boxes + 2 * WG_STAGES * 8 + 16
    return 2 * plan.depth * (plan.tile_rows + 4) * 4 + \
        2 * plan.depth * plan.tile_cols * 4
