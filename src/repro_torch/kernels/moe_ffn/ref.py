"""Plain PyTorch version of the MoE experts' kernel (B10), and a CPU mirror
of its launch plan.

``moe_ffn_ref`` is the stage of the reference's ``models.moe._moe_gather``
(``repro/models/moe.py:63-100``) between the routing and the scatter-add:
the gather of each expert's slots, the experts' SwiGLU (one batched product
a weight, float32 where the reference keeps it: ``experts_ref``) and the
weighting by ``top_w * valid``.  The CPU path of the port runs on it, the
CUDA kernel is held to it on the card, and the kernel's autograd Function
differentiates it.

``moe_ffn_plan`` and ``live_tiles`` repeat, on the host, what the kernel
decides: the regime from the rows an expert and the dtype, the tiles and
grids of its two launches, and which (expert, slot tile) blocks do work.
The kernel decides liveness itself on the device; the mirror exists so
that the tests can hold the plan on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ...models.layers import bmm_f32

F32 = torch.float32

#: the regimes, by their code in the C entry points
REGIMES = {"stream": 0, "tiles": 1, "simt": 2}
#: at most this many rows (slots) an expert take the bf16 stream regime
STREAM_MAX_ROWS = 16
#: shared memory a block may opt into on Hopper
MAX_SMEM_BYTES = 232448
#: source constants (csrc/moe_ffn.cu), by regime: rows of a slot tile,
#: output columns a block of each launch, depth of a k-tile, ring stages
#: of each launch (0: static shared memory, two register-fed buffers)
_ROWS = {"stream": STREAM_MAX_ROWS, "tiles": 128, "simt": 64}
_COLS = {"stream": (64, 64), "tiles": (128, 256), "simt": (64, 64)}
_DEPTH = {"stream": 64, "tiles": 64, "simt": 16}
_STAGES = {"stream": (6, 8), "tiles": (4, 4), "simt": (0, 0)}


def experts_ref(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on xe [G, E, C, d] -> float32 [G, E, C, d]: one
    batched product a weight, float32 where the reference keeps it."""
    G, E, C, d = xe.shape
    x = xe.transpose(0, 1).reshape(E, G * C, d)
    h_g = bmm_f32(x, w_gate)
    h_u = bmm_f32(x, w_up)
    h = (F.silu(h_g) * h_u).to(xe.dtype)
    ye = bmm_f32(h, w_down)                                  # [E, G*C, d]
    return ye.reshape(E, G, C, d).transpose(0, 1)


def moe_ffn_ref(xg: torch.Tensor, top_idx: torch.Tensor, valid: torch.Tensor,
                top_w: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """xg [G, t, d]; top_idx [G, E, Ck] (each expert's tokens of a group);
    valid [G, E, Ck] bool; top_w [G, E, Ck] float32; w_gate / w_up
    [E, d, ff], w_down [E, ff, d] -> ye [G, E, Ck, d] float32, each slot's
    expert output weighted by top_w (exact zeros at dead slots)."""
    G = xg.shape[0]
    groups = torch.arange(G, device=xg.device)[:, None, None]
    xe = xg[groups, top_idx]                                 # [G,E,Ck,d]
    xe = xe * valid[..., None].to(xg.dtype)
    return experts_ref(xe, w_gate, w_up, w_down) * (top_w * valid)[..., None]


@dataclass(frozen=True)
class MoEPlan:
    """The two launches of one call: the regime (``REGIMES``), the rows M =
    G * Ck of an expert, rows of a slot tile, and each launch's block
    columns and grid (x, y, z)."""
    regime: str
    rows: int
    tile_rows: int
    up_cols: int
    down_cols: int
    up_grid: Tuple[int, int, int]
    down_grid: Tuple[int, int, int]
    slot_tiles: int
    nt: int                       # stream: n8 tiles of slots (1 or 2)


def moe_ffn_plan(G: int, E: int, Ck: int, d: int, ff: int,
                 dtype: torch.dtype) -> MoEPlan:
    """What ``moe_ffn`` launches for these widths (the source's ``run``):
    bf16 with at most ``STREAM_MAX_ROWS`` slots an expert streams the
    weights (grid: column blocks x experts, every slot in one block),
    bf16 above it runs tensor-core tiles, float32 the CUDA-core tiles (grid:
    slot tiles x column blocks x experts)."""
    M = G * Ck
    if dtype == torch.bfloat16:
        regime = "stream" if M <= STREAM_MAX_ROWS else "tiles"
    elif dtype == F32:
        regime = "simt"
    else:
        raise ValueError(f"no MoE experts' kernel for {dtype}")
    rows = _ROWS[regime]
    up_cols, down_cols = _COLS[regime]
    if regime == "stream":
        up = (-(-ff // up_cols), E, 1)
        down = (-(-d // down_cols), E, 1)
        tiles = 1
    else:
        tiles = -(-M // rows)
        up = (tiles, -(-ff // up_cols), E)
        down = (tiles, -(-d // down_cols), E)
    return MoEPlan(regime, M, rows, up_cols, down_cols, up, down, tiles,
                   1 if M <= 8 else 2)


def smem_bytes(plan: MoEPlan) -> Tuple[int, int]:
    """Shared memory of a block of each launch (the source's
    ``stream_smem`` / ``tiles_smem``, and the simt kernel's static arrays):
    the cp.async ring (bf16 weight tiles and slot rows), then each row's
    source offset, output offset and weight (8 + 8 + 4 bytes)."""
    rows, depth = plan.tile_rows, _DEPTH[plan.regime]
    if plan.regime == "stream":
        out = []
        for mats, cols, stages in ((2, plan.up_cols, _STAGES["stream"][0]),
                                   (1, plan.down_cols, _STAGES["stream"][1])):
            stage = mats * depth * cols + plan.nt * 8 * depth
            out.append(stages * stage * 2 + rows * 20)
        return tuple(out)
    if plan.regime == "tiles":
        stage = rows * depth + depth * plan.down_cols
        b = _STAGES["tiles"][0] * stage * 2 + rows * 20
        return b, b
    # simt: two buffers of the transposed slot tile (rows + 4 padding) and
    # of the weight tiles (two for up), float32, and the row arrays
    a = 2 * depth * (rows + 4) * 4
    return tuple(a + 2 * mats * depth * plan.down_cols * 4 + rows * 20
                 for mats in (2, 1))


def live_tiles(valid: torch.Tensor, plan: MoEPlan) -> torch.Tensor:
    """valid [G, E, Ck] -> bool [E, slot_tiles]: the (expert, slot tile)
    blocks that read weights, as the kernel's blocks decide from the valid
    flags of their rows (r = g * Ck + c an expert); every other block
    reads none (the up launch writes nothing, the down launch zeros)."""
    G, E, Ck = valid.shape
    rows = valid.permute(1, 0, 2).reshape(E, G * Ck)
    pad = plan.slot_tiles * (plan.tile_rows if plan.regime != "stream"
                             else G * Ck) - G * Ck
    rows = F.pad(rows, (0, pad))
    return rows.reshape(E, plan.slot_tiles, -1).any(-1)
