"""Wrapper of the flash-prefill attention kernel B8, and its autograd
Function.

For CUDA tensors ``prefill_attn`` launches the hand-written kernel
(``csrc/prefill_attn.cu``) or raises; for CPU tensors it runs the plain
PyTorch version in ``ref.py``.  It counts its calls that launch the kernel
in a plain integer attribute, ``launches``, so a run can show that its
main path went through the kernel.  A float32 call is two launches: the
tile maps (which key tiles a query tile may reach, and which it reaches
whole), then the attention; a bf16 call is one launch, whose producer warp
decides the same per tile of packed (position, head) rows.

``prefill_attention`` is the program the models call: an autograd
Function whose forward is ``prefill_attn`` and whose backward is the
vector-Jacobian product of the plain version, recomputed (the reference
has no backward kernel; XLA differentiates its program).
"""
from __future__ import annotations

import torch

from .._build import launch
from .ref import prefill_attn_ref

_ENTRY = {torch.float32: "prefill_attn_f32",
          torch.bfloat16: "prefill_attn_bf16"}
#: float32: query rows of a block (4 warps of 16, ``kBQ``)
QUERY_TILE = 64
#: bf16: (position, head) rows of a block's tile (``kRows``: two consumer
#: warpgroups of 64), the G heads of a position side by side
PACKED_ROWS = 128
#: key rows of a tile, by dtype (``kBK`` and ``kBN`` in the source)
KEY_TILE = {torch.float32: 32, torch.bfloat16: 128}
#: the widest head the kernel takes (its q and output fragments live in
#: registers); D must be a multiple of 16 (the bf16 products' depth)
MAX_D = 128
#: shared memory a block may opt into on Hopper
MAX_SMEM_BYTES = 232448


def smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` and
    ``wg_smem_bytes`` in the source).  float32: q's tile and two stages of
    K and V tiles, each row padded by 16 bytes, and the stages' key
    positions.  bf16: 1,024 bytes of alignment slack, two q tiles and two
    stages of K and V tiles of 128 rows in 64-column boxes (two at
    D > 64), the stages' key positions and (tile, whole) words, and 12
    mbarriers; the kernel adds a copy of k_pos when it still fits."""
    if dtype == torch.bfloat16:
        tile = (2 if D > 64 else 1) * PACKED_ROWS * 128
        kt = KEY_TILE[dtype]
        return 1024 + 6 * tile + 2 * kt * 4 + 2 * 8 + 12 * 8
    item = torch.empty((), dtype=dtype).element_size()
    ld = D + 16 // item
    kt = KEY_TILE[dtype]
    return (QUERY_TILE + 4 * kt) * ld * item + 2 * kt * 4


def tile_map_words(Sq: int, Sk: int, dtype: torch.dtype) -> int:
    """int32 words of the float32 kernel's two tile maps (key tiles that
    may hold a live key, key tiles all live): one bit a key tile for each
    query tile.  The bf16 kernel needs none (0)."""
    if dtype == torch.bfloat16:
        return 0
    n_kt = -(-Sk // KEY_TILE[dtype])
    return 2 * -(-Sq // QUERY_TILE) * -(-n_kt // 32)


def prefill_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                 window: int, chunk: int) -> torch.Tensor:
    """Chunked online-softmax GQA attention over a full sequence.

    q: [B, Sq, H, D]; k / v: [B, Sk, KV, D] in q's dtype (float32 or
    bfloat16); q_pos [Sq], k_pos [Sk] int32 positions (a key at a negative
    position is masked); ``causal`` keeps keys at positions <= the
    query's, ``window > 0`` those at > the query's - window; ``chunk`` is
    the plain version's KV chunk, which only a row with no live key reads
    -> [B, Sq, H, D] in q's dtype.
    """
    if q.device.type == "cpu":
        return prefill_attn_ref(q, k, v, q_pos, k_pos, causal=causal,
                                window=window, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"no prefill attention kernel for device "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected q [B, Sq, H, D] and k/v [B, Sk, KV, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, KV, D) or v.shape != k.shape:
        raise ValueError(f"k/v must both be [B, Sk, KV, D] = "
                         f"{(B, Sk, KV, D)}, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if tuple(q_pos.shape) != (Sq,) or tuple(k_pos.shape) != (Sk,) or \
            q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise ValueError(f"q_pos / k_pos must be int32 [{Sq}] / [{Sk}], got "
                         f"{q_pos.dtype} {tuple(q_pos.shape)} / "
                         f"{k_pos.dtype} {tuple(k_pos.shape)}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share float32 or bfloat16, got "
                         f"{q.dtype} / {k.dtype} / {v.dtype}")
    if not (q.device == k.device == v.device == q_pos.device
            == k_pos.device):
        raise ValueError("q, k, v and the positions must lie on one device")
    if not all(t.is_contiguous() for t in (q, k, v, q_pos, k_pos)):
        raise ValueError("q, k, v and the positions must be contiguous")
    if KV == 0 or H % KV:
        raise ValueError(f"H = {H} must be a multiple of KV = {KV}")
    if D % 16 or not 0 < D <= MAX_D:
        raise ValueError(f"the kernel takes head dims that are multiples of "
                         f"16 up to {MAX_D} (the bf16 products' depth, the "
                         f"output's fragments in registers): D = {D}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    n_pad = -(-Sk // chunk) * chunk
    n_qt = -(-Sq // QUERY_TILE)
    if Sk == 0 or n_pad >= 2 ** 31 or B >= 2 ** 16 or n_qt >= 2 ** 16 or \
            B * max(Sq, Sk) * H * D >= 2 ** 62:
        raise ValueError(f"the kernel takes 0 < Sk, Sk padded to the chunk "
                         f"< 2^31, B < 2^16 and Sq / {QUERY_TILE} < 2^16, "
                         f"got B={B}, Sq={Sq}, Sk={Sk}, chunk={chunk}")
    need = smem_bytes(D, q.dtype)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"a block's tiles need {need} B of shared memory "
                         f"at D={D}, > {MAX_SMEM_BYTES} B")
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    words = tile_map_words(Sq, Sk, q.dtype)
    tiles = torch.empty(words, dtype=torch.int32, device=q.device) \
        if words else None
    launch(_ENTRY[q.dtype], q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
           tiles.data_ptr() if words else None, out.data_ptr(), B, Sq, Sk,
           H, KV, D, int(bool(causal)), int(window), n_pad)
    prefill_attn.launches += 1
    return out


prefill_attn.launches = 0


class PrefillAttention(torch.autograd.Function):
    """``prefill_attn`` forward; the plain version's vector-Jacobian
    product, recomputed, backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, chunk):
        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        ctx.args = (causal, window, chunk)
        return prefill_attn(q, k, v, q_pos, k_pos, causal=causal,
                            window=window, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        causal, window, chunk = ctx.args
        want = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip((q, k, v), want)]
            out = prefill_attn_ref(*leaves, q_pos, k_pos, causal=causal,
                                   window=window, chunk=chunk)
            grads = torch.autograd.grad(
                out, [t for t, w in zip(leaves, want) if w], grad_out)
        it = iter(grads)
        return tuple(next(it) if w else None for w in want) + (None,) * 5


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int, chunk: int) -> torch.Tensor:
    """``prefill_attn`` with gradients (see ``PrefillAttention``)."""
    return PrefillAttention.apply(q, k, v, q_pos, k_pos, causal, window,
                                  chunk)
