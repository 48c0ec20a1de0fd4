"""Wrapper of the SSD chunked-scan kernel B9, and its autograd Function.

For CUDA tensors ``ssd_scan`` launches the hand-written kernels
(``csrc/ssd_scan.cu``) or raises; for CPU tensors it runs the plain
PyTorch version in ``ref.py``.  It counts its calls that launch the
kernels in a plain integer attribute, ``launches``, so a run can show that
its main path went through them.  A call is three launches: the chunk
states and C·Bᵀ, the sequential pass over chunks, the chunk outputs.

``ssd_scan_fn`` is the program the models call: an autograd Function whose
forward is ``ssd_scan`` and whose backward is the vector-Jacobian product
of the plain version, recomputed (the reference has no backward kernel;
XLA differentiates its program).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._build import launch
from .ref import ssd_scan_ref

F32 = torch.float32
_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
#: the longest chunk and the widest head and state the kernels take (a
#: chunk's cumulative decays live in one block's threads; an output tile
#: is at most 128 columns wide)
MAX_CHUNK = 256
MAX_P = 128
MAX_N = 128


def scratch_shapes(B: int, S: int, H: int, P: int, N: int, Q: int):
    """float32 scratch of one call: every chunk's state (its own chunk
    state, then the state entering it) [B, n_chunks, H, N, P], C·Bᵀ of
    every chunk stored [B, n_chunks, s, q], the cumulative log decays
    [B, n_chunks, H, Q] and their chunk totals [B, n_chunks, H]."""
    nc = -(-S // Q)
    return ((B, nc, H, N, P), (B, nc, Q, Q), (B, nc, H, Q), (B, nc, H))


def ssd_scan(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, a_log: torch.Tensor, *, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xh: [B, S, H, P] (float32 or bfloat16); Bm / Cm:
    [B, S, N] in xh's dtype; dt, a_log: [B, S, H] float32 (post-softplus
    step and log decay); chunks of Q = min(chunk, S) -> (y [B, S, H, P] in
    xh's dtype, the final float32 state [B, H, P, N])."""
    if xh.device.type == "cpu":
        return ssd_scan_ref(xh, Bm, Cm, dt, a_log, chunk=chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"no SSD scan kernel for device {xh.device}")
    if xh.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"expected xh [B, S, H, P] and B/C [B, S, N], got "
                         f"{tuple(xh.shape)}, {tuple(Bm.shape)}")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if tuple(Bm.shape) != (B, S, N) or Cm.shape != Bm.shape:
        raise ValueError(f"B and C must both be [B, S, N] = {(B, S, N)}, got "
                         f"{tuple(Bm.shape)} / {tuple(Cm.shape)}")
    if tuple(dt.shape) != (B, S, H) or a_log.shape != dt.shape:
        raise ValueError(f"dt and a_log must both be [B, S, H] = "
                         f"{(B, S, H)}, got {tuple(dt.shape)} / "
                         f"{tuple(a_log.shape)}")
    if xh.dtype not in _ENTRY or Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
        raise ValueError(f"xh, B and C must share float32 or bfloat16, got "
                         f"{xh.dtype} / {Bm.dtype} / {Cm.dtype}")
    if dt.dtype != F32 or a_log.dtype != F32:
        raise ValueError(f"dt and a_log must be float32, got {dt.dtype} / "
                         f"{a_log.dtype}")
    if not all(t.device == xh.device for t in (Bm, Cm, dt, a_log)):
        raise ValueError("xh, B, C, dt and a_log must lie on one device")
    if not all(t.is_contiguous() for t in (xh, Bm, Cm, dt, a_log)):
        raise ValueError("xh, B, C, dt and a_log must be contiguous")
    Q = min(chunk, S)
    if chunk <= 0 or Q > MAX_CHUNK or not 0 < P <= MAX_P or \
            not 0 < N <= MAX_N:
        raise ValueError(f"the kernels take chunks of 1..{MAX_CHUNK} rows "
                         f"(a chunk's decays in one block), P <= {MAX_P} and "
                         f"N <= {MAX_N} (output tiles of at most 128 "
                         f"columns): Q = min(chunk, S) = {Q}, P = {P}, N = "
                         f"{N}")
    nc = -(-S // Q) if S else 0
    if B >= 2 ** 16 or nc * -(-Q // 64) >= 2 ** 16 or \
            B * S * H * P >= 2 ** 31 or B * nc * H * N * P >= 2 ** 31:
        raise ValueError(f"the kernels' grids take B < 2^16 and n_chunks * "
                         f"ceil(Q / 64) < 2^16, and 32-bit element counts: "
                         f"got B={B}, S={S}, H={H}, P={P}, N={N}, Q={Q}")
    y = torch.empty_like(xh)
    state = torch.empty((B, H, P, N), dtype=F32, device=xh.device)
    if B == 0 or S == 0 or H == 0:
        return y, state.zero_()
    states, gt, la, la_last = (torch.empty(s, dtype=F32, device=xh.device)
                               for s in scratch_shapes(B, S, H, P, N, Q))
    launch(_ENTRY[xh.dtype], xh.device, xh.data_ptr(), Bm.data_ptr(),
           Cm.data_ptr(), dt.data_ptr(), a_log.data_ptr(), y.data_ptr(),
           state.data_ptr(), states.data_ptr(), gt.data_ptr(), la.data_ptr(),
           la_last.data_ptr(), B, S, H, P, N, Q)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` forward; the plain version's vector-Jacobian product,
    recomputed, backward."""

    @staticmethod
    def forward(ctx, xh, Bm, Cm, dt, a_log, chunk):
        ctx.save_for_backward(xh, Bm, Cm, dt, a_log)
        ctx.chunk = chunk
        return ssd_scan(xh, Bm, Cm, dt, a_log, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        want = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(ctx.saved_tensors, want)]
            y, state = ssd_scan_ref(*leaves, chunk=ctx.chunk)
            grads = torch.autograd.grad(
                (y, state), [t for t, w in zip(leaves, want) if w],
                (grad_y, grad_state))
        it = iter(grads)
        return tuple(next(it) if w else None for w in want) + (None,)


def ssd_scan_fn(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                dt: torch.Tensor, a_log: torch.Tensor, *, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_scan`` with gradients (see ``SSDScan``)."""
    return SSDScan.apply(xh, Bm, Cm, dt, a_log, chunk)
