"""Wrapper of the MoE experts' kernel B10, and its autograd Function.

For CUDA tensors ``moe_ffn`` launches the hand-written kernels
(``csrc/moe_ffn.cu``) or raises; for CPU tensors it runs the plain
PyTorch version in ``ref.py``.  It counts its calls that launch the
kernels in a plain integer attribute, ``launches``, so a run can show that
its main path went through them.  A call is two launches: ``moe_up`` (the
gather, the gate and up products and the SwiGLU, into a scratch h in the
model's dtype) and ``moe_down`` (h @ w_down, weighted by top_w).

``moe_ffn_fn`` is the program the models call: an autograd Function whose
forward is ``moe_ffn`` and whose backward is the vector-Jacobian product
of the plain version, recomputed (the reference has no backward kernel;
XLA differentiates its program); on the CPU, the plain version itself.
"""
from __future__ import annotations

import torch

from .._build import launch
from .ref import (MAX_SMEM_BYTES, REGIMES, moe_ffn_plan, moe_ffn_ref,
                  smem_bytes)

F32 = torch.float32
_ENTRY = {torch.float32: "moe_ffn_f32", torch.bfloat16: "moe_ffn_bf16"}


def moe_ffn(xg: torch.Tensor, top_idx: torch.Tensor, valid: torch.Tensor,
            top_w: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """The experts' stage of the gather dispatch.

    xg [G, t, d] (float32 or bfloat16); top_idx [G, E, Ck] int64 (each
    expert's tokens of a group); valid [G, E, Ck] bool; top_w [G, E, Ck]
    float32; w_gate / w_up [E, d, ff] and w_down [E, ff, d] in xg's dtype
    -> ye [G, E, Ck, d] float32: silu(x w_gate) * (x w_up), rounded to the
    dtype, times w_down, times top_w; exact zeros at dead slots.
    """
    if xg.device.type == "cpu":
        return moe_ffn_ref(xg, top_idx, valid, top_w, w_gate, w_up, w_down)
    if xg.device.type != "cuda":
        raise ValueError(f"no MoE experts' kernel for device {xg.device}")
    if xg.dim() != 3 or top_idx.dim() != 3 or w_gate.dim() != 3:
        raise ValueError(f"expected xg [G, t, d], top_idx [G, E, Ck] and "
                         f"weights [E, d, ff], got {tuple(xg.shape)}, "
                         f"{tuple(top_idx.shape)}, {tuple(w_gate.shape)}")
    G, t, d = xg.shape
    E, Ck = top_idx.shape[1], top_idx.shape[2]
    ff = w_gate.shape[-1]
    if top_idx.shape[0] != G or valid.shape != top_idx.shape or \
            top_w.shape != top_idx.shape:
        raise ValueError(f"top_idx, valid and top_w must all be [G, E, Ck] "
                         f"with G = {G}, got {tuple(top_idx.shape)} / "
                         f"{tuple(valid.shape)} / {tuple(top_w.shape)}")
    if tuple(w_gate.shape) != (E, d, ff) or w_up.shape != w_gate.shape or \
            tuple(w_down.shape) != (E, ff, d):
        raise ValueError(f"w_gate / w_up must be [E, d, ff] = {(E, d, ff)} "
                         f"and w_down [E, ff, d], got {tuple(w_gate.shape)} "
                         f"/ {tuple(w_up.shape)} / {tuple(w_down.shape)}")
    if xg.dtype not in _ENTRY or any(w.dtype != xg.dtype
                                     for w in (w_gate, w_up, w_down)):
        raise ValueError(f"xg and the weights must share float32 or "
                         f"bfloat16, got {xg.dtype} / {w_gate.dtype} / "
                         f"{w_up.dtype} / {w_down.dtype}")
    if top_idx.dtype != torch.int64 or valid.dtype != torch.bool or \
            top_w.dtype != F32:
        raise ValueError(f"top_idx must be int64, valid bool and top_w "
                         f"float32, got {top_idx.dtype} / {valid.dtype} / "
                         f"{top_w.dtype}")
    args = (xg, top_idx, valid, top_w, w_gate, w_up, w_down)
    if not all(a.device == xg.device for a in args):
        raise ValueError("the inputs and weights must lie on one device")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("the inputs and weights must be contiguous")
    align = 16 // xg.element_size()
    if d % align or ff % align or any(a.data_ptr() % 16 for a in
                                      (xg, w_gate, w_up, w_down)):
        raise ValueError(f"the kernels load 16-byte runs: d and ff must be "
                         f"multiples of {align} and xg and the weights "
                         f"16-byte aligned, got d={d}, ff={ff}")
    M = G * Ck
    if E >= 2 ** 16 or G * t * d >= 2 ** 62 or M * max(d, ff) >= 2 ** 62 or \
            M >= 2 ** 31 or -(-M // 64) >= 2 ** 31:
        raise ValueError(f"the kernels' grids take E < 2^16 and G * Ck < "
                         f"2^31, got E={E}, G={G}, Ck={Ck}")
    plan = moe_ffn_plan(G, E, Ck, d, ff, xg.dtype)
    need = max(smem_bytes(plan))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"a block needs {need} B of shared memory, > "
                         f"{MAX_SMEM_BYTES} B")
    ye = torch.empty((G, E, Ck, d), dtype=F32, device=xg.device)
    if ye.numel() == 0 or t == 0 or ff == 0:
        return ye.zero_()
    h = torch.empty((E, M, ff), dtype=xg.dtype, device=xg.device)
    launch(_ENTRY[xg.dtype], xg.device, xg.data_ptr(), top_idx.data_ptr(),
           valid.data_ptr(), top_w.data_ptr(), w_gate.data_ptr(),
           w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), ye.data_ptr(),
           G, t, d, E, Ck, ff, REGIMES[plan.regime])
    moe_ffn.launches += 1
    return ye


moe_ffn.launches = 0


class MoEFFN(torch.autograd.Function):
    """``moe_ffn`` forward; the plain version's vector-Jacobian product,
    recomputed, backward."""

    @staticmethod
    def forward(ctx, xg, top_idx, valid, top_w, w_gate, w_up, w_down):
        ctx.save_for_backward(xg, top_idx, valid, top_w, w_gate, w_up, w_down)
        return moe_ffn(xg, top_idx, valid, top_w, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, grad_ye):
        xg, top_idx, valid, top_w, w_gate, w_up, w_down = ctx.saved_tensors
        need = ctx.needs_input_grad
        diff = (xg, top_w, w_gate, w_up, w_down)
        want = (need[0], need[3], need[4], need[5], need[6])
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(w) for a, w in zip(diff, want)]
            x, tw, wg, wu, wd = leaves
            ye = moe_ffn_ref(x, top_idx, valid, tw, wg, wu, wd)
            grads = torch.autograd.grad(
                ye, [a for a, w in zip(leaves, want) if w], grad_ye)
        it = iter(grads)
        gx, gtw, gwg, gwu, gwd = (next(it) if w else None for w in want)
        return gx, None, None, gtw, gwg, gwu, gwd


def moe_ffn_fn(xg: torch.Tensor, top_idx: torch.Tensor, valid: torch.Tensor,
               top_w: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """``moe_ffn`` with gradients (see ``MoEFFN``).  On the CPU, where the
    forward is the plain version itself, autograd runs through it and no
    forward is recomputed."""
    if xg.device.type == "cpu":
        return moe_ffn_ref(xg, top_idx, valid, top_w, w_gate, w_up, w_down)
    return MoEFFN.apply(xg, top_idx, valid, top_w, w_gate, w_up, w_down)
