"""Plain PyTorch version of the Mamba-2 decode core (B14).

Port of the recurrent step of the reference's ``models.ssm.ssm_decode_step``
(``repro/models/ssm.py:197-224``), plain ``jnp`` under XLA there: from the
in_proj output of one token a row to the gated ``y * silu(z)`` that the
mixer's rmsnorm takes, the conv cache and the float32 state updated in
place.  The CPU path of the port runs on it, and the CUDA kernel is held
to it on the card.

``ssm_decode_mirror`` repeats the kernel's order of operations on the
CPU for the tests: the same arithmetic, with the contraction of y over N
summed as the kernel's lanes sum it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` turns
    linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_decode_ref(zxbcdt: torch.Tensor, conv: torch.Tensor,
                   state: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor, A_log: torch.Tensor,
                   D: torch.Tensor, dt_bias: torch.Tensor) -> torch.Tensor:
    """One decode step of one SSM layer.  zxbcdt: [B, 1, 2 di + 2N + H]
    ([z | conv channels x, B, C | dt], the activation dtype); conv:
    [B, w-1, di + 2N] (the last w-1 pre-conv channel inputs); state:
    [B, H, P, N] float32; conv_w [w, di + 2N], conv_b [di + 2N]; A_log,
    D, dt_bias [H] float32.  Returns ``y * silu(z)`` [B, 1, di] in the
    activation dtype; ``conv`` and ``state`` are updated in place."""
    B, H, P, N = state.shape
    di = H * P
    z, conv_in, dt_raw = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    # causal conv over [cached w-1 inputs, current]
    hist = torch.cat([conv, conv_in], dim=1)                    # [B,w,C]
    conv_out = ((hist.to(F32) * conv_w.to(F32)).sum(dim=1)
                .to(zxbcdt.dtype) + conv_b)
    conv_out = F.silu(conv_out.to(F32)).to(zxbcdt.dtype)
    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)     # [B, .]
    xh = xs.reshape(B, H, P)
    dt = softplus(dt_raw[:, 0].to(F32) + dt_bias)              # [B,H]
    a = torch.exp(-torch.exp(A_log)[None, :] * dt)             # [B,H]
    xdt = xh.to(F32) * dt[..., None]
    new = (state * a[:, :, None, None]
           + xdt[..., None] * Bm.to(F32)[:, None, None, :])
    y = torch.bmm(new.reshape(B, H * P, N), Cm.to(F32)[:, :, None])
    y = y.reshape(B, H, P) + xh.to(F32) * D[None, :, None]
    y = y.reshape(B, 1, di).to(zxbcdt.dtype)
    state.copy_(new)
    conv.copy_(hist[:, 1:])
    return y * F.silu(z.to(F32)).to(zxbcdt.dtype)


def lanes(N: int):
    """How the kernel lays a state row of N floats on a warp: (lanes a
    row L, 4-float chunks a lane CH).  Lane l of a row holds the chunks
    l, l + L, ..., l + (CH - 1) L, i.e. n = 4 (c L + l) + j."""
    nv = N // 4
    L = min(32, nv)
    return L, nv // L


def ssm_decode_mirror(zxbcdt: torch.Tensor, conv: torch.Tensor,
                      state: torch.Tensor, conv_w: torch.Tensor,
                      conv_b: torch.Tensor, A_log: torch.Tensor,
                      D: torch.Tensor, dt_bias: torch.Tensor
                      ) -> torch.Tensor:
    """``ssm_decode_ref`` in the kernel's order of operations, for the
    tests: the conv taps summed from 0 in order i = 0 .. w-1, every product
    and sum rounded apart (no fused multiply-add), and y's contraction over
    N as the kernel's warps sum it: each lane its 4 CH products in order
    (chunk by chunk), then the row's L lanes pairwise, halving (lanes l
    and l + L/2 first, as the butterfly of ``__shfl_xor_sync`` does).
    silu, exp and softplus are PyTorch's on the tensors' device (the
    kernel computes the formulas PyTorch's CUDA kernels do).  Same
    arguments and result as :func:`ssm_decode_ref`."""
    B, H, P, N = state.shape
    di = H * P
    w = conv_w.shape[0]
    dtype = zxbcdt.dtype
    z, conv_in, dt_raw = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    hist = torch.cat([conv, conv_in], dim=1).to(F32)
    acc = torch.zeros_like(hist[:, 0])
    for i in range(w):
        acc = acc + hist[:, i] * conv_w[i].to(F32)
    u = (acc.to(dtype).to(F32) + conv_b.to(F32)).to(dtype).to(F32)
    u = F.silu(u).to(dtype).to(F32)
    x = u[:, :di].reshape(B, H, P)
    Bm, Cm = u[:, di:di + N], u[:, di + N:]
    dt = softplus(dt_raw[:, 0].to(F32) + dt_bias)
    a = torch.exp(-torch.exp(A_log)[None, :] * dt)
    xdt = x * dt[..., None]
    new = (state * a[:, :, None, None]
           + xdt[..., None] * Bm[:, None, None, :])
    L, CH = lanes(N)
    prod = (Cm[:, None, None, :] * new).reshape(B, H, P, CH, L, 4)
    part = torch.zeros((B, H, P, L), dtype=F32, device=state.device)
    for c in range(CH):
        for j in range(4):
            part = part + prod[..., c, :, j]
    while part.shape[-1] > 1:
        half = part.shape[-1] // 2
        part = part[..., :half] + part[..., half:]
    y = (part[..., 0] + x * D[None, :, None]).to(dtype).to(F32)
    gate = F.silu(z[:, 0].to(F32)).to(dtype).to(F32)
    state.copy_(new)
    conv.copy_(torch.cat([conv, conv_in], dim=1)[:, 1:])
    return (y.reshape(B, di) * gate).to(dtype).reshape(B, 1, di)
