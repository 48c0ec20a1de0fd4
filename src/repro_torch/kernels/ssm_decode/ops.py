"""Wrapper of the Mamba-2 decode-core kernel B14.

For CUDA tensors ``ssm_decode`` launches the hand-written kernels
(``csrc/ssm_decode.cu``) or raises; for CPU tensors it runs the plain
PyTorch version in ``ref.py``.  It counts its calls that launch the
kernels in a plain integer attribute, ``launches``, so a run can show that
its main path went through them.  A call is two launches: the conv step
of every channel (and the conv cache's shift) into a scratch row, then
the state update with y and its gate, a block for each (row, head).

H, P and N come from the state's shape and the conv width from conv_w's;
the kernel takes N in ``STATES`` (a state row of N floats spans at most a
warp's 32 lanes of 4 floats, twice at N = 256).
"""
from __future__ import annotations

import torch

from ...sharding.dtensor import is_dtensor
from .._build import launch
from .ref import ssm_decode_ref

F32 = torch.float32
_ENTRY = {torch.float32: "ssm_decode_f32", torch.bfloat16: "ssm_decode_bf16"}
#: the state sizes the kernel is instantiated for
STATES = (16, 32, 64, 128, 256)
#: the widest conv the kernel takes (its taps live in registers)
MAX_CONV = 8


def ssm_decode(zxbcdt: torch.Tensor, conv: torch.Tensor,
               state: torch.Tensor, conv_w: torch.Tensor,
               conv_b: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
               dt_bias: torch.Tensor) -> torch.Tensor:
    """One decode step of one SSM layer (see ``ref.ssm_decode_ref``):
    zxbcdt [B, 1, 2 di + 2N + H], the conv cache [B, w-1, di + 2N], conv_w
    [w, di + 2N] and conv_b in one activation dtype (float32 or bfloat16);
    the state [B, H, P, N] and A_log, D, dt_bias [H] float32.  Returns
    ``y * silu(z)`` [B, 1, di]; the conv cache and the state are updated
    in place."""
    if zxbcdt.device.type == "cpu":
        return ssm_decode_ref(zxbcdt, conv, state, conv_w, conv_b, A_log, D,
                              dt_bias)
    if zxbcdt.device.type != "cuda":
        raise ValueError(f"no SSM decode kernel for device {zxbcdt.device}")
    return ssm_decode_kernel(zxbcdt, conv, state, conv_w, conv_b, A_log, D,
                             dt_bias)


def ssm_decode_kernel(zxbcdt, conv, state, conv_w, conv_b, A_log, D,
                      dt_bias) -> torch.Tensor:
    """``ssm_decode``'s launch: ``check_args``, the output and the scratch
    row, one call of the C entry point, ``launches`` counted."""
    B, H, P, N, w = check_args(zxbcdt, conv, state, conv_w, conv_b, A_log, D,
                               dt_bias)
    dtype = zxbcdt.dtype
    out = torch.empty((B, 1, H * P), dtype=dtype, device=zxbcdt.device)
    if B == 0 or H == 0:
        return out
    u = torch.empty((B, H * P + 2 * N), dtype=dtype, device=zxbcdt.device)
    launch(_ENTRY[dtype], zxbcdt.device, zxbcdt.data_ptr(), conv.data_ptr(),
           state.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
           A_log.data_ptr(), D.data_ptr(), dt_bias.data_ptr(), u.data_ptr(),
           out.data_ptr(), B, H, P, N, w)
    ssm_decode.launches += 1
    return out


ssm_decode.launches = 0


def check_args(zxbcdt, conv, state, conv_w, conv_b, A_log, D, dt_bias):
    """Raise ValueError on what the kernel does not take; else (B, H, P,
    N, w)."""
    args = (zxbcdt, conv, state, conv_w, conv_b, A_log, D, dt_bias)
    if any(is_dtensor(t) for t in args):
        raise ValueError("the SSM decode kernel takes plain tensors, not "
                         "DTensors (no sharded run decodes an SSM layer)")
    if state.dim() != 4 or conv_w.dim() != 2:
        raise ValueError(f"expected the state [B, H, P, N] and conv_w [w, C], "
                         f"got {tuple(state.shape)} / {tuple(conv_w.shape)}")
    B, H, P, N = state.shape
    w = conv_w.shape[0]
    di = H * P
    C = di + 2 * N
    want = ((B, 1, 2 * di + 2 * N + H), (B, w - 1, C), (B, H, P, N), (w, C),
            (C,), (H,), (H,), (H,))
    got = tuple(tuple(t.shape) for t in args)
    if got != want:
        raise ValueError(f"zxbcdt, conv, state, conv_w, conv_b, A_log, D, "
                         f"dt_bias must be {want} for the state's (B, H, P, "
                         f"N) and the conv's width, got {got}")
    dtype = zxbcdt.dtype
    if dtype not in _ENTRY or conv.dtype != dtype or conv_w.dtype != dtype \
            or conv_b.dtype != dtype:
        raise ValueError(f"zxbcdt, conv, conv_w and conv_b must share float32 "
                         f"or bfloat16, got {dtype} / {conv.dtype} / "
                         f"{conv_w.dtype} / {conv_b.dtype}")
    if any(t.dtype != F32 for t in (state, A_log, D, dt_bias)):
        raise ValueError(f"state, A_log, D and dt_bias must be float32, got "
                         f"{state.dtype} / {A_log.dtype} / {D.dtype} / "
                         f"{dt_bias.dtype}")
    if any(t.device != zxbcdt.device for t in args):
        raise ValueError("the SSM decode tensors must lie on one device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("the SSM decode tensors must be contiguous")
    if N not in STATES or not 1 <= w <= MAX_CONV or P == 0:
        raise ValueError(f"the kernel takes N in {STATES}, a conv of 1.."
                         f"{MAX_CONV} taps and P > 0: got N = {N}, w = {w}, "
                         f"P = {P}")
    if state.data_ptr() % 16:
        raise ValueError("the state must be 16-byte aligned (it moves as "
                         "16-byte words)")
    if B >= 2 ** 16 or B * H >= 2 ** 31:
        raise ValueError(f"the kernels' grids take B < 2^16 and B H < 2^31: "
                         f"got B = {B}, H = {H}")
    return B, H, P, N, w
