"""Wrapper of the exit-gate kernel B6.

For a CUDA tensor ``ee_gate`` launches the hand-written kernel
(``csrc/ee_gate.cu``) or raises; for a CPU tensor it runs the plain
PyTorch version in ``ref.py``.  It counts its kernel launches in a plain
integer attribute, ``launches``, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .._build import launch
from .ref import ee_gate_ref

_ENTRY = {torch.float32: "ee_gate_f32", torch.bfloat16: "ee_gate_bf16"}


def ee_gate(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: [B, V] float32 or bfloat16 (-inf padding ok) -> (confidence
    [B] float32, greedy token [B] int32): the max softmax probability and
    the first-occurrence argmax of each row."""
    if logits.device.type == "cpu":
        return ee_gate_ref(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"no exit-gate kernel for device {logits.device}")
    if logits.dim() != 2:
        raise ValueError(f"expected logits [B, V], got {tuple(logits.shape)}")
    if logits.dtype not in _ENTRY:
        raise ValueError(f"the exit-gate kernel takes float32 or bfloat16, "
                         f"got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    B, V = logits.shape
    if B == 0 or V == 0 or B >= 2 ** 31 or V >= 2 ** 31:
        raise ValueError(f"the exit-gate kernel takes 0 < B, V < 2^31, got "
                         f"{(B, V)}")
    conf = torch.empty(B, dtype=torch.float32, device=logits.device)
    arg = torch.empty(B, dtype=torch.int32, device=logits.device)
    launch(_ENTRY[logits.dtype], logits.device, logits.data_ptr(),
           conf.data_ptr(), arg.data_ptr(), B, V)
    ee_gate.launches += 1
    return conf, arg


ee_gate.launches = 0
