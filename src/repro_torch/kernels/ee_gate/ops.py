"""Wrapper of the exit-gate kernel B6.

For a CUDA tensor ``ee_gate`` launches the hand-written kernel
(``csrc/ee_gate.cu``) or raises; for a CPU tensor it runs the plain
PyTorch version in ``ref.py``.  It counts its kernel launches in a plain
integer attribute, ``launches``, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .._build import launch, sm_count
from .ref import ee_gate_ref

_ENTRY = {torch.float32: "ee_gate_f32", torch.bfloat16: "ee_gate_bf16"}
#: elements a block takes at least, blocks a row at most, and the rows and
#: partials the kernel's merge scratch holds when a row is split
GATE_MIN_SLICE = 2048
GATE_MAX_SPLIT = 256
GATE_MAX_SPLIT_ROWS = 1024
GATE_MAX_SLOTS = 8192


def gate_plan(B: int, V: int, n_sm: int = 132) -> int:
    """Blocks ``P`` a row of the exit-gate kernel: enough that B * P is
    about one block an SM, each taking at least ``GATE_MIN_SLICE``
    elements; 1 once B fills the SMs (33 at the serving [4, 153,600])."""
    if B >= n_sm or B > GATE_MAX_SPLIT_ROWS:
        return 1
    return max(1, min(-(-n_sm // B), -(-V // GATE_MIN_SLICE), GATE_MAX_SPLIT,
                      GATE_MAX_SLOTS // B))


def gate_slices(V: int, P: int) -> List[Tuple[int, int]]:
    """The element range ``[lo, hi)`` of each of a row's P blocks, as the
    kernel cuts it: ``per = ceil(V / P)`` rounded up to a multiple of 8 (a
    16-byte vector in float32 and bf16), so trailing blocks may be empty."""
    per = (-(-V // P) + 7) // 8 * 8
    return [(min(V, p * per), min(V, (p + 1) * per)) for p in range(P)]


def ee_gate(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: [B, V] float32 or bfloat16 (-inf padding ok) -> (confidence
    [B] float32, greedy token [B] int32): the max softmax probability and
    the first-occurrence argmax of each row.  On CUDA a row is split over
    ``gate_plan(B, V)`` blocks whose partials merge through one scratch
    per device, so calls on one device run in stream order."""
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
           conf.data_ptr(), arg.data_ptr(), B, V,
           gate_plan(B, V, sm_count(logits.device)))
    ee_gate.launches += 1
    return conf, arg


ee_gate.launches = 0
