"""Wrappers of the exit-gate kernel B6 and the fused-ingest kernel B2.

For a CUDA tensor ``ee_gate`` / ``quant_signature_rows`` launch the
hand-written kernel (``csrc/ee_gate.cu``, ``csrc/quant_signature.cu``) or
raise; for a CPU tensor they run the plain PyTorch version in ``ref.py``.
Each counts its kernel launches in a plain integer attribute,
``launches``, so a run can show that its main path went through the
kernel.  ``quant_signature_divide`` runs B2's fast-path divide alone, so
the card tests can hold it to IEEE division bit for bit.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .._build import launch, sm_count
from .ref import ee_gate_ref, quant_signature_rows_ref

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


#: quantizer mode -> the fused-ingest kernel's mode code
QUANT_MODES = {"floor": 0, "ceil": 1, "round": 2}


def quant_signature_rows(vec: torch.Tensor, bits: torch.Tensor,
                         C: torch.Tensor, mask: torch.Tensor,
                         load: torch.Tensor, modes: Sequence[str],
                         gamma: int, delta: float) -> torch.Tensor:
    """The population tick's fused ingest (B2): (Us, N) float64 bandwidth
    rows -> (Us, M*K2*N) int16 signature rows (see ``ref.py``), byte-equal
    to the plain version.  ``bits`` / ``load``: (K2, 1) float64; ``C``:
    (K2, N) float64; ``mask``: (K2, N) bool; one or two ``modes``; ``delta``
    reaches the kernel as a double, unrounded."""
    if vec.device.type == "cpu":
        return quant_signature_rows_ref(vec, bits, C, mask, load, modes,
                                        gamma, delta)
    if vec.device.type != "cuda":
        raise ValueError(f"no fused-ingest kernel for device {vec.device}")
    if vec.dim() != 2 or C.dim() != 2 or vec.shape[1] != C.shape[1]:
        raise ValueError(f"expected vec (Us, N) and C (K2, N), got "
                         f"{tuple(vec.shape)} and {tuple(C.shape)}")
    Us, N = vec.shape
    K2 = C.shape[0]
    for name, t, shape, dtype in (("vec", vec, (Us, N), torch.float64),
                                  ("bits", bits, (K2, 1), torch.float64),
                                  ("C", C, (K2, N), torch.float64),
                                  ("mask", mask, (K2, N), torch.bool),
                                  ("load", load, (K2, 1), torch.float64)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != vec.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {vec.device}")
    if not 1 <= len(modes) <= 2 or any(m not in QUANT_MODES for m in modes):
        raise ValueError(f"the fused-ingest kernel takes one or two of "
                         f"{sorted(QUANT_MODES)}, got {tuple(modes)}")
    if not 0 <= gamma < 32767 or Us >= 2 ** 31:
        raise ValueError(f"the fused-ingest kernel takes 0 <= gamma < 32767 "
                         f"and Us < 2^31, got gamma={gamma}, Us={Us}")
    M = len(modes)
    out = torch.empty((Us, M * K2 * N), dtype=torch.int16, device=vec.device)
    if Us == 0:
        return out
    codes = [QUANT_MODES[m] for m in modes]
    launch("quant_signature", vec.device, vec.data_ptr(), bits.data_ptr(),
           C.data_ptr(), mask.data_ptr(), load.data_ptr(), out.data_ptr(),
           Us, K2, N, M, codes[0], codes[-1], int(gamma), float(delta))
    quant_signature_rows.launches += 1
    return out


quant_signature_rows.launches = 0


def quant_signature_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` elementwise for float64 tensors, through the fused-ingest
    kernel's fast-path divide on CUDA (one correctly rounded reciprocal of
    ``b`` and a Markstein correction; both operands +0 or in [2^-200,
    2^200]), so the card tests can hold it to IEEE division bit for bit;
    plain division on the CPU."""
    if a.device.type == "cpu":
        return a / b
    if a.device.type != "cuda":
        raise ValueError(f"no fused-ingest kernel for device {a.device}")
    if (a.dtype != torch.float64 or b.dtype != torch.float64
            or a.shape != b.shape or a.dim() != 1 or b.device != a.device
            or not (a.is_contiguous() and b.is_contiguous())
            or a.numel() >= 2 ** 31):
        raise ValueError("expected two contiguous 1-D float64 tensors of one "
                         "shape on one device")
    q = torch.empty_like(a)
    launch("quant_signature_divide", a.device, a.data_ptr(), b.data_ptr(),
           q.data_ptr(), a.numel())
    quant_signature_divide.launches += 1
    return q


quant_signature_divide.launches = 0
