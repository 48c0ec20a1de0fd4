"""Plain PyTorch versions of the exit gate (B6) and the fused ingest (B2).

Port of the reference's oracle ``ee_gate_ref``
(``repro/kernels/ee_gate/ref.py``): clamp to NEG so a -inf padded tail adds
nothing, then the max softmax probability and the first-occurrence argmax
of every row.  ``exp(m - logsumexp(x))`` is written as its equal
``1 / sum(exp(x - m))``, the form the TPU kernel and the CUDA kernel
compute, which avoids rounding ``m + log(sum)`` at large logits.  The CPU
path of the port runs on it, and the CUDA kernel is held to it on the card
(conf to a relative 1e-5, the argmax exactly).

``quant_signature_rows_ref`` is the population tick's fused ingest: the
packed uplink requantizer of ``core/plan.py`` over a batch of bandwidth
rows, encoded as the int16 signature rows the cohort-state table keys on.
The CPU path runs on it, and the CUDA kernel is held to it byte for byte.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

NEG = -3.0e38


def ee_gate_ref(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: [B, V] (any float; -inf padding ok) -> (conf [B] float32,
    argmax [B] int32)."""
    x = logits.to(torch.float32).clamp_min(NEG)
    m, arg = x.max(dim=-1)
    conf = 1.0 / torch.exp(x - m[:, None]).sum(dim=-1)
    return conf, arg.to(torch.int32)


def ee_gate_split_ref(logits: torch.Tensor, P: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exit gate in the CUDA kernel's split-and-merge order, for the
    tests: each row cut into P slices as ``ops.gate_slices`` cuts it, each
    slice reduced to a partial (max m_p, sum s_p of exp(x - m_p), first
    argmax a_p; an empty slice is (NEG, 0, INT32_MAX)), then merged by
    index: M = max m_p, arg = the lowest a_p with m_p == M, and
    s = sum_p s_p * exp(m_p - M) added in ascending slice order.  Returns
    (conf [B] float32, argmax [B] int32), equal to :func:`ee_gate_ref` in
    the argmax and within a relative 1e-5 in conf."""
    from .ops import gate_slices
    x = logits.to(torch.float32).clamp_min(NEG)
    B, V = x.shape
    parts = []
    for lo, hi in gate_slices(V, P):
        if lo == hi:
            parts.append((torch.full((B,), NEG, device=x.device),
                          torch.zeros(B, device=x.device),
                          torch.full((B,), 2 ** 31 - 1, device=x.device)))
            continue
        m, a = x[:, lo:hi].max(dim=-1)
        s = torch.exp(x[:, lo:hi] - m[:, None]).sum(dim=-1)
        parts.append((m, s, a + lo))
    m = torch.stack([p[0] for p in parts], 1).to(torch.float32)
    s = torch.stack([p[1] for p in parts], 1).to(torch.float32)
    a = torch.stack([p[2] for p in parts], 1).to(torch.int64)
    M = m.max(dim=1).values
    arg = torch.where(m == M[:, None], a, 2 ** 31 - 1).min(dim=1).values
    term = s * torch.exp(m - M[:, None])
    total = torch.zeros(B, dtype=torch.float32, device=x.device)
    for p in range(P):                        # ascending slice order
        total = total + term[:, p]
    return 1.0 / total, arg.to(torch.int32)


def _quant_raw(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Eq. (4) quantizer without the non-finite guard (``round`` is half to
    even, like ``np.round``)."""
    if mode == "floor":
        return torch.floor(x + 1e-12)
    if mode == "ceil":
        return torch.ceil(x - 1e-12)
    if mode == "round":
        return torch.round(x)
    raise ValueError(f"unknown quantize mode {mode!r}")


def quant_signature_rows_ref(vec: torch.Tensor, bits: torch.Tensor,
                             C: torch.Tensor, mask: torch.Tensor,
                             load: torch.Tensor, modes: Sequence[str],
                             gamma: int, delta: float) -> torch.Tensor:
    """(Us, N) float64 bandwidth rows -> (Us, M*K2*N) int16 signature rows.

    ``bits`` / ``load`` are (K2, 1) columns and ``C`` / ``mask`` (K2, N)
    packs, on ``vec``'s device.  The operations and their order are
    ``plan.update_uplinks``'s: ``where(vec > 0, vec, nan)``, ``bits /
    bwm``, ``+ C``, ``* gamma``, ``/ delta``, the validity mask, then each
    mode's quantizer, with -1 wherever a value is invalid or above gamma.
    ``delta`` divides as a tensor on the same device: PyTorch divides a
    CUDA tensor by a Python scalar as a multiply by its rounded reciprocal.
    """
    Us, N = vec.shape
    K2 = C.shape[0]
    d = torch.full((1, 1, 1), float(delta), dtype=torch.float64,
                   device=vec.device)
    bwm = torch.where(vec > 0, vec, float("nan"))
    sc = bits.reshape(1, K2, 1) / bwm[:, None, :]
    sc = sc + C[None]
    sc = sc * gamma
    sc = sc / d
    valid = (torch.isfinite(sc) & mask[None]
             & (load.reshape(1, K2, 1) <= vec[:, None, :]))
    outs = []
    for mode in modes:
        q = _quant_raw(sc, mode)
        outs.append(torch.where(valid & (q <= gamma), q, -1.0)
                    .to(torch.int16))
    return torch.stack(outs, dim=1).reshape(Us, len(modes) * K2 * N)
