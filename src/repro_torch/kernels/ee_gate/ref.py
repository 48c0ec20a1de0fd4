"""Plain PyTorch version of the exit gate (B6).

Port of the reference's oracle ``ee_gate_ref``
(``repro/kernels/ee_gate/ref.py``): clamp to NEG so a -inf padded tail adds
nothing, then the max softmax probability and the first-occurrence argmax
of every row.  ``exp(m - logsumexp(x))`` is written as its equal
``1 / sum(exp(x - m))``, the form the TPU kernel and the CUDA kernel
compute, which avoids rounding ``m + log(sum)`` at large logits.  The CPU
path of the port runs on it, and the CUDA kernel is held to it on the card
(conf to a relative 1e-5, the argmax exactly).
"""
from __future__ import annotations

from typing import Tuple

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
