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
