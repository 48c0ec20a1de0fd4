"""Early exits for LM backbones: the paper's technique at LM scale.

Port of ``repro/models/early_exit.py``.  An exit sits at a period
boundary: RMSNorm + LM head.  By default the head is tied to the final LM
head; ``tied=False`` gives the exit its own head.  ``confidence_ref`` is
the max softmax probability per position, the gating statistic that the
exit-gate kernel (``kernels/ee_gate``) computes fused on the serving path.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from .layers import F32, lm_head_apply, lm_head_init, rmsnorm, rmsnorm_init


def exit_head_init(gen: torch.Generator, cfg: ArchConfig, dtype, device, *,
                   tied: bool = True) -> dict:
    params = {"norm": rmsnorm_init(cfg.d_model, dtype, device)}
    if not tied:
        params["head"] = lm_head_init(gen, cfg.d_model, cfg.padded_vocab,
                                      dtype, device)
    return params


def exit_head_apply(params: dict, cfg: ArchConfig, h: torch.Tensor,
                    lm_head_params: dict) -> torch.Tensor:
    """h: [B, S, d] -> logits [B, S, V_pad] (float32, padded tail -inf)."""
    hn = rmsnorm(params["norm"], h, cfg.norm_eps)
    head = params.get("head", lm_head_params)
    return lm_head_apply(head, hn, cfg.vocab_size)


def confidence_ref(logits: torch.Tensor) -> torch.Tensor:
    """Max softmax probability per position (oracle of the exit gate)."""
    x = torch.where(torch.isfinite(logits), logits, -1e30).to(F32)
    m = x.amax(dim=-1)
    lse = m + torch.log(torch.exp(x - m[..., None]).sum(dim=-1))
    return torch.exp(x.amax(dim=-1) - lse)


def gate_decisions(logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """True where the sample may exit here (confidence >= threshold)."""
    return confidence_ref(logits) >= threshold


def exit_statistics(exit_logits: Dict[str, torch.Tensor],
                    thresholds: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Per-exit capture masks with first-exit-wins semantics.

    Returns {exit_name: bool [B, ...]}: which samples exit at each point, in
    the reference's (sorted-name) order.  The empirical capture fractions
    are the phi of the paper's Plane 2."""
    decided = None
    out = {}
    for name in sorted(exit_logits):
        can = gate_decisions(exit_logits[name], thresholds.get(name, 1.1))
        take = can if decided is None else (can & ~decided)
        out[name] = take
        decided = take if decided is None else (decided | take)
    return out


def measure_phi(exit_masks: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Empirical phi per exit (feeds ``core.DNNProfile`` for placement)."""
    phi = {name: float(exit_masks[name].to(F32).mean())
           for name in sorted(exit_masks)}
    phi["final"] = max(0.0, 1.0 - sum(phi.values()))
    return phi
