"""Mixture-of-Experts FFN: top-k routing with capacity, two dispatch impls.

Port of ``repro/models/moe.py``.

``gather`` (default): each token group's experts take their top-C tokens
by gate weight (capacity C = t*k*cf/E, rounded up to a multiple of 8, at
least 8), gather them into dense [G, E, C, d] blocks, run the experts'
SwiGLU products (one batched product an expert weight) and scatter-add
the weighted results back to the tokens.

``einsum``: the literal GShard dispatch (one-hot [t, E, C] products), kept
for small-scale fidelity checks.

Top-k gates are renormalized over the selected experts (Mixtral
convention).  ``moe_dense_residual`` adds a parallel dense SwiGLU branch
(Snowflake Arctic).

Both top-k selections (the experts of a token, the tokens of an expert)
decide which expert and which capacity slot a token gets, so they keep the
reference's tie order: ``jax.lax.top_k`` puts the lower index first among
equal values, and ``torch.topk`` promises no order.  ``_topk`` is a stable
descending sort and its head.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import F32, bmm_f32, dense_init, matmul_f32, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    params = {
        "router": dense_init(gen, (d, E), d, F32, device),
        "w_gate": dense_init(gen, (E, d, ff), d, dtype, device),
        "w_up": dense_init(gen, (E, d, ff), d, dtype, device),
        "w_down": dense_init(gen, (E, ff, d), ff, dtype, device),
    }
    if cfg.moe_dense_residual:
        dff = cfg.dense_residual_d_ff or 2 * d
        params["dense_residual"] = mlp_init(gen, d, dff, dtype, device)
    return params


def _capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor
            / max(1, cfg.n_experts))
    return max(8, ((c + 7) // 8) * 8)


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, lower index first among ties
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, cfg: ArchConfig, xg: torch.Tensor):
    """xg: [G, t, d] -> (probs [G, t, E] float32, top-k gates / ids
    [G, t, k])."""
    logits = matmul_f32(xg.to(F32), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _topk(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_ids


def _experts(params, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on xe [G, E, C, d] -> float32 [G, E, C, d]: one
    batched product a weight, float32 where the reference keeps it."""
    G, E, C, d = xe.shape
    x = xe.transpose(0, 1).reshape(E, G * C, d)
    h_g = bmm_f32(x, params["w_gate"])
    h_u = bmm_f32(x, params["w_up"])
    h = (F.silu(h_g) * h_u).to(xe.dtype)
    ye = bmm_f32(h, params["w_down"])                       # [E, G*C, d]
    return ye.reshape(E, G, C, d).transpose(0, 1)


def _moe_gather(params, cfg: ArchConfig, xg: torch.Tensor) -> torch.Tensor:
    """Gather-based dispatch. xg: [G, t, d] -> [G, t, d]."""
    G, t, d = xg.shape
    E = cfg.n_experts
    C = _capacity(t, cfg)
    probs, gate_vals, expert_ids = _route(params, cfg, xg)

    # per-(token, expert) renormalized gate, 0 where not selected: [G, t, E]
    gate_te = torch.zeros((G, t, E), dtype=F32, device=xg.device)
    gate_te.scatter_(-1, expert_ids, gate_vals)

    # each expert takes its top-C tokens by gate weight within the group
    top_w, top_idx = _topk(gate_te.transpose(1, 2), min(C, t))  # [G,E,C]
    valid = top_w > 0.0
    groups = torch.arange(G, device=xg.device)[:, None, None]
    xe = xg[groups, top_idx]                                    # [G,E,C,d]
    xe = xe * valid[..., None].to(xg.dtype)
    ye = _experts(params, xe) * (top_w * valid)[..., None]      # f32

    # scatter-add back to the tokens within each group.  On CUDA the adds
    # land in any order; the sum is still exact because a token gets at
    # most top_k = 2 nonzero contributions (one an expert that kept it; the
    # rest are exact zeros) and a + b == b + a.  With top_k > 2 the order
    # of the adds would change the float32 sum.
    y = torch.zeros((G, t, d), dtype=F32, device=xg.device)
    Ck = top_idx.shape[-1]
    y.scatter_add_(1, top_idx.reshape(G, E * Ck, 1).expand(G, E * Ck, d),
                   ye.reshape(G, E * Ck, d))
    return y.to(xg.dtype)


def _moe_einsum(params, cfg: ArchConfig, xg: torch.Tensor) -> torch.Tensor:
    """Literal GShard one-hot dispatch (small-scale fidelity reference)."""
    G, t, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(t, cfg)
    probs, gate_vals, expert_ids = _route(params, cfg, xg)
    sel = F.one_hot(expert_ids, E).to(F32)                      # [G,t,k,E]
    # position of each (token, choice) in its expert's buffer
    flat = sel.reshape(G, t * k, E)
    pos = (torch.cumsum(flat, dim=1) * flat - 1.0).reshape(G, t, k, E)
    keep = (pos >= 0) & (pos < C)
    slots = torch.arange(C, dtype=F32, device=xg.device)
    pos_oh = (pos[..., None] == slots).to(F32) * keep[..., None]
    dispatch = torch.einsum("gtke,gtkec->gtec", sel, pos_oh)    # [G,t,E,C]
    combine = torch.einsum("gtec,gtke->gtec", dispatch,
                           sel * gate_vals[..., None])
    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(xg.dtype).to(F32),
                      xg.to(F32)).to(xg.dtype)
    ye = _experts(params, xe)
    y = torch.einsum("gtec,gecd->gtd", combine, ye)
    return y.to(xg.dtype)


def moe_apply(params, cfg: ArchConfig, x: torch.Tensor, *,
              n_groups: int = 0) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  Groups default to the batch dim."""
    B, S, d = x.shape
    G = n_groups or B
    xg = x.reshape(G, (B * S) // G, d)
    fn = _moe_gather if cfg.moe_impl == "gather" else _moe_einsum
    y = fn(params, cfg, xg).reshape(B, S, d)
    if cfg.moe_dense_residual:
        y = y + mlp_apply(params["dense_residual"], x)
    return y


def moe_flops_per_token(cfg: ArchConfig) -> float:
    """Active-parameter FLOPs per token (router + top-k experts +
    residual)."""
    d, ff = cfg.d_model, cfg.d_ff
    f = 2 * d * cfg.n_experts                   # router
    f += cfg.top_k * 3 * 2 * d * ff             # expert SwiGLU
    if cfg.moe_dense_residual:
        f += 3 * 2 * d * (cfg.dense_residual_d_ff or 2 * d)
    return f
