"""Mamba-2 (SSD, state-space duality) mixer block.

Port of ``repro/models/ssm.py``.  The chunked SSD (full sequence and
prefill) splits the sequence into chunks of length Q: within a chunk the
recurrence runs in its quadratic "dual" form, across chunks a float32
[B, H, P, N] state is carried by a Python loop (the reference's
``lax.scan``), with n_groups = 1 and a scalar decay per head.  Decode runs
the O(1) recurrent step on a cached state, updated in place.

  h_t = a_t * h_{t-1} + dt_t * x_t (x) B_t        a_t = exp(-exp(A_log) dt_t)
  y_t = C_t . h_t + D * x_t

Precision follows the reference: every product the reference keeps in
float32 (``preferred_element_type``) runs on float32 operands here, and is
cast to the activation dtype where the reference casts.  The causal conv
of the full sequence accumulates its taps in the activation dtype in the
reference's order (i = 0 .. w-1); the decode conv is one float32
reduction rounded once, as the reference's activation-dtype einsum.
``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``.

The reference's ``_head_constraint`` (a sharding constraint on the head
axis) is a no-op without a sharding context and is left out; it returns
with the sharding context (ROADMAP A.6).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import F32, dense_init, rmsnorm, rmsnorm_init


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim, state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    if d_inner % P:
        raise ValueError(f"{cfg.name}: d_inner {d_inner} is not a multiple "
                         f"of ssm_head_dim {P}")
    return d_inner, d_inner // P, P, cfg.ssm_state


def ssm_init(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> dict:
    d = cfg.d_model
    di, H, P, N = ssm_dims(cfg)
    w = cfg.ssm_conv_width
    conv_ch = di + 2 * N
    return {
        # order: [z (di), conv channels (di + 2N), dt (H)]
        "in_proj": dense_init(gen, (d, 2 * di + 2 * N + H), d, dtype, device),
        "conv_w": dense_init(gen, (w, conv_ch), w, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), dtype=F32, device=device),
        "D": torch.ones((H,), dtype=F32, device=device),
        "dt_bias": torch.zeros((H,), dtype=F32, device=device),
        "norm": rmsnorm_init(di, dtype, device),
        "out_proj": dense_init(gen, (di, d), di, dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` turns
    linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, H, P, N = ssm_dims(cfg)
    z, conv_in, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    return z, conv_in, dt


def _causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. x: [B, S, C]; conv_w: [w, C].
    The taps are summed in x's dtype in order i = 0 .. w-1, as the
    reference's Python ``sum`` (``F.conv1d`` would sum in float32)."""
    w = conv_w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, w - 1, 0))
    out = sum(xp[:, i:i + S, :] * conv_w[i] for i in range(w))
    return F.silu((out + conv_b).to(F32)).to(x.dtype)


def _ssd_scan(cfg: ArchConfig, xh: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xh: [B, S, H, P]; Bm / Cm: [B, S, N]; dt: [B, S, H]
    (post-softplus, float32); a_log: [B, S, H] = log a_t (negative).

    S is zero-padded to a multiple of Q = min(ssm_chunk, S).  Returns
    (y [B, S, H, P] in xh's dtype, the final float32 state [B, H, P, N])."""
    Bsz, S, H, P = xh.shape
    S_orig = S
    N = Bm.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
        dt, a_log = (F.pad(t, (0, 0, 0, pad)) for t in (dt, a_log))
        S += pad
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    zero = torch.zeros((), dtype=F32, device=xh.device)
    state = torch.zeros((Bsz, H, P, N), dtype=F32, device=xh.device)
    ys = []
    for c0 in range(0, S, Q):
        x = xh[:, c0:c0 + Q]
        b = Bm[:, c0:c0 + Q].to(F32)
        c = Cm[:, c0:c0 + Q].to(F32)
        la = torch.cumsum(a_log[:, c0:c0 + Q], dim=1)          # [B,Q,H]
        xdt = x * dt[:, c0:c0 + Q, :, None]                    # [B,Q,H,P] f32
        # intra-chunk (quadratic dual form)
        G = torch.bmm(c, b.transpose(1, 2))                    # [B,q,s]
        seg = torch.exp(la[:, :, None, :] - la[:, None, :, :])  # [B,q,s,H]
        seg = torch.where(causal[None, :, :, None], seg, zero)
        M = G[..., None] * seg                                 # [B,q,s,H]
        y_intra = torch.einsum("bqsh,bshp->bqhp", M, xdt)
        # inter-chunk via the carried state
        y_inter = torch.einsum("bqn,bhpn->bqhp", c, state) \
            * torch.exp(la)[..., None]
        # state update
        la_last = la[:, -1:, :]                                # [B,1,H]
        decay_rest = torch.exp(la_last - la)                   # [B,Q,H]
        chunk_state = torch.einsum("bqhp,bqn->bhpn",
                                   xdt * decay_rest[..., None], b)
        state = state * torch.exp(la_last)[:, 0, :, None, None] + chunk_state
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :S_orig], state


def ssm_apply_with_state(params, cfg: ArchConfig, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence SSD mixer; also returns the decode cache
    {"state": [B, H, P, N] float32, "conv": [B, w-1, C]} for prefill."""
    di, H, P, N = ssm_dims(cfg)
    w = cfg.ssm_conv_width
    B, S_in = x.shape[:2]
    zxbcdt = torch.matmul(x, params["in_proj"])
    z, conv_in, dt_raw = _split_proj(cfg, zxbcdt)
    conv_out = _causal_conv(params["conv_w"], params["conv_b"], conv_in)
    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    xh = xs.reshape(B, S_in, H, P)
    dt = softplus(dt_raw.to(F32) + params["dt_bias"])
    a_log = -torch.exp(params["A_log"])[None, None, :] * dt    # log a_t
    y, final_state = _ssd_scan(cfg, xh, Bm, Cm, dt, a_log)
    y = y + xh * params["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S_in, di)
    y = rmsnorm(params["norm"], y * F.silu(z.to(F32)).to(x.dtype),
                cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"])
    # conv cache: the last w-1 *pre-conv* channel inputs
    if S_in >= w - 1:
        tail = conv_in[:, S_in - (w - 1):, :]
    else:
        tail = F.pad(conv_in, (0, 0, (w - 1) - S_in, 0))
    return out, {"state": final_state, "conv": tail.contiguous()}


def ssm_apply(params, cfg: ArchConfig, x: torch.Tensor,
              positions=None) -> torch.Tensor:
    """Full-sequence SSD mixer. x: [B, S, d] -> [B, S, d]."""
    return ssm_apply_with_state(params, cfg, x)[0]


# ---------------------------------------------------------------------------
# Decode (recurrent step)
# ---------------------------------------------------------------------------

def ssm_cache_shape(cfg: ArchConfig, batch: int) -> Dict[str, tuple]:
    di, H, P, N = ssm_dims(cfg)
    w = cfg.ssm_conv_width
    return {"state": (batch, H, P, N), "conv": (batch, w - 1, di + 2 * N)}


def ssm_cache_init(cfg: ArchConfig, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    shapes = ssm_cache_shape(cfg, batch)
    return {"state": torch.zeros(shapes["state"], dtype=F32, device=device),
            "conv": torch.zeros(shapes["conv"], dtype=dtype, device=device)}


def ssm_decode_step(params, cfg: ArchConfig, x: torch.Tensor, cache: dict
                    ) -> Tuple[torch.Tensor, dict]:
    """x: [B, 1, d]; cache: {"state": [B, H, P, N] float32, "conv":
    [B, w-1, C]}.  Returns (out [B, 1, d], cache), the cache updated in
    place."""
    di, H, P, N = ssm_dims(cfg)
    B = x.shape[0]
    zxbcdt = torch.matmul(x, params["in_proj"])
    z, conv_in, dt_raw = _split_proj(cfg, zxbcdt)
    # causal conv over [cached w-1 inputs, current]
    hist = torch.cat([cache["conv"], conv_in], dim=1)          # [B,w,C]
    conv_out = ((hist.to(F32) * params["conv_w"].to(F32)).sum(dim=1)
                .to(x.dtype) + params["conv_b"])
    conv_out = F.silu(conv_out.to(F32)).to(x.dtype)
    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)     # [B, .]
    xh = xs.reshape(B, H, P)
    dt = softplus(dt_raw[:, 0].to(F32) + params["dt_bias"])    # [B,H]
    a = torch.exp(-torch.exp(params["A_log"])[None, :] * dt)   # [B,H]
    xdt = xh.to(F32) * dt[..., None]
    state = (cache["state"] * a[:, :, None, None]
             + xdt[..., None] * Bm.to(F32)[:, None, None, :])
    y = torch.bmm(state.reshape(B, H * P, N), Cm.to(F32)[:, :, None])
    y = y.reshape(B, H, P) + xh.to(F32) * params["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.to(F32)).to(x.dtype),
                cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"])
    cache["state"].copy_(state)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
