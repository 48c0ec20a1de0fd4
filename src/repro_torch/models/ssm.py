"""Mamba-2 (SSD, state-space duality) mixer block.

Port of ``repro/models/ssm.py``.  The chunked SSD (full sequence and
prefill) splits the sequence into chunks of length Q: within a chunk the
recurrence runs in its quadratic "dual" form, across chunks a float32
[B, H, P, N] state is carried (the reference's ``lax.scan``), with
n_groups = 1 and a scalar decay per head.  On CUDA it launches the
hand-written kernel B9 (``kernels/ssd_scan``), on the CPU it runs that
kernel's plain version, the reference's loop.  Decode runs the O(1)
recurrent step on a cached state, updated in place: on CUDA through the
hand-written kernel B14 (``kernels/ssm_decode``), on the CPU through its
plain version.

  h_t = a_t * h_{t-1} + dt_t * x_t (x) B_t        a_t = exp(-exp(A_log) dt_t)
  y_t = C_t . h_t + D * x_t

Precision follows the reference: every product the reference keeps in
float32 (``preferred_element_type``) runs on float32 operands here, and is
cast to the activation dtype where the reference casts.  The causal conv
of the full sequence accumulates its taps in the activation dtype in the
reference's order (i = 0 .. w-1); the decode conv is one float32
reduction rounded once, as the reference's activation-dtype einsum.
``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``.

``_head_constraint`` is the reference's sharding constraint on the head
axis, on ``xh`` / ``dt`` of the full-sequence mixer: over DTensors under
``activation_sharding(device_mesh)`` it redistributes them; on plain
tensors, or without a context, it does nothing.  The scan then runs on
each rank's heads, and its state comes out sharded on them, where the
reference constrains its initial state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ArchConfig
from ..kernels.ssd_scan.ops import ssd_scan_fn
from ..kernels.ssm_decode.ops import ssm_decode
from ..kernels.ssm_decode.ref import softplus
from ..sharding.context import current
from ..sharding.dtensor import constrain, is_dtensor, replicated
from .layers import F32, dense_init, linear, rmsnorm, rmsnorm_init


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim, state)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    if d_inner % P:
        raise ValueError(f"{cfg.name}: d_inner {d_inner} is not a multiple "
                         f"of ssm_head_dim {P}")
    return d_inner, d_inner // P, P, cfg.ssm_state


def _head_spec(cfg: ArchConfig, shape: Tuple[int, ...], head_axis: int):
    """The spec ``_head_constraint`` puts on a tensor of ``shape`` under
    the current context, or None (left as it is)."""
    if not cfg.ssm_head_shard:
        return None
    ctx = current()
    if ctx is None or not ctx.model_axis:
        return None
    if shape[head_axis] % ctx.model_size:
        return None
    spec = [None] * len(shape)
    spec[0] = ctx.dp_axes
    spec[head_axis] = ctx.model_axis
    return tuple(spec)


def _head_constraint(cfg: ArchConfig, x: torch.Tensor, head_axis: int
                     ) -> torch.Tensor:
    """Tensor parallelism for the SSD's inner dims: the head axis sharded
    on "model" (and the batch on the data axes) when
    ``cfg.ssm_head_shard``; else every rank would run the whole
    d_inner-wide scan.  A DTensor is redistributed onto the context's
    mesh; without a context, or on a plain tensor, ``x`` is returned."""
    spec = _head_spec(cfg, tuple(x.shape), head_axis)
    return x if spec is None else constrain(x, spec)


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

    Chunks of Q = min(ssm_chunk, S), the last one zero-padded in the
    plain version (``kernels/ssd_scan/ref.py``).  Kernel B9 on CUDA (which
    raises on a shape it does not take), its plain version on the CPU, the
    plain version's gradient; over DTensors on each rank's heads.
    Returns (y [B, S, H, P] in xh's dtype, the final float32 state
    [B, H, P, N])."""
    if is_dtensor(xh):
        return _ssd_scan_local(cfg, xh, Bm, Cm, dt, a_log)
    return ssd_scan_fn(*(t.contiguous() for t in (xh, Bm, Cm, dt, a_log)),
                       chunk=cfg.ssm_chunk)


def _ssd_scan_local(cfg: ArchConfig, xh, Bm, Cm, dt, a_log):
    """``_ssd_scan`` over DTensors, on each rank's shard through
    ``local_map``: batch shards stay local, head shards of xh, dt and
    a_log too (a head's scan reads only its own head, and B and C, which
    every head shares, are replicated there), and the sequence is
    gathered.  y keeps xh's shards; the state is sharded on its heads
    (dim 1) where xh is, as the reference constrains it."""
    from torch.distributed.tensor.experimental import local_map
    Bm, Cm, dt, a_log = (replicated(t, xh) for t in (Bm, Cm, dt, a_log))
    x_place, bc_place, s_place = [], [], []
    for p in xh.placements:
        if p.is_shard(0):
            x_place.append(Shard(0))
            bc_place.append(Shard(0))
            s_place.append(Shard(0))
        elif p.is_shard(2):
            x_place.append(Shard(2))
            bc_place.append(Replicate())
            s_place.append(Shard(1))
        else:
            x_place.append(Replicate())
            bc_place.append(Replicate())
            s_place.append(Replicate())
    x_place, bc_place, s_place = (tuple(x_place), tuple(bc_place),
                                  tuple(s_place))

    def local(xl, bl, cl, dl, al):
        return _ssd_scan(cfg, xl, bl, cl, dl, al)

    return local_map(local, out_placements=(x_place, s_place),
                     in_placements=(x_place, bc_place, bc_place, x_place,
                                    x_place),
                     device_mesh=xh.device_mesh,
                     redistribute_inputs=True)(xh, Bm, Cm, dt, a_log)


def ssm_apply_with_state(params, cfg: ArchConfig, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence SSD mixer; also returns the decode cache
    {"state": [B, H, P, N] float32, "conv": [B, w-1, C]} for prefill."""
    di, H, P, N = ssm_dims(cfg)
    w = cfg.ssm_conv_width
    B, S_in = x.shape[:2]
    zxbcdt = linear(x, params["in_proj"])
    z, conv_in, dt_raw = _split_proj(cfg, zxbcdt)
    conv_out = _causal_conv(params["conv_w"], params["conv_b"], conv_in)
    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    xh = _head_constraint(cfg, xs.reshape(B, S_in, H, P), 2)
    dt = _head_constraint(cfg, softplus(dt_raw.to(F32) + params["dt_bias"]),
                          2)
    a_log = -torch.exp(params["A_log"])[None, None, :] * dt    # log a_t
    y, final_state = _ssd_scan(cfg, xh, Bm, Cm, dt, a_log)
    y = y + xh * params["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S_in, di)
    y = rmsnorm(params["norm"], y * F.silu(z.to(F32)).to(x.dtype),
                cfg.norm_eps)
    out = linear(y, params["out_proj"])
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
    place.  Between in_proj and the rmsnorm (the conv step, the gates, the
    state update and y * silu(z)) it runs kernel B14 on CUDA (which raises
    on what it does not take), its plain version on the CPU."""
    zxbcdt = linear(x, params["in_proj"])
    y = ssm_decode(zxbcdt, cache["conv"], cache["state"], params["conv_w"],
                   params["conv_b"], params["A_log"], params["D"],
                   params["dt_bias"])
    out = linear(rmsnorm(params["norm"], y, cfg.norm_eps),
                 params["out_proj"])
    return out, cache
