"""Shared transformer layers: norms, RoPE, SwiGLU MLP, embeddings.

Port of ``repro/models/layers.py``.  Parameters are plain dictionaries of
tensors in the reference's layouts (a weight is ``[in, out]``), so a
reference parameter tree converts leaf by leaf (``convert.py``).  Every
``init`` draws from an explicit ``torch.Generator`` on an explicit device.

Precision follows the reference: it accumulates every product in float32
(``preferred_element_type``) and casts to the activation dtype where the
reference does.  A bf16 ``torch.matmul`` accumulates in float32 and rounds
its output once to bf16, which is the reference's ``einsum(...).astype``;
where the reference keeps the float32 result (the SwiGLU gate and up
products, the LM heads' logits) the port asks for a float32 output
(``matmul_f32``).  ``rmsnorm`` and ``apply_rope`` run in float32 and cast
back.  ``cross_entropy`` and ``chunked_cross_entropy`` are the training
losses; the second never holds the full sequence's logits.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import Replicate

from ..sharding.dtensor import (is_dtensor, local_offsets, product_local,
                                replicated, settle, shard_local,
                                sharded_only_on)

F32 = torch.float32

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

#: does this torch offer ``mm(a, b, out_dtype=float32)`` (and ``bmm``) for
#: half-precision inputs (float32 accumulation without rounding the
#: output)?  Read once from the operators' overloads; where it is missing,
#: ``matmul_f32`` / ``bmm_f32`` upcast the operands instead.
_MM_OUT_DTYPE = "dtype" in torch.ops.aten.mm.overloads()
_BMM_OUT_DTYPE = "dtype" in torch.ops.aten.bmm.overloads()


@contextlib.contextmanager
def no_tf32():
    """Float32 convolutions and matmuls in full float32 inside the block;
    the caller's TF32 settings come back after it."""
    cudnn = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = mm


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype,
               device) -> torch.Tensor:
    """Normal / sqrt(fan_in), drawn in float32 and cast (the reference's
    ``dense_init``; the numbers differ, the distribution does not)."""
    x = torch.randn(shape, generator=gen, dtype=F32, device=device)
    return x.div_(math.sqrt(fan_in)).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` (w [K, N]) in x's dtype; on
    DTensors the product of the local shards (``product_local``), so no
    placement of x's leading axes has to survive a flatten."""
    if is_dtensor(x) or is_dtensor(w):
        return product_local(torch.matmul, x, w)
    return torch.matmul(x, w)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` with a float32 result: the
    reference's ``einsum(..., preferred_element_type=float32)``.  A
    half-precision CUDA product asks cuBLAS for a float32 output where this
    torch offers it, else both operands are upcast (the same numbers: a
    bf16 value is exact in float32).  On DTensors the same product runs on
    the local shards (``sharding.dtensor.product_local``): DTensor has no
    rule for the ``out_dtype`` overload."""
    if is_dtensor(x) or is_dtensor(w):
        return product_local(_matmul_f32, x, w)
    return _matmul_f32(x, w)


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype == F32 and w.dtype == F32:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    out = _mm_f32(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``matmul_f32`` of a [M, K] and b [K, N] plain tensors."""
    if a.dtype == F32 and b.dtype == F32:
        return torch.mm(a, b)
    if a.is_cuda and _MM_OUT_DTYPE and a.dtype == b.dtype:
        if _needs_grad(a, b):
            return _MatmulF32.apply(a, b, False)
        return torch.mm(a, b, out_dtype=F32)
    return torch.mm(a.to(F32), b.to(F32))


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` with a float32 result, as ``matmul_f32``: a [E, M, K],
    b [E, K, N] -> [E, M, N] float32."""
    if is_dtensor(a) or is_dtensor(b):
        return product_local(_bmm_f32, a, b, batched=True)
    return _bmm_f32(a, b)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == F32 and b.dtype == F32:
        return torch.bmm(a, b)
    if a.is_cuda and _BMM_OUT_DTYPE and a.dtype == b.dtype:
        if _needs_grad(a, b):
            return _MatmulF32.apply(a, b, True)
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.to(F32), b.to(F32))


def _needs_grad(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)


class _MatmulF32(torch.autograd.Function):
    """``mm`` / ``bmm`` of two half-precision CUDA operands with a float32
    output, differentiable (PyTorch defines no derivative for the
    ``out_dtype`` overloads).  The backward rounds the float32 cotangent to
    the operands' dtype and runs its two products in that dtype with
    float32 accumulation, as mixed-precision training does; the reference
    multiplies the float32 cotangent in float32.  Float32 models never
    come here."""

    @staticmethod
    def forward(ctx, a, b, batched: bool):
        ctx.save_for_backward(a, b)
        ctx.batched = batched
        if batched:
            return torch.bmm(a, b, out_dtype=F32)
        return torch.mm(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        mm = torch.bmm if ctx.batched else torch.mm
        ga = mm(g, b.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        gb = mm(a.transpose(-1, -2), g) if ctx.needs_input_grad[1] else None
        return ga, gb, None


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def scalar(value: float, device) -> torch.Tensor:
    """A float32 0-dim tensor on ``device``, filled there: ``torch.tensor``
    would copy it from the host, and a host-to-device copy of pageable
    memory makes the host wait for the device."""
    return torch.full((), value, dtype=F32, device=device)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # tensor / tensor: a CUDA tensor divided by a Python scalar is a multiply
    # by the rounded reciprocal, one ulp off the reference's division
    exps = (torch.arange(0, head_dim, 2, dtype=F32, device=device)
            / scalar(head_dim, device))
    return scalar(1.0, device) / torch.pow(scalar(theta, device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] integer."""
    d = x.shape[-1]
    freqs = replicated(rope_freqs(d, theta, x.device), positions)  # [D/2]
    angles = positions[..., None].to(F32) * freqs             # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                     # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> Dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), d_model, dtype, device),
        "w_up": dense_init(gen, (d_model, d_ff), d_model, dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), d_ff, dtype, device),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = matmul_f32(x, params["w_gate"])
    u = matmul_f32(x, params["w_up"])
    h = (F.silu(g) * u).to(x.dtype)
    return linear(h, params["w_down"])


def mlp_flops(d_model: int, d_ff: int) -> float:
    return 3 * 2 * d_model * d_ff  # per token


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab_padded: int, d_model: int, dtype,
               device) -> Dict[str, torch.Tensor]:
    return {"table": dense_init(gen, (vocab_padded, d_model), d_model, dtype,
                                device)}


def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # ``F.embedding``, not ``table[tokens]``: the same rows, and its backward
    # sums each row's gradient in a fixed order, where an indexing's
    # backward (index_put with accumulate) adds with atomics on the CPU
    if not is_dtensor(tokens):
        return F.embedding(tokens, params["table"])
    # on DTensors: every rank looks up all the tokens in its rows of a
    # vocab-parallel table, the shares are summed, and the rows are cut to
    # the tokens' batch shard again (DTensor's own rule fails on a
    # batch-sharded index into a vocab-sharded table)
    placements = tokens.placements
    whole = tokens.redistribute(tokens.device_mesh,
                                [Replicate()] * len(placements))
    h = settle(F.embedding(whole, params["table"]))
    return h.redistribute(h.device_mesh, [
        p if p.is_shard(0) else q for p, q in zip(placements, h.placements)])


def lm_head_init(gen: torch.Generator, d_model: int, vocab_padded: int,
                 dtype, device) -> Dict[str, torch.Tensor]:
    return {"w": dense_init(gen, (d_model, vocab_padded), d_model, dtype,
                            device)}


def lm_head_apply(params: dict, x: torch.Tensor, vocab_size: int
                  ) -> torch.Tensor:
    """Float32 logits with the padded-vocab tail set to -inf."""
    logits = matmul_f32(x, params["w"])
    V = logits.shape[-1]
    if V != vocab_size and is_dtensor(logits):
        # a vocab-parallel head: every rank masks its own columns
        pad = torch.arange(V, device=logits.device) >= vocab_size
        return logits.masked_fill(replicated(pad, logits), -math.inf)
    if V != vocab_size:
        logits[..., vocab_size:] = -math.inf
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over all positions; logits float32 [..., V], labels int
    [...]."""
    lse = torch.logsumexp(
        torch.where(torch.isfinite(logits), logits, -1e30), dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (lse - gold).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss


def _ce_chunk(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
              vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of CE over the chunk's labelled positions, their count)."""
    logits = matmul_f32(h, head_w)
    V = logits.shape[-1]
    if V != vocab_size:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(replicated(pad, logits), -1e30)
    with torch.no_grad():                       # the reference's stop_gradient
        m = logits.max(dim=-1).values
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    gold = _gold(logits, labels.clamp_min(0))
    valid = (labels >= 0).to(F32)
    return ((lse - gold) * valid).sum(), valid.sum()


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``.  On DTensors each rank gathers from its
    own vocabulary columns (a label outside them gives 0) and the shares
    are summed (as are a partial sum's)."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    last = logits.dim() - 1
    lo = local_offsets(logits)[last]
    split = [p.is_shard(last) or p.is_partial() for p in logits.placements]
    out = tuple(Partial() if s else p
                for s, p in zip(split, logits.placements))
    lab = tuple(Replicate() if s else p
                for s, p in zip(split, logits.placements))

    def local(lg, lb):
        mine = (lb >= lo) & (lb < lo + lg.shape[-1])
        idx = torch.where(mine, lb - lo, torch.zeros_like(lb))
        g = torch.gather(lg, -1, idx[..., None])[..., 0]
        return torch.where(mine, g, torch.zeros_like(g))

    return settle(local_map(local, out_placements=(out,),
                            in_placements=(logits.placements, lab),
                            in_grad_placements=(logits.placements, lab),
                            device_mesh=logits.device_mesh,
                            redistribute_inputs=True)(logits, labels))


def chunked_cross_entropy(h: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, vocab_size: int,
                          *, chunk: int = 256) -> torch.Tensor:
    """Mean CE without materializing full-sequence logits.

    ``h``: pre-head hidden states [B, S, d]; ``head_w``: [d, V_pad];
    labels [B, S] (-1: no label).  The sequence is cut into chunks (h
    padded with zeros and the labels with -1 to a multiple of ``chunk``);
    each chunk's float32 logits [B, chunk, V_pad] live only inside its
    body, which runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` over a scan) and is recomputed in the backward.
    The gold logit is gathered, which selects the same float as the
    reference's one-hot contraction.
    """
    # a sequence-parallel h is gathered first: the chunks cut the sequence
    h, labels = (sharded_only_on(t, 0) for t in (h, labels))
    B, S, _ = h.shape
    labels = labels.long()
    if S % chunk:
        pad = chunk - S % chunk
        h = shard_local(F.pad, h, (0, 0, 0, pad))
        labels = shard_local(F.pad, labels, (0, pad), "constant", -1)
    tot = torch.zeros((), dtype=F32, device=h.device)
    cnt = torch.zeros((), dtype=F32, device=h.device)
    for hc, lc in zip(h.split(chunk, dim=1), labels.split(chunk, dim=1)):
        t, c = checkpoint(_ce_chunk, hc, head_w, lc, vocab_size,
                          use_reentrant=False, preserve_rng_state=False)
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)
