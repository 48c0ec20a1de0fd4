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
back.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

F32 = torch.float32

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

#: does this torch offer ``mm(a, b, out_dtype=float32)`` (and ``bmm``) for
#: half-precision inputs (float32 accumulation without rounding the
#: output)?  Read once from the operators' overloads; where it is missing,
#: ``matmul_f32`` / ``bmm_f32`` upcast the operands instead.
_MM_OUT_DTYPE = "dtype" in torch.ops.aten.mm.overloads()
_BMM_OUT_DTYPE = "dtype" in torch.ops.aten.bmm.overloads()


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype,
               device) -> torch.Tensor:
    """Normal / sqrt(fan_in), drawn in float32 and cast (the reference's
    ``dense_init``; the numbers differ, the distribution does not)."""
    x = torch.randn(shape, generator=gen, dtype=F32, device=device)
    return x.div_(math.sqrt(fan_in)).to(dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` with a float32 result: the
    reference's ``einsum(..., preferred_element_type=float32)``.  A
    half-precision CUDA product asks cuBLAS for a float32 output where this
    torch offers it, else both operands are upcast (the same numbers: a
    bf16 value is exact in float32)."""
    if x.dtype == F32 and w.dtype == F32:
        return torch.matmul(x, w)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and _MM_OUT_DTYPE:
        out = torch.mm(x2, w, out_dtype=F32)
    else:
        out = torch.mm(x2.to(F32), w.to(F32))
    return out.reshape(*lead, w.shape[-1])


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` with a float32 result, as ``matmul_f32``: a [E, M, K],
    b [E, K, N] -> [E, M, N] float32."""
    if a.dtype == F32 and b.dtype == F32:
        return torch.bmm(a, b)
    if a.is_cuda and _BMM_OUT_DTYPE:
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.to(F32), b.to(F32))


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
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
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
    return torch.matmul(h, params["w_down"])


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab_padded: int, d_model: int, dtype,
               device) -> Dict[str, torch.Tensor]:
    return {"table": dense_init(gen, (vocab_padded, d_model), d_model, dtype,
                                device)}


def embed_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def lm_head_init(gen: torch.Generator, d_model: int, vocab_padded: int,
                 dtype, device) -> Dict[str, torch.Tensor]:
    return {"w": dense_init(gen, (d_model, vocab_padded), d_model, dtype,
                            device)}


def lm_head_apply(params: dict, x: torch.Tensor, vocab_size: int
                  ) -> torch.Tensor:
    """Float32 logits with the padded-vocab tail set to -inf."""
    logits = matmul_f32(x, params["w"])
    if logits.shape[-1] != vocab_size:
        logits[..., vocab_size:] = -math.inf
    return logits
