"""Plain float32 references of the served language models.

Full-sequence forwards over one or more token streams, from position 0,
in float32 with TF32 off: the published equations, with no kernel, cache
or batching of the program.  They read the weights the benchmark made
(the program's parameter layout: stacked per period) and the model's
sizes from the benchmark's configuration file, and import nothing of the
program.

* ``moe_attn``: Mixtral's decoder layer: RMSNorm, GQA attention with
  rotary positions (half-split rotation, base ``rope_theta``), causal and,
  where ``sliding_window`` is set, windowed; RMSNorm, a softmax router,
  the top-k experts (lower index first among ties) with their gates
  renormalised over the k, each expert a SwiGLU.
* ``ssm``: Mamba-2's SSD layer: RMSNorm, one input projection into z, the
  conv channels (x, B, C) and dt; a causal depthwise conv of width
  ``d_conv`` with SiLU; dt = softplus(dt + dt_bias), a = exp(-exp(A_log)
  dt); the recurrence h_t = a_t h_{t-1} + dt_t x_t (x) B_t, y_t = C_t . h_t
  + D x_t, run step by step; y * silu(z) through a gated RMSNorm and the
  output projection.

Early exits sit after the periods ``exits``: RMSNorm and the LM head
(tied to the final head; for a tied model the head is the embedding's
transpose).  ``quant="fp8"`` is the control: every weight matrix rounded
to float8 e4m3 with one scale an output channel, the arithmetic still
float32.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0


@dataclass(frozen=True)
class ModelSpec:
    kind: str                 # "moe_attn" | "ssm"
    d_model: int
    n_layers: int
    vocab_size: int
    exits: Tuple[int, ...]    # periods after which an exit sits
    eps: float
    tied: bool
    # attention / MoE
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    n_experts: int = 0
    top_k: int = 0
    rope_theta: float = 1e4
    window: int = 0
    # SSM
    d_state: int = 0
    ssm_head_dim: int = 0
    expand: int = 2
    d_conv: int = 4


@contextlib.contextmanager
def full_f32():
    """Float32 products in full float32 (TF32 off) inside the block."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _reduce_dims(name: str, ndim: int) -> Tuple[int, ...]:
    """The input axes of a weight matrix (a scale per output channel)."""
    if name == "table":
        return (ndim - 1,)
    if name == "wo":
        return (ndim - 3, ndim - 2)
    if name in ("wq", "wk", "wv"):
        return (ndim - 3,)
    return (ndim - 2,)


def fp8_round(w: torch.Tensor, name: str) -> torch.Tensor:
    """``w`` (float32) rounded to float8 e4m3 with a scale per output
    channel, back in float32."""
    dims = _reduce_dims(name, w.dim())
    amax = w.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    q = (w / s).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return q.to(F32) * s


class Weights:
    """Float32 views of the benchmark's weights, one period at a time,
    rounded to fp8 for the control."""

    MATRICES = ("table", "w", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                "w_down", "router", "in_proj", "out_proj", "conv_w")

    def __init__(self, params: dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.params = params
        self.quant = quant

    def get(self, t: torch.Tensor, name: str) -> torch.Tensor:
        w = t.to(F32)
        if self.quant == "fp8" and name in self.MATRICES:
            w = fp8_round(w, name)
        return w

    def tree(self, tree: dict, period: Optional[int] = None) -> dict:
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = self.tree(v, period)
            else:
                out[k] = self.get(v if period is None else v[period], k)
        return out

    def head(self) -> torch.Tensor:
        """The LM head [d, V_pad]."""
        if "lm_head" in self.params:
            return self.get(self.params["lm_head"]["w"], "w")
        return self.get(self.params["embed"]["table"], "table").T


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [..., P, H, D] rotated by positions [P] (half-split pairs)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                       device=x.device) / D)
    ang = (positions.to(torch.float64)[:, None] * inv).to(F32)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(spec: ModelSpec, w: dict, hn: torch.Tensor) -> torch.Tensor:
    R, P, d = hn.shape
    H, KV, D = spec.n_heads, spec.n_kv_heads, spec.head_dim
    pos = torch.arange(P, device=hn.device)
    q = rope((hn @ w["wq"].reshape(d, H * D)).view(R, P, H, D), pos,
             spec.rope_theta)
    k = rope((hn @ w["wk"].reshape(d, KV * D)).view(R, P, KV, D), pos,
             spec.rope_theta)
    v = (hn @ w["wv"].reshape(d, KV * D)).view(R, P, KV, D)
    ok = pos[None, :] <= pos[:, None]
    if spec.window > 0:
        ok &= pos[None, :] > pos[:, None] - spec.window
    G = H // KV
    out = torch.empty(R, P, H, D, dtype=F32, device=hn.device)
    for r in range(R):
        for g in range(KV):
            qh = q[r, :, g * G:(g + 1) * G].transpose(0, 1)       # [G, P, D]
            s = qh @ k[r, :, g].T * D ** -0.5                      # [G, P, P]
            s = s.masked_fill(~ok, float("-inf"))
            out[r, :, g * G:(g + 1) * G] = (
                torch.softmax(s, -1) @ v[r, :, g]).transpose(0, 1)
    return out.reshape(R, P, H * D) @ w["wo"].reshape(H * D, d)


def _moe(spec: ModelSpec, w: dict, hn: torch.Tensor) -> torch.Tensor:
    shape = hn.shape
    x = hn.reshape(-1, shape[-1])
    probs = torch.softmax(x @ w["router"], dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :spec.top_k], ids[:, :spec.top_k]
    vals = vals / vals.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(spec.n_experts):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(xe @ w["w_gate"][e]) * (xe @ w["w_up"][e])
        y.index_add_(0, tok, (h @ w["w_down"][e]) * vals[tok, slot, None])
    return y.view(shape)


def _ssm(spec: ModelSpec, w: dict, hn: torch.Tensor) -> torch.Tensor:
    R, P, d = hn.shape
    di = spec.expand * d
    N, Ph = spec.d_state, spec.ssm_head_dim
    H = di // Ph
    z, xbc, dt = torch.split(hn @ w["in_proj"], [di, di + 2 * N, H], dim=-1)
    width = w["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(xp[:, i:i + P] * w["conv_w"][i] for i in range(width))
    conv = F.silu(conv + w["conv_b"])
    xs, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)
    xh = xs.view(R, P, H, Ph)
    dt = F.softplus(dt + w["dt_bias"], beta=1.0, threshold=1e30)
    a = torch.exp(-torch.exp(w["A_log"]) * dt)                     # [R,P,H]
    xdt = xh * dt[..., None]                                       # [R,P,H,Ph]
    state = torch.zeros(R, H, Ph, N, dtype=F32, device=hn.device)
    y = torch.empty(R, P, H, Ph, dtype=F32, device=hn.device)
    for t in range(P):
        state = (state * a[:, t, :, None, None]
                 + xdt[:, t, :, :, None] * Bm[:, t, None, None, :])
        y[:, t] = (state @ Cm[:, t, None, :, None])[..., 0]
    y = y + xh * w["D"][:, None]
    y = y.reshape(R, P, di) * F.silu(z)
    return rmsnorm(y, w["norm"]["scale"], spec.eps) @ w["out_proj"]


def forward(spec: ModelSpec, params: dict, tokens: torch.Tensor,
            rows: torch.Tensor, positions: torch.Tensor, *,
            quant: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The logits of every head at the positions asked for.

    tokens [R, P] (each row one stream from position 0); rows / positions
    [n] pick the outputs.  Returns {"exit_<p>": [n, V], "final": [n, V]}
    float32 over the vocabulary (the padded tail dropped)."""
    W = Weights(params, quant)
    out: Dict[str, torch.Tensor] = {}
    with full_f32(), torch.no_grad():
        head = W.head()[:, :spec.vocab_size]
        h = W.get(params["embed"]["table"], "table")[tokens]
        for p in range(spec.n_layers):
            w = W.tree(params["layers"]["l0"], period=p)
            hn = rmsnorm(h, w["norm1"]["scale"], spec.eps)
            if spec.kind == "moe_attn":
                h = h + _attention(spec, w["mix"], hn)
                hn = rmsnorm(h, w["norm2"]["scale"], spec.eps)
                h = h + _moe(spec, w["mlp"], hn)
            else:
                h = h + _ssm(spec, w["mix"], hn)
            del w
            if p + 1 in spec.exits:
                scale = params["exits"][f"exit_{p + 1}"]["norm"]["scale"]
                out[f"exit_{p + 1}"] = rmsnorm(
                    h[rows, positions], scale.to(F32), spec.eps) @ head
        out["final"] = rmsnorm(h[rows, positions],
                               params["final_norm"]["scale"].to(F32),
                               spec.eps) @ head
    return out


def heads_order(spec: ModelSpec) -> List[str]:
    """Head names in exit order: the early exits, then ``final``."""
    return [f"exit_{p}" for p in spec.exits] + ["final"]


def log_confidence(logits: torch.Tensor) -> torch.Tensor:
    """log of the max softmax probability of each row (the exit gate's
    statistic): max - logsumexp."""
    return logits.amax(-1) - torch.logsumexp(logits, -1)


def first_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The lowest index among each row's largest values."""
    m = logits.amax(-1, keepdim=True)
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits == m, idx, logits.shape[-1]).amin(-1)


def choose_exits(logits: Dict[str, torch.Tensor], names: Sequence[str],
                 thresholds: Sequence[float]) -> torch.Tensor:
    """First-exit-wins over the heads ``names`` (in exit order): the first
    early exit whose confidence reaches its threshold, else the last head
    -> exit index [n]."""
    n = logits["final"].shape[0]
    choice = torch.full((n,), len(names) - 1, dtype=torch.long,
                        device=logits["final"].device)
    for j in reversed(range(len(names) - 1)):
        take = log_confidence(logits[names[j]]) >= math.log(thresholds[j])
        choice = torch.where(take, j, choice)
    return choice
