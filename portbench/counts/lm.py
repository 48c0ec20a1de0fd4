"""Operations and bytes of one decode step of a served language model.

Counted from the configuration's sizes (``reference.lm.ModelSpec``), never
from the program: a later change to the program cannot move them.  A step
runs ``batch`` rows at one position ``pos``; attention reads the positions
held, ``min(pos + 1, window)`` (all of ``pos + 1`` without a window).
Bytes count each input read once and each output written once: the
weights (bf16; the router and the SSM's per-head vectors float32), every
head's matrix once (the exits share the final head's matrix but each reads
it), the experts that the step's tokens use (``live_experts``: at top-k of
E over ``batch`` uniform tokens, E (1 - (1 - k/E)^batch), 8.0 at 128
tokens), the K/V read at the positions held and the new K/V written, the
SSM's float32 state and conv tail read and written, the embedding rows
gathered and the float32 logits written.  Operations count 2 a
multiply-add: the projections and experts in use, QK^T and PV over the
positions held, the SSM update (decay, outer product, contraction with
C: 5 a state element) and its conv, and every head.
"""
from __future__ import annotations

from ..reference.lm import ModelSpec

WEIGHT_BYTES = 2          # bf16
F32_BYTES = 4


def n_heads_out(spec: ModelSpec) -> int:
    return len(spec.exits) + 1


def context(spec: ModelSpec, pos: int) -> int:
    held = pos + 1
    return min(held, spec.window) if spec.window > 0 else held


def live_experts(spec: ModelSpec, batch: int) -> float:
    E, k = spec.n_experts, spec.top_k
    return E - E * (1.0 - k / E) ** batch


def ssm_dims(spec: ModelSpec):
    di = spec.expand * spec.d_model
    return di, di // spec.ssm_head_dim, spec.ssm_head_dim, spec.d_state


def attn_params(spec: ModelSpec) -> int:
    d, H, KV, D = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    return d * D * (2 * H + 2 * KV)


def expert_params(spec: ModelSpec) -> int:
    """One expert's SwiGLU."""
    return 3 * spec.d_model * spec.d_ff


def ssm_matrix_params(spec: ModelSpec) -> int:
    di, H, P, N = ssm_dims(spec)
    d = spec.d_model
    return d * (2 * di + 2 * N + H) + di * d


def layer_bytes(spec: ModelSpec, batch: int) -> float:
    """Weights one layer's step reads."""
    d = spec.d_model
    if spec.kind == "moe_attn":
        return (attn_params(spec) * WEIGHT_BYTES
                + live_experts(spec, batch) * expert_params(spec)
                * WEIGHT_BYTES
                + d * spec.n_experts * F32_BYTES + 2 * d * WEIGHT_BYTES)
    di, H, P, N = ssm_dims(spec)
    conv = spec.d_conv * (di + 2 * N) + (di + 2 * N)
    return ((ssm_matrix_params(spec) + conv + di + d) * WEIGHT_BYTES
            + 3 * H * F32_BYTES)


def head_bytes(spec: ModelSpec) -> float:
    return spec.d_model * spec.vocab_size * WEIGHT_BYTES


def state_bytes(spec: ModelSpec, batch: int, pos: int) -> float:
    """Per-step cache traffic of all layers: K/V read at the positions held
    and written at the new one, or the SSM state and conv tail read and
    written."""
    L = spec.n_layers
    if spec.kind == "moe_attn":
        kv = spec.n_kv_heads * spec.head_dim * 2 * WEIGHT_BYTES
        return batch * L * kv * (context(spec, pos) + 1)
    di, H, P, N = ssm_dims(spec)
    state = H * P * N * F32_BYTES
    conv = (spec.d_conv - 1) * (di + 2 * N) * WEIGHT_BYTES
    return batch * L * 2 * (state + conv)


def step_bytes(spec: ModelSpec, batch: int, pos: int) -> float:
    heads = n_heads_out(spec)
    return (spec.n_layers * layer_bytes(spec, batch)
            + heads * head_bytes(spec)
            + (heads + 1) * spec.d_model * WEIGHT_BYTES      # norm scales
            + batch * spec.d_model * WEIGHT_BYTES            # embedding rows
            + state_bytes(spec, batch, pos)
            + heads * batch * spec.vocab_size * F32_BYTES)   # logits


def token_flops(spec: ModelSpec, pos: int) -> float:
    """Operations of one row of a decode step at ``pos``."""
    d = spec.d_model
    if spec.kind == "moe_attn":
        layer = (2 * attn_params(spec)
                 + 4 * spec.n_heads * spec.head_dim * context(spec, pos)
                 + 2 * spec.top_k * expert_params(spec)
                 + 2 * d * spec.n_experts)
    else:
        di, H, P, N = ssm_dims(spec)
        layer = (2 * ssm_matrix_params(spec)
                 + 2 * spec.d_conv * (di + 2 * N) + 5 * H * P * N)
    return spec.n_layers * layer + n_heads_out(spec) * 2 * d * spec.vocab_size


def step_flops(spec: ModelSpec, batch: int, pos: int) -> float:
    return batch * token_flops(spec, pos)


def decode_attn_call(spec: ModelSpec, batch: int, pos: int):
    """(operations, bytes) of one call of the decode attention kernel (one
    layer): q and the output in bf16, K and V at the positions held, and
    their positions (int32)."""
    H, KV, D = spec.n_heads, spec.n_kv_heads, spec.head_dim
    ctx = context(spec, pos)
    nbytes = (batch * ctx * KV * D * 2 * WEIGHT_BYTES
              + 2 * batch * H * D * WEIGHT_BYTES + ctx * 4)
    return 4.0 * batch * H * D * ctx, float(nbytes)


def moe_ffn_call(spec: ModelSpec, batch: int):
    """(operations, bytes) of one call of the MoE experts' kernel (one
    layer at decode, one token a group): the experts in use, the tokens,
    each slot's index, flag and gate, and the float32 output slots."""
    d, E = spec.d_model, spec.n_experts
    nbytes = (live_experts(spec, batch) * expert_params(spec) * WEIGHT_BYTES
              + batch * d * WEIGHT_BYTES + batch * E * (8 + 1 + 4)
              + batch * E * d * F32_BYTES)
    return 2.0 * batch * spec.top_k * expert_params(spec), float(nbytes)


def param_count(spec: ModelSpec, padded_vocab: int) -> int:
    """Parameters of the whole model (embedding and head at the padded
    vocabulary, as held)."""
    d = spec.d_model
    if spec.kind == "moe_attn":
        layer = (attn_params(spec) + spec.n_experts * expert_params(spec)
                 + d * spec.n_experts + 2 * d)
    else:
        di, H, P, N = ssm_dims(spec)
        layer = (ssm_matrix_params(spec) + spec.d_conv * (di + 2 * N)
                 + (di + 2 * N) + 3 * H + di + d)
    heads = 1 if spec.tied else 2
    return (spec.n_layers * layer + heads * padded_vocab * d
            + (len(spec.exits) + 1) * d)
