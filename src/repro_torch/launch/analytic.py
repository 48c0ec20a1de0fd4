"""Analytic cost model: FLOPs / HBM bytes / collective wire bytes per step.

Port of ``repro/launch/analytic.py``.  PyTorch has no compiled HLO whose
cost the dry run could read, so this model, exact FLOP accounting from
the architecture config, is the port's only count of a step's work: the
roofline (``launch/roofline.py``) and the dry run (``launch/dryrun.py``)
take their compute, memory and collective terms from it.  Every quantity
is a Python float computed in the reference's order of operations, so the
two packages give equal numbers for every cell.

All quantities are per card per step unless suffixed ``_total``.  The
collective model counts ring all-reduces, all-gathers, reduce-scatters and
all-to-alls over the mesh axes of ``sharding/specs.py``'s policy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..configs.base import ArchConfig, LayerSpec, ShapeSpec
from .flops import param_count


@dataclass
class AnalyticCost:
    flops: float               # per card
    hbm_bytes: float           # per card
    wire_bytes: float          # per card
    detail: Dict[str, float]


def _bytes_of(cfg: ArchConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


# ---------------------------------------------------------------------------
# Forward FLOPs per token, per layer component
# ---------------------------------------------------------------------------

def _attn_fwd_flops_tok(cfg: ArchConfig, ctx: float) -> float:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    proj = 2 * d * hd * (H + 2 * KV) + 2 * H * hd * d
    scores = 2 * 2 * H * hd * ctx
    return proj + scores


def _mlp_fwd_flops_tok(cfg: ArchConfig, d_ff: int) -> float:
    return 6 * cfg.d_model * d_ff


def _moe_fwd_flops_tok(cfg: ArchConfig) -> float:
    f = 2 * cfg.d_model * cfg.n_experts
    f += cfg.top_k * 6 * cfg.d_model * cfg.d_ff
    if cfg.moe_dense_residual:
        f += 6 * cfg.d_model * (cfg.dense_residual_d_ff or 2 * cfg.d_model)
    return f


def _ssm_fwd_flops_tok(cfg: ArchConfig, decode: bool) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = di // cfg.ssm_head_dim
    Q = cfg.ssm_chunk
    f = 2 * d * (2 * di + 2 * N + H)           # in_proj
    f += 2 * cfg.ssm_conv_width * (di + 2 * N)  # conv
    if decode:
        f += 4 * N * di + 2 * N * di            # recurrent step
    else:
        f += 2 * Q * (N + di)                   # intra-chunk dual form
        f += 4 * N * di                         # inter-chunk + state update
    f += 2 * di * d                             # out_proj
    return f


def _ctx(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Average attended context length per token."""
    if shape.kind == "decode":
        kv = shape.seq_len
        return float(min(kv, cfg.sliding_window) if cfg.sliding_window else kv)
    S = shape.seq_len
    if not cfg.causal:
        return float(S)
    avg = (S + 1) / 2.0
    return float(min(avg, cfg.sliding_window) if cfg.sliding_window else avg)


def fwd_flops_per_token(cfg: ArchConfig, shape: ShapeSpec,
                        *, split: bool = False):
    """Per-token forward FLOPs; with split=True returns (sharded,
    replicated) where `replicated` is work that baseline TP does NOT divide
    across the model axis (SSD inner compute without cfg.ssm_head_shard:
    every device computes the full d_inner)."""
    ctx = _ctx(cfg, shape)
    decode = shape.kind == "decode"
    sharded = repl = 0.0
    for spec in cfg.pattern:
        if spec.kind == "attn":
            sharded += _attn_fwd_flops_tok(cfg, ctx)
        else:
            f = _ssm_fwd_flops_tok(cfg, decode)
            if cfg.ssm_head_shard or cfg.parallelism_mode == "pure_dp":
                sharded += f
            else:
                repl += f
        if spec.mlp == "dense":
            sharded += _mlp_fwd_flops_tok(cfg, cfg.d_ff)
        elif spec.mlp == "moe":
            sharded += _moe_fwd_flops_tok(cfg)
    sharded *= cfg.n_periods
    repl *= cfg.n_periods
    n_heads_out = 1 + len(cfg.exit_layer_list)
    sharded += n_heads_out * 2 * cfg.d_model * cfg.padded_vocab
    if split:
        return sharded, repl
    return sharded + repl


_REMAT_FACTOR = {"none": 3.0, "dots": 10.0 / 3.0, "full": 4.0,
                 "layer": 5.0}  # nested outer+inner recompute


def analytic_cost(cfg: ArchConfig, shape: ShapeSpec, chips: int,
                  mesh_axes: Dict[str, int]) -> AnalyticCost:
    """FLOPs / HBM / wire bytes per card for one step of this cell on
    ``chips`` cards whose mesh axes have the sizes ``mesh_axes``."""
    n_model = mesh_axes.get("model", 1)
    n_data = mesh_axes.get("data", 1) * mesh_axes.get("pod", 1)
    if cfg.parallelism_mode == "pure_dp":
        n_data *= n_model          # the whole mesh is one DP/ZeRO-3 domain
        n_model = 1
    use_zero = cfg.fsdp or cfg.parallelism_mode == "pure_dp"
    dt = _bytes_of(cfg)

    tokens_total = (shape.global_batch if shape.kind == "decode"
                    else shape.global_batch * shape.seq_len)
    tokens_local = tokens_total / n_data

    fwd_shard, fwd_repl = fwd_flops_per_token(cfg, shape, split=True)
    passes_f = _REMAT_FACTOR[cfg.remat] if shape.kind == "train" else 1.0
    # sharded work divides across all chips; model-axis-replicated work
    # (SSD without head sharding) divides across the DP domain only.
    flops_chip = (fwd_shard * tokens_total * passes_f / chips
                  + fwd_repl * tokens_total * passes_f / n_data)
    flops_total = (fwd_shard + fwd_repl) * tokens_total * passes_f

    # ---- HBM bytes ----------------------------------------------------------
    n_params = param_count(cfg)
    params_chip = n_params * dt / (n_model * (n_data if use_zero else 1))
    act_io = tokens_local * cfg.d_model * dt
    detail: Dict[str, float] = {}
    if shape.kind == "train":
        opt_dt = 4 if cfg.master_weights else 2
        opt_chip = 2 * n_params * opt_dt / (n_model *
                                            (n_data if use_zero else 1))
        grads_chip = params_chip
        # weights: fwd read + bwd read (+ remat re-read); grads: write+read;
        # optimizer: read + write; activations: ~10 layer-sized streams/layer
        hbm = params_chip * (3 if cfg.remat != "none" else 2)
        hbm += 2 * grads_chip + 2 * opt_chip
        hbm += cfg.n_layers * act_io * 10
        detail["hbm_params"] = params_chip * 3
        detail["hbm_opt"] = 2 * opt_chip
        detail["hbm_acts"] = cfg.n_layers * act_io * 10
    elif shape.kind == "prefill":
        hbm = params_chip + cfg.n_layers * act_io * 8
    else:  # decode
        cache_chip = _cache_bytes_total(cfg, shape) / chips
        hbm = params_chip + cache_chip + cfg.n_layers * act_io * 8
        detail["hbm_cache"] = cache_chip
    detail["hbm_params_chip"] = params_chip

    # ---- collective wire bytes ----------------------------------------------
    wire = 0.0
    ring = lambda b, n: 2 * b * (n - 1) / n          # all-reduce
    half = lambda b, n: b * (n - 1) / n              # ag / rs / a2a
    act_f32 = tokens_local * cfg.d_model * 4          # TP reduces happen in f32

    n_attn = sum(1 for s in cfg.pattern if s.kind == "attn") * cfg.n_periods
    n_ssm = sum(1 for s in cfg.pattern if s.kind == "ssm") * cfg.n_periods
    n_mlp = sum(1 for s in cfg.pattern if s.mlp == "dense") * cfg.n_periods
    n_moe = sum(1 for s in cfg.pattern if s.mlp == "moe") * cfg.n_periods

    if n_model > 1:
        # one row-parallel all-reduce per attn/mlp output (fwd); ssm: two
        per_fwd = (n_attn + n_mlp + 2 * n_ssm + n_moe * (
            1 + (1 if cfg.moe_dense_residual else 0)))
        passes = 1.0 if shape.kind != "train" else (
            2.0 + (1.0 if cfg.remat == "full" else 0.0))
        if cfg.seq_parallel:
            # Megatron-SP: all-reduce -> all-gather + reduce-scatter of bf16
            # activations (half the f32 ring volume)
            act_bf16 = tokens_local * cfg.d_model * dt
            tp_unit = 2 * half(act_bf16, n_model)
        else:
            tp_unit = ring(act_f32, n_model)
        wire += per_fwd * passes * tp_unit
        detail["wire_tp"] = per_fwd * passes * tp_unit
        # vocab-parallel heads: logits lse reductions are tiny; ignore
        if cfg.expert_parallel and cfg.n_experts % n_model == 0 and n_moe:
            a2a = tokens_local * cfg.top_k * cfg.d_model * dt
            wire += n_moe * passes * 2 * half(a2a, n_model)
            detail["wire_ep_a2a"] = n_moe * passes * 2 * half(a2a, n_model)
    if shape.kind == "train" and n_data > 1:
        grads_chip_b = n_params * dt / n_model
        if use_zero:
            # ZeRO-3: reduce-scatter grads + all-gather params (fwd+bwd)
            ws = 3 * half(grads_chip_b, n_data)
            if cfg.remat == "full":
                ws += half(grads_chip_b, n_data)
        else:
            ws = ring(grads_chip_b, n_data)
        wire += ws
        detail["wire_dp"] = ws
    if shape.kind == "decode" and n_model > 1:
        # sequence-sharded KV: per-layer partial-softmax combine (tiny) —
        # count the query broadcast + output reduce per attn layer
        q_b = (shape.global_batch / n_data) * cfg.n_heads * cfg.head_dim_ * dt \
            if cfg.n_heads else 0.0
        wire += n_attn * 2 * ring(q_b, n_model)
        detail["wire_decode_attn"] = n_attn * 2 * ring(q_b, n_model)

    return AnalyticCost(flops=flops_chip, hbm_bytes=hbm, wire_bytes=wire,
                        detail=detail)


def _cache_bytes_total(cfg: ArchConfig, shape: ShapeSpec) -> float:
    dt = _bytes_of(cfg)
    kv_dt = 1 + 4.0 / cfg.head_dim_ if cfg.kv_cache_dtype == "int8" else dt
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    for spec in cfg.pattern:
        if spec.kind == "attn":
            T = min(S, cfg.sliding_window) if cfg.sliding_window else S
            total += 2 * B * T * cfg.n_kv_heads * cfg.head_dim_ * kv_dt
        else:
            di = cfg.ssm_expand * cfg.d_model
            N = cfg.ssm_state
            H = di // cfg.ssm_head_dim
            total += B * H * cfg.ssm_head_dim * N * 4
            total += B * (cfg.ssm_conv_width - 1) * (di + 2 * N) * dt
    return total * cfg.n_periods
