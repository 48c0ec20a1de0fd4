"""Analytic parameter counts (total and active) per architecture config.

Port of ``repro/launch/flops.py``, the reference's formula to the integer.
``active_param_count`` counts the parameters one token touches (an MoE
layer counts its top-k experts and its dense residual): the N of
MODEL_FLOPS = 6 N D (``launch/roofline.model_flops``).

The formula is not the size of the tree ``models.transformer.init_model``
builds: it leaves out the q / k norms (2 head_dim a layer, qwen3-4b) and
the SSM conv bias (d_inner + 2N a layer, mamba2 and jamba).  Count a
built tree with ``models.transformer.param_count``.
"""
from __future__ import annotations

from ..configs.base import ArchConfig, LayerSpec


def _attn_params(cfg: ArchConfig) -> int:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return d * hd * (H + 2 * KV) + H * hd * d


def _mlp_params(cfg: ArchConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff


def _moe_params(cfg: ArchConfig, active: bool) -> int:
    e = cfg.top_k if active else cfg.n_experts
    p = cfg.d_model * cfg.n_experts            # router
    p += e * 3 * cfg.d_model * cfg.d_ff
    if cfg.moe_dense_residual:
        p += _mlp_params(cfg, cfg.dense_residual_d_ff or 2 * cfg.d_model)
    return p


def _ssm_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = di // cfg.ssm_head_dim
    p = d * (2 * di + 2 * N + H)               # in_proj
    p += cfg.ssm_conv_width * (di + 2 * N)     # conv
    p += 3 * H + di                            # A_log, D, dt_bias, norm
    p += di * d                                # out_proj
    return p


def _layer_params(cfg: ArchConfig, spec: LayerSpec, active: bool) -> int:
    p = cfg.d_model                            # norm1
    p += _attn_params(cfg) if spec.kind == "attn" else _ssm_params(cfg)
    if spec.mlp == "dense":
        p += cfg.d_model + _mlp_params(cfg, cfg.d_ff)
    elif spec.mlp == "moe":
        p += cfg.d_model + _moe_params(cfg, active)
    return p


def param_count(cfg: ArchConfig, *, active: bool = False) -> int:
    per_period = sum(_layer_params(cfg, s, active) for s in cfg.pattern)
    total = cfg.n_periods * per_period
    total += cfg.padded_vocab * cfg.d_model            # embed
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.padded_vocab        # lm head
    total += cfg.d_model                               # final norm
    total += len(cfg.exit_layer_list) * cfg.d_model    # tied exit norms
    return total


def active_param_count(cfg: ArchConfig) -> int:
    return param_count(cfg, active=True)
