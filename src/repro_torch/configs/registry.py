"""Architecture registry: the ten assigned architectures as data.

A copy of the builders of the reference's ``configs/registry.py``, each
with its public-literature source tag.  ``get(name)`` returns the full
config, ``get(name, reduced=True)`` the CPU-test variant and
``get(name, optimized=True)`` the config with ``OPTIMIZED_OVERRIDES``
(the sharding and runtime knobs that ``sharding/specs.py`` and
``launch/analytic.py`` read).  ``runnable_cells`` / ``all_cells`` /
``skipped_cells`` are the dry run's (arch x shape) cells.
"""
from __future__ import annotations

import dataclasses
from typing import List

from .base import SHAPES, ArchConfig, LayerSpec

A = LayerSpec("attn", "dense")


def _jamba() -> ArchConfig:
    # [arXiv:2403.19887; hf] — Mamba+attention 1:7 interleave, MoE 16e top-2
    # (MoE on alternate layers; attention at position 4 of each 8-layer block).
    pattern = tuple(
        LayerSpec("attn" if i == 4 else "ssm",
                  "moe" if i % 2 == 1 else "dense")
        for i in range(8))
    return ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
        vocab_size=65536, pattern=pattern, head_dim=128,
        n_experts=16, top_k=2, ssm_state=128, ssm_head_dim=64,
        expert_parallel=True, fsdp=True, master_weights=False,
        remat="full")


def _phi3() -> ArchConfig:
    # [arXiv:2404.14219; unverified] — dense, RoPE SwiGLU GQA (40H, kv=10)
    return ArchConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
        vocab_size=100352, pattern=(A,), head_dim=128)


def _qwen3() -> ArchConfig:
    # [hf:Qwen/Qwen3-8B; hf] — dense, qk_norm, GQA kv=8
    return ArchConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
        vocab_size=151936, pattern=(A,), head_dim=80, qk_norm=True)


def _minitron() -> ArchConfig:
    # [arXiv:2407.14679; hf] — pruned nemotron, GQA kv=8
    return ArchConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
        vocab_size=256000, pattern=(A,), head_dim=128)


def _granite() -> ArchConfig:
    # [arXiv:2405.04324; hf] — llama-arch code model, MQA (kv=1)
    return ArchConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
        vocab_size=49152, pattern=(A,), head_dim=128,
        kv_shard_mode="sequence")


def _hubert() -> ArchConfig:
    # [arXiv:2106.07447; unverified] — encoder-only audio; frame-label head
    return ArchConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
        vocab_size=504, pattern=(A,), head_dim=80,
        causal=False, has_decoder=False, frontend="audio",
        vocab_pad_multiple=512)


def _arctic() -> ArchConfig:
    # [hf:Snowflake/snowflake-arctic-base; hf] — 128e top-2 + dense residual
    return ArchConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
        vocab_size=32000, pattern=(LayerSpec("attn", "moe"),), head_dim=128,
        n_experts=128, top_k=2, moe_dense_residual=True,
        dense_residual_d_ff=14336,
        expert_parallel=True, fsdp=True, master_weights=False,
        remat="full")


def _mixtral() -> ArchConfig:
    # [arXiv:2401.04088; hf] — 8 experts top-2, sliding-window attention
    return ArchConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
        vocab_size=32768, pattern=(LayerSpec("attn", "moe"),), head_dim=128,
        n_experts=8, top_k=2, sliding_window=4096,
        fsdp=True, remat="full")


def _mamba2() -> ArchConfig:
    # [arXiv:2405.21060; unverified] — SSD, attention-free, no MLP
    return ArchConfig(
        name="mamba2-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=50280, pattern=(LayerSpec("ssm", "none"),),
        ssm_state=128, ssm_head_dim=64, tie_embeddings=True)


def _internvl2() -> ArchConfig:
    # [arXiv:2404.16821; hf] — InternViT (stub) + InternLM2 backbone
    return ArchConfig(
        name="internvl2-2b", family="vlm",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
        vocab_size=92553, pattern=(A,), head_dim=128,
        frontend="vision", n_patches=1024)


#: Sharding / runtime overrides of the reference's performance study, as
#: data: the base configs stay paper-faithful (Megatron TP x DP) and
#: ``get(name, optimized=True)`` applies these.
OPTIMIZED_OVERRIDES = {
    # small dense models: pure DP / ZeRO-3 over the whole mesh
    "qwen3-4b": dict(parallelism_mode="pure_dp"),
    "internvl2-2b": dict(parallelism_mode="pure_dp"),
    "mamba2-1.3b": dict(parallelism_mode="pure_dp"),
    "hubert-xlarge": dict(parallelism_mode="pure_dp"),
    # mid / large dense: TP with sequence parallelism
    "phi3-medium-14b": dict(seq_parallel=True),
    "minitron-8b": dict(seq_parallel=True),
    "granite-34b": dict(seq_parallel=True, kv_cache_dtype="int8"),
    "mixtral-8x22b": dict(seq_parallel=True),
    "arctic-480b": dict(seq_parallel=True),
    # hybrid: also shard the SSD heads over the model axis
    "jamba-1.5-large-398b": dict(seq_parallel=True, ssm_head_shard=True),
}

_BUILDERS = {
    "jamba-1.5-large-398b": _jamba,
    "phi3-medium-14b": _phi3,
    "qwen3-4b": _qwen3,
    "minitron-8b": _minitron,
    "granite-34b": _granite,
    "hubert-xlarge": _hubert,
    "arctic-480b": _arctic,
    "mixtral-8x22b": _mixtral,
    "mamba2-1.3b": _mamba2,
    "internvl2-2b": _internvl2,
}

ARCH_NAMES: List[str] = list(_BUILDERS)


def get(name: str, *, reduced: bool = False,
        optimized: bool = False) -> ArchConfig:
    """The published configuration of ``name`` (with ``OPTIMIZED_OVERRIDES``
    when ``optimized``), or its reduced CPU-test variant."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown architecture {name!r}; known: "
                         f"{ARCH_NAMES}")
    cfg = _BUILDERS[name]()
    if optimized:
        cfg = dataclasses.replace(cfg, **OPTIMIZED_OVERRIDES.get(name, {}))
    return cfg.reduced() if reduced else cfg


def sub_quadratic(cfg: ArchConfig) -> bool:
    """Eligibility for long_500k: SSM/hybrid, or bounded-window attention."""
    kinds = {s.kind for s in cfg.pattern}
    if "ssm" in kinds:
        return True        # SSM, or hybrid: attention KV is 1/8 of layers
    return cfg.sliding_window > 0


def runnable_cells(arch: str) -> List[str]:
    """The (arch x shape) cells that are well-defined for this arch."""
    cfg = get(arch)
    cells = ["train_4k", "prefill_32k"]
    if cfg.has_decoder:
        cells.append("decode_32k")
        if sub_quadratic(cfg):
            cells.append("long_500k")
    return cells


def all_cells() -> List[tuple]:
    return [(a, s) for a in ARCH_NAMES for s in runnable_cells(a)]


def skipped_cells() -> List[tuple]:
    out = []
    for a in ARCH_NAMES:
        run = set(runnable_cells(a))
        for s in SHAPES:
            if s not in run:
                reason = ("encoder-only (no autoregressive step)"
                          if not get(a).has_decoder
                          else "pure full attention (no sub-quadratic path)")
                out.append((a, s, reason))
    return out
