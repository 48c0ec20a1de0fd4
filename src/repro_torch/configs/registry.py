"""Architecture registry: the ten assigned architectures as data.

A copy of the builders of the reference's ``configs/registry.py``, each
with its public-literature source tag.  ``get(name)`` returns the full
config, ``get(name, reduced=True)`` the CPU-test variant.  The reference's
TPU sharding overrides (``optimized=``) and its dry-run cell lists are not
copied: the port reads no sharding knob.  The serving slice builds the
attention / dense-MLP architectures; ``models.transformer`` refuses the
SSM and MoE layers of the others.
"""
from __future__ import annotations

from typing import List

from .base import ArchConfig, LayerSpec

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


def get(name: str, *, reduced: bool = False) -> ArchConfig:
    """The published configuration of ``name``, or its reduced CPU-test
    variant."""
    if name not in _BUILDERS:
        raise ValueError(f"unknown architecture {name!r}; known: "
                         f"{ARCH_NAMES}")
    cfg = _BUILDERS[name]()
    return cfg.reduced() if reduced else cfg
