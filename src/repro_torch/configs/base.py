"""Architecture configuration schema for the LM-family backbones.

A copy of the reference's ``configs/base.py`` (the port imports nothing of
the JAX package).  One ``ArchConfig`` fully describes an architecture:
topology (attention / SSM / MoE layer pattern), dimensions, modality
frontend stubs, early-exit placement (the paper's technique) and the
runtime and sharding knobs (``sharding/specs.py`` and the analytic cost
model ``launch/analytic.py`` read the latter).  ``reduced()`` derives the
CPU-test variant of the same family.  ``SHAPES`` are the input shapes of
the dry run's cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating period."""
    kind: str          # "attn" | "ssm"
    mlp: str           # "dense" | "moe" | "none"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 for attention-free layers
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # ---- layer pattern (one period, tiled n_layers / len(pattern) times) ----
    pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)

    head_dim: int = 0                # 0 -> d_model // n_heads

    # ---- MoE ----
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False     # arctic: dense FFN parallel to MoE
    dense_residual_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "gather"             # "gather" | "einsum" (GShard-style)

    # ---- attention details ----
    qk_norm: bool = False
    sliding_window: int = 0              # 0 = full attention
    rope_theta: float = 1e4
    causal: bool = True                  # False: encoder-only (hubert)
    attn_chunk: int = 1024               # KV chunk for online-softmax attention

    # ---- SSM (mamba2 / SSD) ----
    ssm_state: int = 0                   # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256                 # SSD chunk length

    # ---- serving / decode ----
    has_decoder: bool = True             # False: encoder-only, no serve_step

    # ---- modality frontend stub ----
    frontend: str = "none"               # none | audio | vision
    n_patches: int = 0                   # vision prefix length

    # ---- early exits (the paper's technique) ----
    early_exit: bool = True
    exit_layers: Tuple[int, ...] = ()    # () -> auto thirds; final exit implied

    # ---- numerics / runtime knobs ----
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    vocab_pad_multiple: int = 2048
    remat: str = "full"                  # none | dots | full
    tie_embeddings: bool = False

    # ---- sharding policy knobs (see sharding/specs.py) ----
    parallelism_mode: str = "tp"         # "tp" (Megatron TP x DP) | "pure_dp"
    fsdp: bool = False                   # shard params over data axis too
    seq_parallel: bool = False
    kv_shard_mode: str = "auto"          # auto | heads | sequence | batch
    kv_cache_dtype: str = "model"        # "model" (= cfg.dtype) | "int8"
    expert_parallel: bool = False        # shard experts over model axis
    ssm_head_shard: bool = False         # TP for SSD inner dims (heads)
    master_weights: bool = True          # fp32 adam master copy

    # -------------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: n_layers {self.n_layers} % period {len(self.pattern)}"
        return self.n_layers // len(self.pattern)

    @property
    def exit_layer_list(self) -> Tuple[int, ...]:
        """Exit positions in *period* units (exit sits after period i).

        The final output head is always present; ``exit_layers`` are the extra
        early exits.  Auto mode: two exits at 1/3 and 2/3 depth."""
        if not self.early_exit:
            return ()
        if self.exit_layers:
            return self.exit_layers
        p = self.n_periods
        marks = sorted({max(1, p // 3), max(1, (2 * p) // 3)} - {p})
        return tuple(m for m in marks if 0 < m < p)

    def reduced(self, **overrides) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        period = len(self.pattern)
        small = dict(
            name=self.name + "-smoke",
            n_layers=2 * period,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16 if self.n_heads else 0,
            n_experts=min(self.n_experts, 4),
            dense_residual_d_ff=64 if self.moe_dense_residual else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_chunk=32,
            sliding_window=16 if self.sliding_window else 0,
            n_patches=4 if self.frontend == "vision" else 0,
            vocab_pad_multiple=32,
            dtype="float32",
            remat="none",
            exit_layers=(1,),
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM-family architectures (seq_len, global_batch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
