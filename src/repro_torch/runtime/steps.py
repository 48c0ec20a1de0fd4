"""Serve-step builders: plain callables over the model's entry points.

Port of the serving half of ``repro/runtime/steps.py``:

``build_serve_step(cfg)``   -> step(params, caches, tokens, pos) -> (logits,
                               caches, exit_logits)
``build_encode_step(cfg)``  -> step(params, batch) -> logits (encoder-only)
``build_prefill_step(cfg, cache_len)`` -> step(params, batch) -> (logits,
                               caches)

The reference jits these; the port calls the eager functions (a
CUDA-graph decode step is queued on its own, ROADMAP A.5).  The train
builders, ``params_shapes``, ``batch_specs``, ``input_specs`` and
``step_for`` need the optimizer and the shape cells, and come with
training (ROADMAP A.6).
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..models import transformer as T


def build_serve_step(cfg: ArchConfig):
    def serve_step(params, caches, tokens, pos):
        return T.decode_step(params, cfg, tokens, caches, pos)
    return serve_step


def build_encode_step(cfg: ArchConfig):
    def encode_step(params, batch):
        return T.encode(params, cfg, batch)
    return encode_step


def build_prefill_step(cfg: ArchConfig, cache_len: int):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch, cache_len=cache_len)
    return prefill_step
