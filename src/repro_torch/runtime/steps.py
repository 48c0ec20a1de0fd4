"""Train / serve step builders: plain callables over the model's entry
points.

Port of ``repro/runtime/steps.py``:

``build_train_step(cfg)``   -> step(state, batch) -> (state, metrics)
``init_train_state(cfg)``   -> {"params", "opt"}
``build_serve_step(cfg)``   -> step(params, caches, tokens, pos) -> (logits,
                               caches, exit_logits)
``build_encode_step(cfg)``  -> step(params, batch) -> logits (encoder-only)
``build_prefill_step(cfg, cache_len)`` -> step(params, batch) -> (logits,
                               caches)

The reference jits these; the port calls the eager functions (a
CUDA-graph decode step is queued on its own, ROADMAP A.5).  The train
step takes the gradient of ``loss_fn`` with ``torch.autograd.grad``
(TF32 off, so float32 models compute in float32), clips it to a global
norm and applies AdamW in place: the state it returns holds the tensors
it was given, updated.  ``train_state_shapes``, ``params_shapes``,
``batch_specs``, ``input_specs`` and ``step_for`` are the dry run's
contract and wait for the shape cells (ROADMAP A.6).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .._device import DeviceLike
from ..configs.base import ArchConfig
from ..models import transformer as T
from ..models.layers import no_tf32
from ..optim import AdamW, clip_by_global_norm
from ..optim.adamw import tree_leaves


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def make_optimizer(cfg: ArchConfig) -> AdamW:
    return AdamW(lr=3e-4,
                 state_dtype=None if cfg.master_weights else "bfloat16")


def _unflatten_like(tree, leaves):
    """``tree``'s dict structure with ``leaves`` in its flatten order."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def value_and_grad(loss, params, *args, **kw
                   ) -> Tuple[torch.Tensor, Dict]:
    """(``loss(params, ...)``, its gradient as a tree like ``params``),
    with TF32 off; a parameter the loss does not read gets zeros, as
    ``jax.grad`` gives."""
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    try:
        with no_tf32():
            value = loss(params, *args, **kw)
            grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                        materialize_grads=True)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    return value.detach(), _unflatten_like(params, iter(grads))


def build_train_step(cfg: ArchConfig, *, clip_norm: float = 1.0):
    opt = make_optimizer(cfg)

    def train_step(state: dict, batch: dict) -> Tuple[dict, dict]:
        params, opt_state = state["params"], state["opt"]
        loss, grads = value_and_grad(
            lambda p: T.loss_fn(p, cfg, batch), params)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, inplace=True)
        new_params, new_opt = opt.update(grads, opt_state, params)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt.step}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(cfg: ArchConfig, *, seed: int = 0,
                     device: DeviceLike = None) -> dict:
    """Seeded parameters (``init_model``) and zeroed AdamW moments on
    ``device`` (default ``cuda:0``)."""
    params = T.init_model(cfg, seed=seed, device=device)
    return {"params": params, "opt": make_optimizer(cfg).init(params)}


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------

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
