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
CUDA-graph decode step is queued on its own, ROADMAP B.3).  The train
step takes the gradient of ``loss_fn`` with ``torch.autograd.grad``
(TF32 off, so float32 models compute in float32), clips it to a global
norm and applies AdamW in place: the state it returns holds the tensors
it was given, updated.

``input_specs(cfg, shape)`` is the dry run's contract: every input of the
cell's step (``step_for``) as a tensor on the ``meta`` device, whose
``.shape`` and ``.dtype`` read as a ``ShapeDtypeStruct``'s do.  Nothing is
drawn and nothing is allocated, even for the 480B-parameter arctic.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .._device import DeviceLike
from ..configs.base import ArchConfig, ShapeSpec
from ..models import transformer as T
from ..models.layers import dtype_of, no_tf32
from ..optim import AdamW, clip_by_global_norm
from ..optim.adamw import tree_leaves
from ..sharding.dtensor import is_dtensor


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
    ``jax.grad`` gives.  A DTensor parameter's gradient comes in its
    placements (a data-parallel partial sum is reduced here)."""
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
    grads = [g.redistribute(x.device_mesh, x.placements)
             if is_dtensor(x) and g.placements != x.placements else g
             for x, g in zip(leaves, grads)]
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


def train_state_shapes(cfg: ArchConfig) -> dict:
    """The train state of ``init_train_state`` on the ``meta`` device: the
    AdamW state of ``make_optimizer(cfg)`` over meta parameters."""
    return init_train_state(cfg, device="meta")


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


def params_shapes(cfg: ArchConfig) -> dict:
    """``init_model``'s tree on the ``meta`` device (nothing drawn)."""
    return T.init_model(cfg, device="meta")


# ---------------------------------------------------------------------------
# input_specs: meta tensors per (arch x shape) cell
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.dtype)
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "audio":
        specs["frames"] = _spec((B, S, cfg.d_model), dt)
    else:
        specs["tokens"] = _spec((B, S), torch.int32)
        if cfg.frontend == "vision":
            specs["patch_embeds"] = _spec((B, cfg.n_patches, cfg.d_model),
                                          dt)
    specs["labels"] = _spec((B, S), torch.int32)
    return specs


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """All step inputs as meta tensors, keyed by step argument."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"state": train_state_shapes(cfg),
                "batch": batch_specs(cfg, B, S)}
    if shape.kind == "prefill":
        b = batch_specs(cfg, B, S)
        b.pop("labels")
        return {"params": params_shapes(cfg), "batch": b}
    if shape.kind == "decode":
        if not cfg.has_decoder:
            raise ValueError(f"{cfg.name} is encoder-only: no decode cell")
        return {
            "params": params_shapes(cfg),
            "caches": T.cache_shape_dtypes(cfg, B, S),
            "tokens": _spec((B, 1), torch.int32),
            "pos": _spec((), torch.int32),
        }
    raise ValueError(shape.kind)


def step_for(cfg: ArchConfig, shape: ShapeSpec):
    """(callable, ordered argnames) for the cell's step function."""
    if shape.kind == "train":
        return build_train_step(cfg), ("state", "batch")
    if shape.kind == "prefill":
        if not cfg.has_decoder:
            return build_encode_step(cfg), ("params", "batch")

        def prefill_logits(params, batch):
            # prefill as the pure forward (the cache write-back variant is
            # the runtime engine's; the shapes are the same)
            return T.forward_train(params, cfg, batch)["final"][:, -1]
        return prefill_logits, ("params", "batch")
    if shape.kind == "decode":
        return build_serve_step(cfg), ("params", "caches", "tokens", "pos")
    raise ValueError(shape.kind)
