"""LM backbone for decoding: pattern-tiled layers with early exits.

Port of the decode path of ``repro/models/transformer.py``.  A model is
``n_periods`` repetitions of ``cfg.pattern``; the parameters of all periods
are stacked on a leading axis, as in the reference, so a reference
parameter tree converts leaf by leaf (``convert.transformer_params_from``).
Early exits sit at period boundaries (``cfg.exit_layer_list``) and split
the stack into segments:

    embed -> periods[0:e1] -> exit_e1 -> periods[e1:e2] -> exit_e2 -> ...
          -> final norm -> LM head

Entry points: ``init_model``, ``init_caches``, ``decode_step``.  The
reference scans a segment with ``lax.scan``; the port loops over the
periods, and each period reads views of the stacked parameters and caches.
This slice builds attention layers with dense SwiGLU MLPs; the SSM and MoE
layers, ``prefill`` and the training forward belong to later slices.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig, LayerSpec
from . import attention as ATT
from .early_exit import exit_head_apply, exit_head_init
from .layers import (dtype_of, embed_apply, embed_init, lm_head_apply,
                     lm_head_init, mlp_apply, mlp_init, rmsnorm, rmsnorm_init)


def _check_spec(cfg: ArchConfig, spec: LayerSpec) -> None:
    if spec.kind == "ssm":
        raise ValueError(f"{cfg.name}: SSM layers (models/ssm.py) are not "
                         f"ported yet; they come with a later slice of the "
                         f"port (training and the remaining layer kinds)")
    if spec.kind != "attn":
        raise ValueError(f"{cfg.name}: unknown layer kind {spec.kind!r}")
    if spec.mlp == "moe":
        raise ValueError(f"{cfg.name}: MoE layers (models/moe.py) are not "
                         f"ported yet; they come with a later slice of the "
                         f"port (training and the remaining layer kinds)")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_stack(trees: List[dict]) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ArchConfig, spec: LayerSpec, dtype, device) -> dict:
    p: dict = {"norm1": rmsnorm_init(cfg.d_model, dtype, device),
               "mix": ATT.attn_init(gen, cfg, dtype, device)}
    if spec.mlp != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def init_model(cfg: ArchConfig, *, seed: int = 0,
               device: DeviceLike = None) -> dict:
    """Random weights drawn from a seeded ``torch.Generator`` on ``device``
    (default ``cuda:0``), in the reference's tree and layouts."""
    if not cfg.has_decoder:
        raise ValueError(f"{cfg.name} is encoder-only: the port serves "
                         f"decoder models only")
    for spec in cfg.pattern:
        _check_spec(cfg, spec)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = dtype_of(cfg.dtype)
    params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                  dev)}
    periods = [{f"l{i}": _layer_init(gen, cfg, spec, dtype, dev)
                for i, spec in enumerate(cfg.pattern)}
               for _ in range(cfg.n_periods)]
    params["layers"] = _tree_stack(periods)
    del periods
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, dev)
    params["exits"] = {}
    if not cfg.tie_embeddings:
        params["lm_head"] = lm_head_init(gen, cfg.d_model, cfg.padded_vocab,
                                         dtype, dev)
    for p_idx in cfg.exit_layer_list:
        params["exits"][f"exit_{p_idx}"] = exit_head_init(gen, cfg, dtype,
                                                          dev, tied=True)
    return params


def _lm_head_params(params, cfg: ArchConfig) -> dict:
    if cfg.tie_embeddings:
        return {"w": params["embed"]["table"].T}
    return params["lm_head"]


def tree_to(tree: dict, device: DeviceLike) -> dict:
    """A copy of a parameter (or cache) tree on another device."""
    dev = resolve_device(device)
    return _tree_map(lambda x: x.to(dev), tree)


def param_count(params) -> int:
    return sum(x.numel() for x in _tree_leaves(params))


def _segments(cfg: ArchConfig) -> List[Tuple[int, int]]:
    bounds = [0] + list(cfg.exit_layer_list) + [cfg.n_periods]
    return list(zip(bounds[:-1], bounds[1:]))


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, seq_len: int, *,
                device: DeviceLike = None) -> dict:
    """Zeroed decode caches, stacked per period (the reference's layout:
    ``{"l<i>": {"k": [n_periods, B, T, KV, D], ..., "pos": [n_periods,
    T]}}``)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    out = {}
    for i, spec in enumerate(cfg.pattern):
        _check_spec(cfg, spec)
        one = ATT.cache_spec(cfg, batch, seq_len).init(dtype, dev)
        out[f"l{i}"] = _tree_map(
            lambda x: x.expand(cfg.n_periods, *x.shape).clone(), one)
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _period_decode(cfg: ArchConfig, pp: dict, h: torch.Tensor, cache: dict,
                   pos: int) -> torch.Tensor:
    for i, spec in enumerate(cfg.pattern):
        p = pp[f"l{i}"]
        hn = rmsnorm(p["norm1"], h, cfg.norm_eps)
        y, _ = ATT.attn_decode_step(p["mix"], cfg, hn, cache[f"l{i}"], pos)
        h = h + y
        if spec.mlp != "none":
            hn = rmsnorm(p["norm2"], h, cfg.norm_eps)
            h = h + mlp_apply(p["mlp"], hn)
    return h


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, caches: dict,
                pos: int) -> Tuple[torch.Tensor, dict, Dict[str, torch.Tensor]]:
    """One decode step.  tokens: [B, 1] integer; pos: the 0-based index of
    the position being generated (an int); caches from ``init_caches``.

    Returns (final logits [B, V_pad] float32, caches, exit logits {name:
    [B, V_pad]}).  The caches are updated in place and returned (the
    reference returns new arrays).
    """
    if not cfg.has_decoder:
        raise ValueError(f"{cfg.name} is encoder-only")
    h = embed_apply(params["embed"], tokens.long())
    head = _lm_head_params(params, cfg)
    exits: Dict[str, torch.Tensor] = {}
    for a, b in _segments(cfg):
        for p in range(a, b):
            h = _period_decode(cfg, _tree_map(lambda x: x[p], params["layers"]),
                               h, _tree_map(lambda x: x[p], caches), pos)
        if b < cfg.n_periods:
            exits[f"exit_{b}"] = exit_head_apply(
                params["exits"][f"exit_{b}"], cfg, h, head)[:, 0]
    hn = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = lm_head_apply(head, hn, cfg.vocab_size)[:, 0]
    return logits, caches, exits
