"""Composable LM backbone: pattern-tiled layers, early exits, the
full-sequence forward, prefill and decode.

Port of ``repro/models/transformer.py``.  A model is ``n_periods``
repetitions of ``cfg.pattern`` (attention or Mamba-2 SSM mixers, each
followed by a dense SwiGLU, an MoE FFN or nothing); the parameters of all
periods are stacked on a leading axis, as in the reference, so a reference
parameter tree converts leaf by leaf (``convert.transformer_params_from``).
Early exits sit at period boundaries (``cfg.exit_layer_list``) and split
the stack into segments:

    embed -> periods[0:e1] -> exit_e1 -> periods[e1:e2] -> exit_e2 -> ...
          -> final norm -> LM head

Entry points:
  forward_train(params, cfg, batch)  -> {exit_name: [B, S, V_pad]} logits
  forward_hiddens(params, cfg, batch) -> {exit_name: normed hiddens}
  encode(params, cfg, batch)         -> final logits (encoder-only archs)
  prefill(params, cfg, batch, cache_len) -> (logits_last, caches)
  decode_step(params, cfg, tokens, caches, pos) -> (logits, caches, exits)
  loss_fn(params, cfg, batch)        -> the joint training loss

The reference scans a segment with ``lax.scan``; the port loops over the
periods, and each period reads views of the stacked parameters and caches
(the full-sequence forward takes them with one ``unbind`` a stack, see
``_periods``).  ``_remat`` is the reference's activation checkpointing,
through ``torch.utils.checkpoint`` around each period (and each layer for
``remat="layer"``), applied only where a gradient is taken; the recompute
runs under the sharding context that the forward saw.

Every entry point also runs over DTensors placed by
``sharding/specs.py`` (``launch.dryrun.place_inputs``) under
``activation_sharding(device_mesh)``: ``_sp_constraint``, the reference's
sequence-parallel (or pure-DP batch) constraint at layer boundaries,
redistributes the hidden states there.  On plain tensors it does nothing.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig, LayerSpec
from ..sharding.context import captured, current, entered
from ..sharding.dtensor import constrain, replicated
from . import attention as ATT
from . import moe as MOE
from . import ssm as SSM
from .early_exit import exit_head_apply, exit_head_init
from .layers import (chunked_cross_entropy, dtype_of, embed_apply,
                     embed_init, lm_head_apply, lm_head_init, mlp_apply,
                     mlp_init, rmsnorm, rmsnorm_init, scalar)


def _check_spec(cfg: ArchConfig, spec: LayerSpec) -> None:
    if spec.kind not in ("attn", "ssm"):
        raise ValueError(f"{cfg.name}: unknown layer kind {spec.kind!r}")
    if spec.mlp not in ("dense", "moe", "none"):
        raise ValueError(f"{cfg.name}: unknown MLP kind {spec.mlp!r}")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_set(stacked, tree, i: int) -> None:
    """``stacked[...][i] = tree[...]`` leaf by leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _tree_set(stacked[k], v, i)
    else:
        stacked[i].copy_(tree)


def _tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ArchConfig, spec: LayerSpec, dtype, device) -> dict:
    _check_spec(cfg, spec)
    p: dict = {"norm1": rmsnorm_init(cfg.d_model, dtype, device)}
    if spec.kind == "attn":
        p["mix"] = ATT.attn_init(gen, cfg, dtype, device)
    else:
        p["mix"] = SSM.ssm_init(gen, cfg, dtype, device)
    if spec.mlp != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["mlp"] = (mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
                    if spec.mlp == "dense"
                    else MOE.moe_init(gen, cfg, dtype, device))
    return p


def init_model(cfg: ArchConfig, *, seed: int = 0,
               device: DeviceLike = None) -> dict:
    """Random weights drawn from a seeded ``torch.Generator`` on ``device``
    (default ``cuda:0``), in the reference's tree and layouts.  On the
    ``meta`` device nothing is drawn or allocated: the tree holds the
    shapes and dtypes only (``runtime.steps.params_shapes``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if dev.type != "meta" else "cpu")
    gen.manual_seed(seed)
    dtype = dtype_of(cfg.dtype)
    params = {"embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                  dev)}
    # one period at a time into the stacked tensors: the peak is the
    # stack plus one period, not two stacks
    n = cfg.n_periods
    for p in range(n):
        period = {f"l{i}": _layer_init(gen, cfg, spec, dtype, dev)
                  for i, spec in enumerate(cfg.pattern)}
        if p == 0:
            params["layers"] = _tree_map(
                lambda x: x.new_empty((n,) + tuple(x.shape)), period)
        _tree_set(params["layers"], period, p)
        del period
        if dev.type == "meta":
            break       # shapes only: the other periods would draw nothing
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
# Period body (full sequence)
# ---------------------------------------------------------------------------

def _period(tree, p: int):
    """Views of period ``p`` of a stacked parameter or cache tree."""
    return _tree_map(lambda x: x[p], tree)


def _sp_spec(cfg: ArchConfig, shape: Tuple[int, ...]):
    """The spec ``_sp_constraint`` puts on hidden states of ``shape``
    under the current context, or None (left as they are)."""
    ctx = current()
    if ctx is None or len(shape) != 3:
        return None
    if cfg.parallelism_mode == "pure_dp":
        # ZeRO pitfall (the reference's): without an explicit batch
        # constraint the sharded weights stay in place and the batch is
        # replicated instead
        axes = ctx.dp_axes + ((ctx.model_axis,) if ctx.model_axis else ())
        n = ctx.dp_size * max(1, ctx.model_size)
        if not axes or shape[0] % n:
            return None
        return (axes, None, None)
    if not cfg.seq_parallel:
        return None
    if not ctx.model_axis or shape[1] % ctx.model_size:
        return None
    return (ctx.dp_axes, ctx.model_axis, None)


def _sp_constraint(cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Sequence parallelism: hidden states sharded on (batch = dp, seq =
    model) at layer boundaries (Megatron-SP: the tensor-parallel
    all-reduces become all-gather + reduce-scatter pairs, and the resident
    activations shrink by the model-axis size); under ``pure_dp`` the batch
    over every axis.  A DTensor is redistributed onto the context's mesh;
    without a context, or on a plain tensor, ``h`` is returned."""
    spec = _sp_spec(cfg, tuple(h.shape))
    return h if spec is None else constrain(h, spec)


def _one_layer(cfg: ArchConfig, spec: LayerSpec, p: dict, h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = _sp_constraint(cfg, h)
    hn = rmsnorm(p["norm1"], h, cfg.norm_eps)
    if spec.kind == "attn":
        h = h + ATT.attn_apply(p["mix"], cfg, hn, positions)
    else:
        h = h + SSM.ssm_apply(p["mix"], cfg, hn)
    if spec.mlp != "none":
        h = _sp_constraint(cfg, h)
    return _ffn(cfg, spec, p, h)


def _ffn(cfg: ArchConfig, spec: LayerSpec, p: dict, h: torch.Tensor
         ) -> torch.Tensor:
    """The layer's MLP half: dense SwiGLU, MoE, or nothing."""
    if spec.mlp == "none":
        return h
    hn = rmsnorm(p["norm2"], h, cfg.norm_eps)
    if spec.mlp == "dense":
        return h + mlp_apply(p["mlp"], hn)
    return h + MOE.moe_apply(p["mlp"], cfg, hn)


def _periods(stacked: dict) -> List[dict]:
    """Every period's parameter tree, each leaf taken from its stack by one
    ``unbind``: the backward of an ``unbind`` writes the stack's gradient
    once, where a select a period would build a zero tensor of the whole
    stack for each period."""
    n = _tree_leaves(stacked)[0].shape[0]
    parts = _tree_map(lambda x: x.unbind(0), stacked)
    return [_tree_map(lambda t: t[p], parts) for p in range(n)]


def _period_apply(cfg: ArchConfig, pp: dict, h: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    for i, spec in enumerate(cfg.pattern):
        fn = functools.partial(_one_layer, cfg, spec)
        if cfg.remat == "layer" and len(cfg.pattern) > 1:
            # a checkpoint a layer inside the period's: the backward of a
            # period keeps one layer's intermediates live
            fn = _checkpointed(fn)
        h = fn(pp[f"l{i}"], h, positions)
    return _sp_constraint(cfg, h)


def _checkpointed(fn, context_fn=None):
    """``fn`` under ``torch.utils.checkpoint`` (nothing saved inside but
    what ``context_fn``'s policy keeps) where a gradient is being taken,
    ``fn`` itself elsewhere.  The sharding context of the caller is taken
    now and entered around every run of ``fn``: the recompute may run on
    autograd's device thread, where the caller's context is not set."""
    kw = {} if context_fn is None else {"context_fn": context_fn}
    state = captured()

    def in_context(*args):
        with entered(state):
            return fn(*args)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(in_context, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return run


def _dot_ops() -> list:
    """The matmul operators whose outputs ``remat="dots"`` saves (the
    reference's ``checkpoint_dots``)."""
    aten = torch.ops.aten
    ops = [aten.mm.default, aten.bmm.default, aten.addmm.default]
    for op in (aten.mm, aten.bmm):
        if "dtype" in op.overloads():
            ops.append(op.dtype)
    return ops


def _remat(cfg: ArchConfig, fn):
    """Activation checkpointing of a period body, following ``cfg.remat``:
    ``none``; ``full`` / ``layer`` (nothing saved inside the period;
    ``layer`` adds per-layer checkpoints in ``_period_apply``); ``dots``
    (the matmul outputs saved, the rest recomputed)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat in ("full", "layer"):
        return _checkpointed(fn)
    if cfg.remat == "dots":
        return _checkpointed(fn, functools.partial(
            create_selective_checkpoint_contexts, _dot_ops()))
    raise ValueError(f"{cfg.name}: unknown remat policy {cfg.remat!r}")


def _run_segment(cfg: ArchConfig, periods: List[dict], a: int, b: int,
                 h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Periods [a, b) of ``_periods(params["layers"])``, in order, each
    under ``cfg.remat``."""
    body = _remat(cfg, functools.partial(_period_apply, cfg))
    for p in range(a, b):
        h = body(periods[p], h, positions)
    return h


# ---------------------------------------------------------------------------
# Embedding / frontend
# ---------------------------------------------------------------------------

def _embed_inputs(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    if cfg.frontend == "audio":
        # stub: precomputed frame embeddings [B, S, d]
        return batch["frames"]
    h = embed_apply(params["embed"], batch["tokens"].long())
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        P = batch["patch_embeds"].shape[1]
        h = torch.cat([batch["patch_embeds"].to(h.dtype), h[:, P:]], dim=1)
    return h


def _positions(h: torch.Tensor) -> torch.Tensor:
    B, S = h.shape[:2]
    return replicated(torch.arange(S, dtype=torch.int32, device=h.device),
                      h).expand(B, S)


# ---------------------------------------------------------------------------
# Full-sequence forward / encode
# ---------------------------------------------------------------------------

def forward_train(params, cfg: ArchConfig, batch: dict
                  ) -> Dict[str, torch.Tensor]:
    """Full forward; float32 logits at every exit and the final head,
    [B, S, V_pad].  ``batch``: {"tokens": [B, S]} (plus "patch_embeds"
    [B, n_patches, d] for a vision frontend), or {"frames": [B, S, d]}
    for an audio frontend."""
    h = _embed_inputs(params, cfg, batch)
    positions = _positions(h)
    head = _lm_head_params(params, cfg)
    periods = _periods(params["layers"])
    out: Dict[str, torch.Tensor] = {}
    for a, b in _segments(cfg):
        h = _run_segment(cfg, periods, a, b, h, positions)
        if b < cfg.n_periods:
            out[f"exit_{b}"] = exit_head_apply(params["exits"][f"exit_{b}"],
                                               cfg, h, head)
    hn = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    out["final"] = lm_head_apply(head, hn, cfg.vocab_size)
    return out


def encode(params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Encoder-only forward (hubert): final-layer frame logits."""
    return forward_train(params, cfg, batch)["final"]


def forward_hiddens(params, cfg: ArchConfig, batch: dict
                    ) -> Dict[str, torch.Tensor]:
    """Like ``forward_train`` but returns the *normed hidden states* per
    head instead of logits."""
    h = _embed_inputs(params, cfg, batch)
    positions = _positions(h)
    periods = _periods(params["layers"])
    out: Dict[str, torch.Tensor] = {}
    for a, b in _segments(cfg):
        h = _run_segment(cfg, periods, a, b, h, positions)
        if b < cfg.n_periods:
            ep = params["exits"][f"exit_{b}"]
            out[f"exit_{b}"] = rmsnorm(ep["norm"], h, cfg.norm_eps)
    out["final"] = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return out


def loss_fn(params, cfg: ArchConfig, batch: dict, *,
            exit_weight: float = 0.3, ce_chunk: int = 256) -> torch.Tensor:
    """BranchyNet-style joint loss: CE at the final head plus
    ``exit_weight`` times each exit's, over their weight sum.  ``batch``
    is ``forward_hiddens``'s plus "labels" [B, S] (-1: no label).  Uses
    ``chunked_cross_entropy``, so full-sequence logits never exist."""
    hiddens = forward_hiddens(params, cfg, batch)
    labels = batch["labels"]
    head = _lm_head_params(params, cfg)

    def head_w(name):
        if name == "final":
            return head["w"]
        ep = params["exits"][name]
        return ep["head"]["w"] if "head" in ep else head["w"]

    total = chunked_cross_entropy(hiddens["final"], head_w("final"), labels,
                                  cfg.vocab_size, chunk=ce_chunk)
    wsum = 1.0
    for name, hh in hiddens.items():
        if name != "final":
            total = total + exit_weight * chunked_cross_entropy(
                hh, head_w(name), labels, cfg.vocab_size, chunk=ce_chunk)
            wsum += exit_weight
    # a tensor divisor: a CUDA tensor over a Python scalar is a multiply by
    # its rounded reciprocal
    return total / scalar(wsum, total.device)


# ---------------------------------------------------------------------------
# KV / SSM caches
# ---------------------------------------------------------------------------

def _layer_cache_init(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      seq_len: int, dtype, device) -> Dict[str, torch.Tensor]:
    _check_spec(cfg, spec)
    if spec.kind == "attn":
        return ATT.cache_spec(cfg, batch, seq_len).init(dtype, device)
    return SSM.ssm_cache_init(cfg, batch, dtype, device)


def init_caches(cfg: ArchConfig, batch: int, seq_len: int, *,
                device: DeviceLike = None) -> dict:
    """Zeroed decode caches, stacked per period (the reference's layout:
    ``{"l<i>": {"k": [n_periods, B, T, KV, D], ..., "pos": [n_periods,
    T]}}`` for attention, ``{"state": [n_periods, B, H, P, N] float32,
    "conv": [n_periods, B, w-1, C]}`` for SSM layers)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    out = {}
    for i, spec in enumerate(cfg.pattern):
        one = _layer_cache_init(cfg, spec, batch, seq_len, dtype, dev)
        out[f"l{i}"] = _tree_map(
            lambda x: x.expand(cfg.n_periods, *x.shape).clone(), one)
    return out


def cache_shape_dtypes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """``init_caches``'s tree on the ``meta`` device (for the dry run)."""
    return init_caches(cfg, batch, seq_len, device="meta")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _period_decode(cfg: ArchConfig, pp: dict, h: torch.Tensor, cache: dict,
                   pos: int) -> torch.Tensor:
    for i, spec in enumerate(cfg.pattern):
        p = pp[f"l{i}"]
        hn = rmsnorm(p["norm1"], h, cfg.norm_eps)
        if spec.kind == "attn":
            y, _ = ATT.attn_decode_step(p["mix"], cfg, hn, cache[f"l{i}"],
                                        pos)
        else:
            y, _ = SSM.ssm_decode_step(p["mix"], cfg, hn, cache[f"l{i}"])
        h = _ffn(cfg, spec, p, h + y)
    return h


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, caches: dict,
                pos: int) -> Tuple[torch.Tensor, dict, Dict[str, torch.Tensor]]:
    """One decode step.  tokens: [B, 1] integer; pos: the 0-based index of
    the position being generated (an int); caches from ``init_caches`` or
    ``prefill``.

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
            h = _period_decode(cfg, _period(params["layers"], p), h,
                               _period(caches, p), pos)
        if b < cfg.n_periods:
            exits[f"exit_{b}"] = exit_head_apply(
                params["exits"][f"exit_{b}"], cfg, h, head)[:, 0]
    hn = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = lm_head_apply(head, hn, cfg.vocab_size)[:, 0]
    return logits, caches, exits


# ---------------------------------------------------------------------------
# Prefill (prompt -> caches)
# ---------------------------------------------------------------------------

def _attn_prefill(cfg: ArchConfig, p: dict, hn: torch.Tensor,
                  positions: torch.Tensor, cache_len: int, dtype
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One attention layer over the prompt, and its decode cache: the last
    min(S, T) positions' K/V at ring slots ``pos % T`` (a prompt longer
    than a sliding-window cache wraps), quantized for an int8 cache."""
    B, S = hn.shape[:2]
    q, k, v = ATT._project_qkv(p, cfg, hn, positions)
    o = ATT.chunked_attention(q, k, v, positions[0], positions[0],
                              causal=cfg.causal, window=cfg.sliding_window,
                              chunk=cfg.attn_chunk)
    y = ATT.out_proj(o, p["wo"])
    spec = ATT.cache_spec(cfg, B, cache_len)
    T = spec.max_len
    cache = spec.init(dtype, hn.device)
    take = min(S, T)
    src_pos = positions[0, S - take:]
    slots = (src_pos % T).long()
    k_tail, v_tail = k[:, S - take:], v[:, S - take:]
    if spec.quantized:
        kq, ks = ATT._quantize_kv(k_tail)
        vq, vs = ATT._quantize_kv(v_tail)
        cache["k"][:, slots] = kq
        cache["v"][:, slots] = vq
        cache["k_scale"][:, slots] = ks
        cache["v_scale"][:, slots] = vs
    else:
        cache["k"][:, slots] = k_tail.to(dtype)
        cache["v"][:, slots] = v_tail.to(dtype)
    cache["pos"][slots] = src_pos
    return y, cache


def prefill(params, cfg: ArchConfig, batch: dict, cache_len: int
            ) -> Tuple[torch.Tensor, dict]:
    """Run the prompt, building decode caches.  Returns (last-position
    final logits [B, V_pad] float32, caches stacked per period, as
    ``init_caches``).  The full-sequence forward is replayed layer by
    layer, keeping each attention layer's K/V and each SSM layer's final
    state and conv tail."""
    h = _embed_inputs(params, cfg, batch)
    positions = _positions(h)
    dtype = dtype_of(cfg.dtype)
    head = _lm_head_params(params, cfg)
    n = cfg.n_periods
    caches: dict = {}
    for per in range(n):
        pp = _period(params["layers"], per)
        for i, spec in enumerate(cfg.pattern):
            p = pp[f"l{i}"]
            hn = rmsnorm(p["norm1"], h, cfg.norm_eps)
            if spec.kind == "attn":
                y, cache = _attn_prefill(cfg, p["mix"], hn, positions,
                                         cache_len, dtype)
            else:
                y, cache = SSM.ssm_apply_with_state(p["mix"], cfg, hn)
            if per == 0:
                caches[f"l{i}"] = _tree_map(
                    lambda x: x.new_empty((n,) + tuple(x.shape)), cache)
            _tree_set(caches[f"l{i}"], cache, per)
            h = _ffn(cfg, spec, p, h + y)
    hn = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = lm_head_apply(head, hn[:, -1:], cfg.vocab_size)[:, 0]
    return logits, caches
