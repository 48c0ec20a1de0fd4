"""Carry scenario and model state across: build the port's host objects
and model parameters from plain fields (numpy arrays and Python scalars).

Another implementation's ``Network``, ``DNNProfile``, ``AppRequirements``
or ``Config`` is handed over field by field, so both solve the same
scenario; nothing here imports that implementation.  Arrays are copied as
float64, so the port's graphs are built from byte-equal inputs.  A
transformer's parameter tree (nested mappings of numpy arrays) becomes the
port's parameters leaf by leaf (``transformer_params_from``), and a
branchy CNN's becomes its module state (``branchy_params_from``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .core.dnn_profile import DNNProfile, ExitSpec
from .core.problem import AppRequirements, Config
from .core.system_model import Network, NodeSpec

_NODE_FIELDS = ("name", "tier", "compute_ops", "power_active", "power_idle",
                "link_bps", "e_tx", "e_rx")
_EXIT_FIELDS = ("block", "ops", "out_bits", "accuracy", "phi")


def network_from_arrays(bandwidth, compute, source_node: int,
                        nodes: Sequence[Mapping]) -> Network:
    """``nodes``: one mapping per node with the ``NodeSpec`` fields."""
    specs = [NodeSpec(**{f: nd[f] for f in _NODE_FIELDS}) for nd in nodes]
    return Network(nodes=specs,
                   bandwidth=np.array(bandwidth, dtype=np.float64),
                   compute=np.array(compute, dtype=np.float64),
                   source_node=int(source_node))


def profile_from_arrays(name: str, input_bits: float,
                        block_ops: Sequence[float], cut_bits: Sequence[float],
                        exits: Sequence[Mapping]) -> DNNProfile:
    """``exits``: one mapping per exit with the ``ExitSpec`` fields."""
    return DNNProfile(
        name=name, input_bits=input_bits,
        block_ops=[float(x) for x in block_ops],
        cut_bits=list(cut_bits),
        exits=[ExitSpec(**{f: ex[f] for f in _EXIT_FIELDS}) for ex in exits])


def requirements_from(alpha: float, delta: float,
                      sigma: float = 1.0) -> AppRequirements:
    return AppRequirements(alpha=float(alpha), delta=float(delta),
                           sigma=float(sigma))


def config_from(placement: Sequence[int], final_exit: int) -> Config:
    return Config(placement=[int(p) for p in placement],
                  final_exit=int(final_exit))


def node_fields(node) -> dict:
    """The ``NodeSpec`` fields of any object that has them."""
    return {f: getattr(node, f) for f in _NODE_FIELDS}


def exit_fields(ex) -> dict:
    """The ``ExitSpec`` fields of any object that has them."""
    return {f: getattr(ex, f) for f in _EXIT_FIELDS}


def network_from(nw) -> Network:
    """The port's ``Network`` from any object with the same fields."""
    return network_from_arrays(nw.bandwidth, nw.compute, nw.source_node,
                               [node_fields(n) for n in nw.nodes])


def profile_from(pf) -> DNNProfile:
    """The port's ``DNNProfile`` from any object with the same fields."""
    return profile_from_arrays(pf.name, pf.input_bits, pf.block_ops,
                               pf.cut_bits, [exit_fields(e) for e in pf.exits])


def scenarios_from(profiles: Sequence, networks: Sequence,
                   requirements: Sequence, memo: Optional[dict] = None):
    """Parallel scenario lists carried across.  Objects shared between
    scenarios stay shared (the batched solver dedupes on identity); ``memo``
    keeps that sharing across calls."""
    memo = {} if memo is None else memo

    def once(x, fn):
        key = id(x)
        if key not in memo:
            memo[key] = (x, fn(x))       # keep x alive: ids stay unique
        return memo[key][1]

    return ([once(p, profile_from) for p in profiles],
            [once(n, network_from) for n in networks],
            [requirements_from(r.alpha, r.delta, r.sigma)
             for r in requirements])


def _tensor_from(x, device) -> torch.Tensor:
    """A numpy array (float32, int, or ml_dtypes bfloat16) as a tensor."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _layer_skeleton(cfg) -> dict:
    """The port's layer tree of one period of ``cfg``'s pattern, on the
    ``meta`` device (shapes only: nothing is drawn or allocated; only its
    keys are read)."""
    from .models.transformer import _layer_init
    gen = torch.Generator()
    return {f"l{i}": _layer_init(gen, cfg, spec, torch.float32, "meta")
            for i, spec in enumerate(cfg.pattern)}


def _kind(x) -> str:
    return "a subtree" if isinstance(x, Mapping) else "a leaf"


def _check_keys(tree: Mapping, want: Mapping, where: str) -> None:
    if set(tree) != set(want):
        raise ValueError(f"parameter tree keys {sorted(tree)} at {where} "
                         f"differ from {sorted(want)}")
    for k, v in want.items():
        if _kind(v) != _kind(tree[k]):
            raise ValueError(f"parameter tree keys: {where}/{k} is "
                             f"{_kind(tree[k])}, the port reads {_kind(v)}")
        if isinstance(v, Mapping):
            _check_keys(tree[k], v, f"{where}/{k}")


def transformer_params_from(params_np: Mapping, cfg, *,
                            device: DeviceLike = None) -> dict:
    """The port's transformer parameters from another implementation's
    parameter tree, given as nested mappings of numpy arrays, on
    ``device`` (``None``: ``cuda:0``, raising without a card).

    Both trees share names and layouts: per-period layer stacks
    ``[n_periods, ...]``, ``wq`` ``[d, H, hd]``, ``wo`` ``[H, hd, d]``, the
    SSM mixers' ``in_proj`` / ``conv_w`` / ``A_log`` / ``D`` / ``dt_bias``,
    the MoE ``router`` ``[d, E]`` and experts ``[E, ...]``, exits keyed
    ``exit_{period}``, so each leaf is copied as it is (dtype kept: the
    SSM decay and skip terms and the router stay float32 in a bf16 tree).
    Keys the port's model does not read raise ``ValueError``, at every
    level of a layer.
    """
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, Mapping):
            return {k: conv(v) for k, v in tree.items()}
        return _tensor_from(tree, dev)

    expect = {"embed", "layers", "final_norm", "exits"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(params_np) != expect:
        raise ValueError(f"parameter tree keys {sorted(params_np)} differ "
                         f"from {sorted(expect)} of {cfg.name}")
    want_exits = {f"exit_{p}" for p in cfg.exit_layer_list}
    if set(params_np["exits"]) != want_exits:
        raise ValueError(f"exit heads {sorted(params_np['exits'])} differ "
                         f"from {sorted(want_exits)}")
    _check_keys(params_np["layers"], _layer_skeleton(cfg), "layers")
    out = conv(params_np)
    for leaf in out["layers"].values():
        n = leaf["norm1"]["scale"].shape[0]
        if n != cfg.n_periods:
            raise ValueError(f"layer stacks hold {n} periods, {cfg.name} "
                             f"has {cfg.n_periods}")
    return out


def _cnn_layer_state(tree: Mapping, prefix: str, device, out: dict) -> None:
    """One CNN layer's reference parameters into ``out`` under the port's
    state-dict names: a ``{w, b}`` layer (HWIO convolution weights become
    OIHW, ``[in, out]`` dense weights ``[out, in]``), a residual block's
    ``{c1, c2[, proj]}``, or ``{}``."""
    if "w" not in tree:
        for k in sorted(tree):
            _cnn_layer_state(tree[k], f"{prefix}{k}.", device, out)
        return
    w = _tensor_from(tree["w"], device)
    out[prefix + "w"] = (w.permute(3, 2, 0, 1) if w.dim() == 4
                         else w.t()).contiguous()
    out[prefix + "b"] = _tensor_from(tree["b"], device)


def branchy_params_from(model, tree: Mapping, *,
                        device: DeviceLike = None) -> dict:
    """A ``BranchyModel``'s state dict from another implementation's
    parameter tree (numpy arrays): ``{"blocks": [[layer, ...], ...],
    "exits": {"<block>": [layer, ...]}}``, a layer ``{"w", "b"}`` (HWIO
    convolutions, ``[in, out]`` dense), ``{"c1", "c2"[, "proj"]}`` for a
    residual block or ``{}``.  Load it with ``model.load_state_dict``
    after ``model.init``, which refuses a key or a shape the model does
    not have; tensors land on ``device`` (``None``: ``cuda:0``, raising
    without a card)."""
    dev = resolve_device(device)
    blocks, exits = tree["blocks"], tree["exits"]
    if len(blocks) != len(model.blocks) or \
            set(exits) != {str(b) for b in model.exit_blocks()}:
        raise ValueError(f"parameter tree has {len(blocks)} blocks and exits "
                         f"{sorted(exits)}; {model.name} has "
                         f"{len(model.blocks)} and {model.exit_blocks()}")
    out: dict = {}
    heads = [(f"blocks.{i}.", blk) for i, blk in enumerate(blocks)]
    heads += [(f"exits.{b}.", exits[b]) for b in exits]
    for prefix, layers in heads:
        for j, p in enumerate(layers):
            _cnn_layer_state(p, f"{prefix}layers.{j}.", dev, out)
    return out
