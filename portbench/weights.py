"""Seeded weights in the program's parameter layout.

The program's ``init_model`` on the ``meta`` device gives the tree's paths,
shapes and dtypes and draws nothing.  The benchmark fills that tree from
its own ``torch.Generator`` on the run's device, in a few large calls: one
normal draw for every half-precision matrix (the leaves are views of one
buffer, each 256-byte aligned), one for the float32 matrices, and fills
for the rest.  Each matrix is scaled by 1 / sqrt(fan_in), the layout's
input width.  The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ONES = ("scale", "D")
ZEROS = ("conv_b", "A_log", "dt_bias")
_ALIGN = 128                       # elements: 256 B in bf16, 512 B in f32


def fan_in(name: str, shape: Tuple[int, ...]) -> int:
    """The input width of a matrix leaf of the program's layout (a leading
    period axis, where there is one, does not count)."""
    if name == "table":                      # embedding [V, d]
        return shape[-1]
    if name == "wo":                         # [H, hd, d]
        return shape[-3] * shape[-2]
    if name in ("wq", "wk", "wv"):           # [d, H, hd]
        return shape[-3]
    return shape[-2]                         # [..., in, out]


def _leaves(tree: dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _set(tree: dict, path: str, value: torch.Tensor) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = value


def make_params(meta_tree: dict, seed: int, device: torch.device) -> dict:
    """Fill the program's ``meta`` parameter tree from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    tree = _copy_structure(meta_tree)
    groups: Dict[torch.dtype, List[Tuple[str, tuple]]] = {}
    for path, leaf in _leaves(meta_tree):
        name = path.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        if name in ONES:
            _set(tree, path, torch.ones(shape, dtype=leaf.dtype,
                                        device=device))
        elif name in ZEROS:
            _set(tree, path, torch.zeros(shape, dtype=leaf.dtype,
                                         device=device))
        else:
            groups.setdefault(leaf.dtype, []).append((path, shape))
    for dtype, leaves in groups.items():
        sizes = [math.prod(s) for _, s in leaves]
        offs, total = [], 0
        for n in sizes:
            offs.append(total)
            total += -(-n // _ALIGN) * _ALIGN
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        for (path, shape), off, n in zip(leaves, offs, sizes):
            w = flat[off:off + n].view(shape)
            w.mul_(1.0 / math.sqrt(fan_in(path.rsplit("/", 1)[-1], shape)))
            _set(tree, path, w)
    return tree


def _copy_structure(tree: dict) -> dict:
    return {k: _copy_structure(v) if isinstance(v, dict) else None
            for k, v in tree.items()}
