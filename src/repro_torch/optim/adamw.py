"""AdamW over trees of tensors, with optional bf16 moments and the
gradient-compression hooks.

Port of ``repro/optim/adamw.py``.  A tree is nested dicts (and lists) of
tensors; leaves are visited in the reference's flatten order (sorted dict
keys), which fixes the order of ``global_norm``'s sum.

The arithmetic is the reference's, in float32: the bias corrections
``1 - b ** step`` and the schedule are float32 tensors on the leaves'
device (a host float64 would differ in the last bit), and a Python
constant meets a float32 tensor as the reference's weakly typed constant
does, rounded to float32.  A division is tensor by tensor: PyTorch
computes ``scalar / tensor`` and a CUDA ``tensor / scalar`` through a
rounded reciprocal.

Unlike the reference, ``AdamW.update`` writes the new parameters and
moments into the tensors it is given and returns them: a functional update
would hold two copies of the state, about 49 GB more at qwen3-4b.

On CUDA leaves the global norm and the clip scale are the kernel B12 and
the update the kernel B13 (``kernels/adamw``), each one launch over the
whole tree; ``clip_and_update`` is the train step's clip and update as one
B12 and one B13 launch, the clip folded into the update's load.  On CPU
leaves they run the kernels' plain versions (``kernels/adamw/ref.py``),
which update a leaf over pieces of at most ``PIECE`` elements; the results
do not change.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..kernels.adamw.ops import adamw_update, global_norm_scale
from ..kernels.adamw.ref import PIECE, AdamWConsts, OverRanks, pieces

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor         # scalar int32
    mu: dict                   # first moment (tree like params)
    nu: dict                   # second moment


def tree_leaves(tree) -> list:
    """Leaves in the reference's flatten order: sorted dict keys, list
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees shaped like it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _local(x):
    """A DTensor's local shard; any other value itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def _sum_over_ranks(v: torch.Tensor, like) -> torch.Tensor:
    """``v``, this rank's share of a sum over the elements of ``like``,
    summed over the mesh when ``like`` is a DTensor (a shard adds every
    rank's share, a replica counts once)."""
    if not isinstance(like, DTensor):
        return v
    if any(p.is_partial() for p in like.placements):
        raise ValueError("a partial DTensor has no sum of squares of its "
                         "own: redistribute it first")
    placements = [Partial() if p.is_shard() else Replicate()
                  for p in like.placements]
    return DTensor.from_local(v, like.device_mesh, placements,
                              run_check=False).full_tensor()


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=F32, device=like.device)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    #: float32 moments by default; bf16 halves optimizer memory at the cost
    #: of moment precision
    state_dtype: Optional[str] = None
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def _sdtype(self) -> torch.dtype:
        if self.state_dtype is None:
            return F32
        return {"bfloat16": torch.bfloat16, "float32": F32}[self.state_dtype]

    def init(self, params) -> AdamWState:
        dt = self._sdtype()
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        dev = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def consts(self) -> AdamWConsts:
        return AdamWConsts(self.b1, self.b2, self.eps, self.weight_decay)

    def scalars(self, step: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(lr with the schedule, 1 - b1^step, 1 - b2^step): float32 0-dim
        tensors on the step's device."""
        s = _local(step).to(F32)
        lr = (_const(self.lr, s) if self.schedule is None
              else self.lr * self.schedule(_local(step)))
        return lr, 1.0 - self.b1 ** s, 1.0 - self.b2 ** s

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[dict, AdamWState]:
        """One AdamW step; ``params`` and the moments are updated in place
        and returned with the new step."""
        gs = tree_leaves(grads)
        return self._apply(_shards(gs, [_kernel_local(g) for g in gs], state,
                                   params), state, params, None)

    def _apply(self, shards, state: AdamWState, params, scale
               ) -> Tuple[dict, AdamWState]:
        step = state.step + 1
        adamw_update(*shards, *self.scalars(step), self.consts(), scale)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def _kernel_local(x):
    """A leaf's local tensor, contiguous where it lies on a card: the
    kernels walk memory in order (a convolution's weight gradient may come
    in the channels-last layout)."""
    x = _local(x)
    return x.contiguous() if x.is_cuda else x


def _shards(gs, g_local, state: AdamWState, params):
    """[the local tensors of the gradients in their parameters'
    placements, of the first moments, second moments and parameters], in
    flatten order; ``gs`` are the gradient leaves and ``g_local`` their
    local tensors."""
    ps = tree_leaves(params)
    moved = [_kernel_local(g.redistribute(p.device_mesh, p.placements))
             if isinstance(p, DTensor) and g.placements != p.placements
             else x for g, x, p in zip(gs, g_local, ps)]
    return [moved] + [[_local(x) for x in xs]
                      for xs in (tree_leaves(state.mu), tree_leaves(state.nu),
                                 ps)]


def _over_ranks(leaves) -> Optional[OverRanks]:
    """Each leaf's local sum of squares summed over the mesh, for a tree
    that holds DTensors; None for plain tensors."""
    if not any(isinstance(x, DTensor) for x in leaves):
        return None
    return lambda i, v: _sum_over_ranks(v, leaves[i])


def _norm_and_scale(tree, max_norm: float):
    leaves = tree_leaves(tree)
    return global_norm_scale([_kernel_local(x) for x in leaves], max_norm,
                             _over_ranks(leaves))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' squared sums, in flatten order."""
    return _norm_and_scale(tree, 1.0)[0]


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, *, inplace: bool = False):
    """(the tree scaled to a global norm of at most ``max_norm``, the
    norm), computed a piece at a time; a new tree, or ``tree`` itself
    scaled in place with ``inplace=True``."""
    n, scale = _norm_and_scale(tree, max_norm)

    def clip(x):
        out = x if inplace else torch.empty_like(x)
        for px, po in zip(pieces(_local(x)), pieces(_local(out))):
            po.copy_(px.to(F32) * scale)
        return out

    return tree_map(clip, tree), n


@torch.no_grad()
def clip_and_update(opt: AdamW, grads, state: AdamWState, params,
                    max_norm: float) -> Tuple[dict, AdamWState, torch.Tensor]:
    """The train step's ``clip_by_global_norm(grads, max_norm,
    inplace=True)`` followed by ``opt.update``, with the clip folded into
    the update's load: (params, state, the gradients' norm), the bits of
    the two calls, and the gradients are not written.  On CUDA leaves one
    B12 launch (the norm and the scale, on the gradients' own placements
    as ``clip_by_global_norm`` takes it) and one B13 launch; on CPU
    leaves their plain versions."""
    gs = tree_leaves(grads)
    g_local = [_kernel_local(g) for g in gs]
    n, scale = global_norm_scale(g_local, max_norm, _over_ranks(gs))
    params, state = opt._apply(_shards(gs, g_local, state, params), state,
                               params, scale)
    return params, state, n


def cosine_schedule(warmup: int, total: int) -> Callable:
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(F32)
        warm = torch.clamp(s / _const(max(1, warmup), s), max=1.0)
        prog = torch.clamp((s - warmup) / _const(max(1, total - warmup), s),
                           0.0, 1.0)
        return warm * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return fn


# ---------------------------------------------------------------------------
# Gradient compression: applied before a data-parallel all-reduce, bf16
# halves the collective's bytes and int8 with a per-tensor scale quarters
# them.
# ---------------------------------------------------------------------------

def compress_grads(grads, mode: str):
    if mode == "none":
        return grads
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads)
    if mode == "int8":
        def q(g):
            gf = g.to(F32)
            scale = torch.clamp(gf.abs().max(), min=1e-12) / _const(127.0, gf)
            return (torch.round(gf / scale).to(torch.int8), scale)
        return tree_map(q, grads)
    raise ValueError(mode)


def decompress_grads(grads, mode: str):
    if mode in ("none", "bf16"):
        return grads
    if mode == "int8":
        return tree_map(lambda t: t[0].to(F32) * t[1], grads)
    raise ValueError(mode)
