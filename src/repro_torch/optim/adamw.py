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
would hold two copies of the state, about 49 GB more at qwen3-4b.  Every
per-leaf computation is elementwise, so it runs over pieces of a leaf (at
most ``PIECE`` elements for the device, cut along the leading axis: a
period of a stacked leaf, a block of embedding rows), keeping the float32
temporaries to a piece rather than seven copies of the largest leaf; the
results do not change.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import torch

F32 = torch.float32
#: elements of the largest piece a leaf is updated in, by device type: few
#: launches a piece on a card; on the CPU, pieces whose float32
#: temporaries stay in cache and in the allocator's reused memory, which
#: runs the update several times faster than large fresh buffers
PIECE = {"cuda": 1 << 26, "cpu": 1 << 18}


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


def pieces(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` along its leading axis, each at most ``PIECE``
    elements for its device (one view if it is small or 0-dim)."""
    limit = PIECE.get(t.device.type, PIECE["cuda"])
    if t.dim() == 0 or t.numel() <= limit:
        yield t
        return
    rows = max(1, limit // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield t[i:i + rows]


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

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[dict, AdamWState]:
        """One AdamW step; ``params`` and the moments are updated in place
        and returned with the new step."""
        step = state.step + 1
        s = step.to(F32)
        lr = (_const(self.lr, s) if self.schedule is None
              else self.lr * self.schedule(step))
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - b1 ** s
        bc2 = 1.0 - b2 ** s

        def upd(g, m, v, p):
            gf = g.to(F32)
            m_new = b1 * m.to(F32) + (1 - b1) * gf
            v_new = b2 * v.to(F32) + (1 - b2) * gf * gf
            mh = m_new / bc1
            vh = v_new / bc2
            delta = mh / (torch.sqrt(vh) + self.eps)
            delta = delta + self.weight_decay * p.to(F32)
            p.copy_(p.to(F32) - lr * delta)
            m.copy_(m_new)
            v.copy_(v_new)

        def leaf(g, m, v, p):
            for pg, pm, pv, pp in zip(pieces(g), pieces(m), pieces(v),
                                      pieces(p)):
                upd(pg, pm, pv, pp)

        tree_map(leaf, grads, state.mu, state.nu, params)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' squared sums, in flatten order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + sum(torch.sum(torch.square(p.to(F32)))
                            for p in pieces(x))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, *, inplace: bool = False):
    """(the tree scaled to a global norm of at most ``max_norm``, the
    norm), computed a piece at a time; a new tree, or ``tree`` itself
    scaled in place with ``inplace=True`` (the train step's gradients)."""
    n = global_norm(tree)
    scale = torch.clamp(_const(max_norm, n) / (n + 1e-9), max=1.0)

    def clip(x):
        out = x if inplace else torch.empty_like(x)
        for px, po in zip(pieces(x), pieces(out)):
            po.copy_(px.to(F32) * scale)
        return out

    return tree_map(clip, tree), n


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
