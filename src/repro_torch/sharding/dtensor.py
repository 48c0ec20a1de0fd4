"""What the model code needs to run over ``DTensor`` s.

A sharded step is the model's own code run on ``torch.distributed.tensor``
DTensors placed by the spec rules (``specs.py``).  DTensor propagates a
placement through most operators; this module holds the few places where
the model says more:

* ``settle`` sums a partial result (a vocab-parallel embedding's rows);
* ``replicated`` turns a tensor that every rank built alike (positions, a
  mask, a zero buffer) into a replicated DTensor beside a DTensor operand,
  since DTensor refuses to mix the two;
* ``product_local`` runs a product written for plain tensors (``mm`` /
  ``bmm`` with a float32 output, for which DTensor has no rule) on the
  local shards and gives the result the placement that a product of
  those operands has, and its operands' gradients theirs;
* ``write_slot`` writes one position of a decode cache on the rank that
  holds it;
* ``constrain`` is the port's ``with_sharding_constraint``, for the
  model's hooks.

On plain tensors each is the plain operation, so an unsharded run is the
run it was.
"""
from __future__ import annotations

from typing import List

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every partial placement reduced to a replicated one."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``like``'s
    mesh when ``like`` is a DTensor; ``t`` itself otherwise."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` redistributed to ``spec`` (a per-dimension spec, as
    ``specs.py`` writes them) on the context's ``DeviceMesh``: the port's
    ``with_sharding_constraint``.  A plain tensor, or no mesh in the
    context, leaves ``x`` as it is."""
    from .context import current_mesh
    from .specs import to_placements
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    placements = to_placements(spec, mesh)
    if x.device_mesh == mesh and list(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


# ---------------------------------------------------------------------------
# Products with a float32 output
# ---------------------------------------------------------------------------

def _product_rule(x, y, a_nd: int, batched: bool):
    """For one mesh dimension: the placements that the operands of
    ``a @ b`` (a [.., M, K] of ``a_nd`` dimensions placed ``x``, b [K, N]
    or, ``batched``, a [E, M, K] and b [E, K, N]) are brought to, the
    product's placement, and the placements of the operands' gradients
    (an operand replicated beside a sharded one gets a partial gradient; a
    partial operand a replicated one).  Where b is sharded along N, a is
    gathered (the tensor-parallel layout: Megatron's sequence parallelism
    gathers the activations); else a shard of a's leading dimensions is
    kept, b gathered (FSDP's weights); else a split contraction gives
    partial sums (a row-parallel product)."""
    R, P = Replicate(), Partial()
    if batched:
        a_k, b_k, b_n, out_n = Shard(2), Shard(1), Shard(2), Shard(2)
        a_rows = (Shard(1),)
    else:
        a_k, b_k, b_n, out_n = Shard(a_nd - 1), Shard(0), Shard(1), \
            Shard(a_nd - 1)
        a_rows = tuple(Shard(d) for d in range(a_nd - 1))
    if x == P and y.is_replicate():
        return x, y, P, R, P                # linear in a
    if y == P and x.is_replicate():
        return x, y, P, P, R                # linear in b
    x = R if x.is_partial() else x
    y = R if y.is_partial() else y
    if batched and (x == Shard(0) or y == Shard(0)):
        s0 = Shard(0)                       # the batch of products
        return s0, s0, s0, s0, s0
    if y == b_n:
        return R, b_n, out_n, P, b_n        # columns of b
    if x in a_rows:
        return x, R, x, x, P                # rows of a (b gathered: FSDP)
    if x == a_k or y == b_k:
        return a_k, b_k, P, a_k, b_k        # the contraction is split
    return R, R, R, R, R


def product_local(fn, a: torch.Tensor, b: torch.Tensor, *,
                  batched: bool = False) -> torch.Tensor:
    """``fn(a, b)``, a product of a [.., M, K] and b [K, N] (or a batched
    one, [E, M, K] by [E, K, N]) written for plain tensors, run on
    DTensors: both are brought to the placements of ``_product_rule``,
    ``fn`` runs on the local shards (``local_map``), and the result is a
    DTensor in the product's placement (partial where the contraction is
    split)."""
    from torch.distributed.tensor.experimental import local_map
    if not is_dtensor(b):
        b = replicated(b, a)
    if not is_dtensor(a):
        a = replicated(a, b)
    rules = [_product_rule(x, y, a.dim(), batched)
             for x, y in zip(a.placements, b.placements)]
    pa, pb, out, ga, gb = (tuple(r[i] for r in rules) for i in range(5))
    return local_map(fn, out_placements=(out,), in_placements=(pa, pb),
                     in_grad_placements=(ga, gb),
                     device_mesh=a.device_mesh,
                     redistribute_inputs=True)(a, b)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def local_offsets(x: torch.Tensor, placements=None) -> List[int]:
    """The global index of the first element of this rank's shard of
    ``x`` along each dimension, in ``x``'s placements or in
    ``placements`` (zeros for a plain tensor)."""
    if not is_dtensor(x):
        return [0] * x.dim()
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, placements or x.placements)
    return list(offset)


def write_slot(cache: torch.Tensor, axis: int, slot: int, value) -> None:
    """``cache[(:,) * axis + (slot,)] = value`` in place.  On a DTensor
    ``value`` is first brought to the placements of the cache's other
    dimensions and written into the local shard of the rank (or ranks)
    whose shard of ``axis`` holds ``slot``; the others write nothing."""
    index = (slice(None),) * axis + (slot,)
    if not is_dtensor(cache):
        cache[index] = value
        return
    local = cache.to_local()
    lo = local_offsets(cache)[axis]
    if not lo <= slot < lo + local.shape[axis]:
        if is_dtensor(value):
            _value_placements(cache, axis, value)   # every rank redistributes
        return
    if is_dtensor(value):
        value = _value_placements(cache, axis, value).to_local()
    local[(slice(None),) * axis + (slot - lo,)] = value


def _value_placements(cache: torch.Tensor, axis: int,
                      value: torch.Tensor) -> torch.Tensor:
    """``value`` (``cache`` without dimension ``axis``) in the cache's
    placements of its other dimensions."""
    want = []
    for p in cache.placements:
        if p.is_shard() and p.dim != axis:
            want.append(Shard(p.dim - (p.dim > axis)))
        else:
            want.append(Replicate())
    if list(value.placements) == want:
        return value
    return value.redistribute(value.device_mesh, want)
