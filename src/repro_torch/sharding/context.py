"""Explicit sharding context for model-internal sharding constraints.

Port of ``repro/sharding/context.py``.  Model code must not depend on
how it is launched: a launcher enters ``activation_sharding(mesh)`` and
the model queries ``current()``.  ``mesh`` is a ``launch.mesh.MeshDesc``
or a ``DeviceMesh``; a ``DeviceMesh`` is also kept (``current_mesh()``),
and the model's hooks (``transformer._sp_constraint``,
``ssm._head_constraint``) redistribute DTensor activations onto it.
Absent a context, or with a ``MeshDesc`` only, the hooks leave a tensor
as it is.

The context is per thread, as the reference's.  Autograd may run a
backward, and with it an activation checkpoint's recompute, on another
thread (a CUDA device thread), so code that recomputes takes the context
with ``captured()`` when it builds the function and enters it again with
``entered()``.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

from torch.distributed.device_mesh import DeviceMesh

from .specs import axis_sizes

_STATE = threading.local()


@dataclass(frozen=True)
class ShardCtx:
    dp_axes: Tuple[str, ...]
    model_axis: str
    model_size: int
    dp_size: int = 1


def current() -> Optional[ShardCtx]:
    return getattr(_STATE, "ctx", None)


def current_mesh():
    """The ``DeviceMesh`` of the innermost context, or None (no context,
    or a context over a ``MeshDesc``)."""
    return getattr(_STATE, "mesh", None)


def captured():
    """The calling thread's context, for ``entered``."""
    return current(), current_mesh()


@contextlib.contextmanager
def entered(state):
    """Run a block under a context taken by ``captured()``, on any
    thread."""
    prev = captured()
    _STATE.ctx, _STATE.mesh = state
    try:
        yield
    finally:
        _STATE.ctx, _STATE.mesh = prev


@contextlib.contextmanager
def activation_sharding(mesh):
    axes = axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp_size = 1
    for a in dp_axes:
        dp_size *= axes[a]
    ctx = ShardCtx(
        dp_axes=dp_axes,
        model_axis="model" if "model" in axes else "",
        model_size=axes.get("model", 1),
        dp_size=dp_size,
    )
    with entered((ctx, mesh if isinstance(mesh, DeviceMesh) else None)):
        yield ctx
