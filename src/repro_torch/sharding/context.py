"""Explicit sharding context for model-internal sharding constraints.

Port of ``repro/sharding/context.py``.  Model code must not depend on
how it is launched: a launcher enters ``activation_sharding(mesh)`` and
the model queries ``current()``.  ``mesh`` is a ``launch.mesh.MeshDesc``
or a ``DeviceMesh``.  The port's model code reads no context yet: its hooks
(the reference's ``_sp_constraint`` and ``_head_constraint``) come with
sharded execution.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

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
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev
