"""Spans and per-step records of the serving path.

Tracing is on exactly while a torch profiler records: there is no switch
of its own.  ``span(name)`` then opens a host range of function scope
(``torch._C._profiler._RecordFunctionFast``) on the profiler's clock, so
an idle stretch of the device trace can be put down to the span the host
was in.  Unlike ``torch.profiler.record_function`` (a user annotation,
which the profiler copies onto the device's timeline on CUDA), such a
range stays a host event: it adds nothing to the device's operations.

Off, ``span`` returns one shared no-op context (one check of the
profiler's flag, no allocation), a function decorated with ``spanned``
runs as it is, and ``SplitServeEngine`` keeps no ``StepRecord``.

The serving engine's spans (``runtime/serve_engine.py``):

  ``serve.step``      one decode step, the whole of ``step()``
  ``serve.refill``    a contingency refill (from ``step()`` or ``on_tick``)
  ``serve.admit``     slot fill and the step's token array
  ``serve.decode``    ``decode_step`` with the tokens' copy to the device
  ``serve.gates``     the exit gates and their copies to the host (the
                      wait for the device ends here)
  ``serve.emit``      exit choice, token append, tier charge, slot release
  ``serve.tick``      one churn tick, the whole of ``on_tick()``
  ``plan.channel``    an uplink or slice update of the plan
  ``plan.hold``       the incumbent's evaluation against the hysteresis band
  ``plan.resolve``    a warm re-solve and its frontier
  ``plan.failover``   a failure's or recovery's library lookup, then the
                      install or the re-solve
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch

#: ``tracing()`` is True while a torch profiler records
tracing = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range named ``name`` while a profiler records, else a no-op
    context."""
    return _Range(name) if tracing() else _OFF


def spanned(name: str):
    """Decorate a function so that each call is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not tracing():
                return fn(*args, **kwargs)
            with _Range(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@dataclass
class StepRecord:
    """What one decode step served, kept while tracing is on.

    ``prompt_rows`` fed a prompt token and ``emit_rows`` emitted one (the
    batch's other rows held no request); ``slots_read`` / ``slots_held``
    are the step's deltas of the decode attention kernel's counters
    (``kernels/decode_attn/ops.py``)."""
    pos: int
    prompt_rows: int
    emit_rows: int
    slots_read: int
    slots_held: int
