"""Shared numeric tolerances of the port's FIN solver.

The same distance-error model as the reference (``repro/core/tolerances.py``):

  * the float64 engine (``minplus``, alias ``banded``) relaxes with exact
    float64 adds -- on the CPU through the plain PyTorch version, on CUDA
    through the float64 kernel; its distances carry no engine error
    (guard: DIST_RTOL_EXACT);
  * the ``f32`` engine relaxes in float32 (~1e-7 relative rounding per add),
    so the exit-prune guard widens to DIST_RTOL_F32, and elementwise
    comparisons of its grids against the float64 engine use RELAX_RTOL_F32.
"""
from __future__ import annotations

#: relative slack of the exit-prune guard for exact float64 engines.
DIST_RTOL_EXACT = 1e-9

#: relative slack of the exit-prune guard for float32 relaxation engines
#: (wider than RELAX_RTOL_F32: the guard bounds a *sum* of rounded adds).
DIST_RTOL_F32 = 1e-5

#: elementwise rtol when comparing float32-engine distances to float64.
RELAX_RTOL_F32 = 1e-6

#: relaxation engines that accumulate in float32.
F32_ENGINES = ("f32",)


def dist_tol(engine: str | None) -> float:
    """Exit-prune guard for a relaxation *engine* (not backend alias)."""
    return DIST_RTOL_F32 if engine in F32_ENGINES else DIST_RTOL_EXACT
