"""PyTorch / CUDA port of the FIN placement system.

The solver's graphs and its banded (min,+) relaxation run on an NVIDIA
Hopper card through a hand-written CUDA kernel (``kernels/minplus``); host
objects (networks, profiles, requirements, configurations) and the exact
post-pass stay plain Python.  Entry points run on ``cuda:0`` unless the
caller passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions.  The package imports ``torch`` and ``numpy`` only.
"""
from ._device import resolve_device
from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all

__all__ = ["resolve_device", *_core_all]
