"""Population-scale fused ingest gate: quantize -> int16 pack -> signature.

Port of ``repro/kernels/ee_gate/population.py``.  ``Population`` maps a
batch of ``(Us, N)`` bandwidth rows straight to the ``(Us, M*(2L-1)*N)``
int16 signature encoding the cohort-state table keys on, in one pass:
values are integers in ``[0, gamma]`` or ``+inf`` (``gamma`` < int16 max),
stored with ``-1`` for inf, so comparing or keying in encoded space equals
comparing the float64 packs elementwise.

Backends, selected per call:

``device``  kernel B2 (``csrc/quant_signature.cu``) on a CUDA tensor, its
            plain PyTorch version (``ref.py``) on a CPU tensor; the result
            is a tensor on the constants' device.  Byte-equal to the oracle.
``numpy``   the host oracle, elementwise identical to the reference's
            ``quant_signature_np`` (same formulas, same copyto semantics);
            the result is a numpy array.

The reference's ``jnp`` name raises: its counterpart is ``device``.

The constants bundle (:class:`QuantConsts`) snapshots the proto plan's
packed-requantizer tensors, on the cohort's device; compute-slice
repricings rebuild those, so ``Population`` drops its bundle on
``update_slice`` (backhaul repricings are bandwidth-only and keep it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .ops import quant_signature_rows

__all__ = ["QuantConsts", "quant_signature", "quant_signature_np"]


@dataclass(frozen=True)
class QuantConsts:
    """The batch-invariant inputs of the fused requantizer: the proto
    plan's packed per-link tensors plus the quantizer parameterization.
    ``modes`` is ordered exactly like the population's quantizer passes
    (floor/round main pass first, ceil rescue second)."""

    bits_pack: torch.Tensor        # (2L-1, 1) float64
    C_pack: torch.Tensor           # (2L-1, N) float64
    mask_pack: torch.Tensor        # (2L-1, N) bool
    load_pack: torch.Tensor        # (2L-1, 1) float64
    modes: Tuple[str, ...]
    gamma: int
    delta: float

    @property
    def device(self) -> torch.device:
        return self.C_pack.device

    @property
    def out_width(self) -> int:
        """Width of the signature rows: ``M * (2L-1) * N``.  The bits and
        load packs are (2L-1, 1) columns broadcast over the N links, so the
        width is taken from ``C_pack``."""
        K2, N = self.C_pack.shape
        return len(self.modes) * K2 * N


def _quant_raw(x: np.ndarray, mode: str,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Eq. (4) quantizer without the non-finite guard, in numpy (the
    reference's ``feasible_graph._quant_raw``); ``out`` writes into a
    preallocated buffer (same float ops, no temporaries)."""
    if mode == "ceil":
        if out is None:
            return np.ceil(x - 1e-12)
        np.subtract(x, 1e-12, out=out)
        return np.ceil(out, out=out)
    if mode == "floor":
        if out is None:
            return np.floor(x + 1e-12)
        np.add(x, 1e-12, out=out)
        return np.floor(out, out=out)
    if mode == "round":
        return np.round(x, 0, out)
    raise ValueError(f"unknown quantize mode {mode!r}")


def quant_signature_np(vec: np.ndarray, c: QuantConsts) -> np.ndarray:
    """Host-numpy oracle: (Us, N) bandwidth rows -> (Us, M*K2*N) int16
    signature rows.  Elementwise identical to the float64
    requantize-then-encode pipeline (``plan.update_uplinks`` formulas)."""
    bits, C, maskp, loadp = (t.cpu().numpy() for t in (
        c.bits_pack, c.C_pack, c.mask_pack, c.load_pack))
    Us, N = vec.shape
    K2 = C.shape[0]
    M = len(c.modes)
    G = c.gamma
    bwm = np.where(vec > 0, vec, np.nan)                 # (Us, N)
    sc = bits[None] / bwm[:, None, :]                    # (Us, K2, N)
    sc += C[None]
    np.multiply(sc, G, out=sc)
    sc /= c.delta
    valid = np.isfinite(sc)
    valid &= maskp[None]
    valid &= loadp[None] <= vec[:, None, :]
    enc = np.empty((Us, M, K2, N), dtype=np.int16)
    q = np.empty_like(sc)
    for mi, mode in enumerate(c.modes):
        _quant_raw(sc, mode, out=q)
        ok = q <= G
        ok &= valid
        e = enc[:, mi]
        np.copyto(e, q, casting="unsafe", where=ok)
        e[~ok] = -1
    return enc.reshape(Us, M * K2 * N)


def quant_signature(vec: Union[np.ndarray, torch.Tensor], c: QuantConsts, *,
                    backend: str = "device"
                    ) -> Union[np.ndarray, torch.Tensor]:
    """Fused ingest gate over a batch of bandwidth rows (see module doc).

    Returns the (Us, M*K2*N) int16 signature rows the cohort-state table
    keys on: a tensor on ``c.device`` for ``device``, a numpy array for
    ``numpy``."""
    if backend == "device":
        v = torch.as_tensor(vec, dtype=torch.float64, device=c.device)
        return quant_signature_rows(v.contiguous(), c.bits_pack, c.C_pack,
                                    c.mask_pack, c.load_pack, c.modes,
                                    c.gamma, c.delta)
    if backend == "numpy":
        if isinstance(vec, torch.Tensor):
            vec = vec.cpu().numpy()
        return quant_signature_np(np.asarray(vec, dtype=np.float64), c)
    if backend == "jnp":
        raise ValueError("quant_signature backend 'jnp' is the reference's "
                         "jitted XLA launch; the port's counterpart is "
                         "backend='device' (kernel B2 on CUDA)")
    raise ValueError(f"unknown quant_signature backend {backend!r} "
                     f"(expected one of ['device', 'numpy'])")
