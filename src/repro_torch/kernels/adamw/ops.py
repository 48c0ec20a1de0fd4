"""Wrappers of the optimizer kernels B12 (the gradients' global norm and
clip scale) and B13 (AdamW's update with the clip folded in).

For CUDA tensors each wrapper launches its hand-written kernel
(``csrc/adamw.cu``) or raises; for CPU tensors it runs the plain PyTorch
version in ``ref.py``.  Each counts the calls that launch its kernel in a
plain integer attribute, ``launches``:

* ``global_norm_scale``: B12's chunk pass and its one-block finish (and,
  for a DTensor tree, the finish's second half after the leaf sums went
  over the mesh);
* ``adamw_update``: B13's one pass over every chunk of the tree.

Both walk a chunk table of the leaves (``ref.chunk_table``), built on the
host at each call and copied to the card from pinned memory: the
gradients are new tensors every step, so a table kept for their
addresses would seldom be found again.  The copy is asynchronous and
nothing syncs with the host: the norm, the scale and the update's
scalars stay on the device.  A call cannot be captured into a CUDA graph
(its table's copy reads a host buffer that the next call reuses).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .._build import launch
from .ref import (F32, G_BF16, MV_BF16, P_BF16, TINY, AdamWConsts, LeafSpec,
                  OverRanks, adamw_update_ref, chunk_table, global_norm_ref)

_DTYPES = (torch.float32, torch.bfloat16)


def _on_card(what: str, leaves: Sequence[torch.Tensor]) -> bool:
    """True for CUDA tensors on one device (the kernel); False for a tree
    without a CUDA tensor (the plain version, an empty tree included);
    raises for CUDA tensors beside tensors on another device."""
    devs = {t.device for t in leaves}
    if all(d.type != "cuda" for d in devs):
        return False
    if len(devs) > 1:
        raise ValueError(f"{what}: the tensors must lie on one device")
    return True


def _spec(g, p=None, m=None, v=None) -> LeafSpec:
    """A leaf's record: its tensors checked (float32 or bf16, contiguous,
    one size; m and v of one dtype)."""
    ts = (p, g, m, v)
    n = g.numel()
    for t in ts:
        if t is None:
            continue
        if t.dtype not in _DTYPES or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"the optimizer kernels take contiguous float32 "
                             f"or bf16 leaves of one size, got {t.dtype} "
                             f"{tuple(t.shape)} beside {n} elements")
    if m is not None and m.dtype != v.dtype:
        raise ValueError(f"m and v must share a dtype, got {m.dtype} / "
                         f"{v.dtype}")
    bf = lambda t: t is not None and t.dtype == torch.bfloat16
    code = (P_BF16 * bf(p)) | (G_BF16 * bf(g)) | (MV_BF16 * bf(m))
    return LeafSpec(tuple((t.data_ptr(), t.element_size()) if t is not None
                          else (0, 0) for t in ts), n, code)


def _table(device: torch.device, specs: Tuple[LeafSpec, ...]
           ) -> Tuple[torch.Tensor, int, int]:
    """(the device table, L, C) of these leaves."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the optimizer kernels copy their chunk table "
                           "to the card at each call: not capturable")
    table, L, C = chunk_table(specs)
    if C >= 2 ** 31:
        raise ValueError(f"{C} chunks exceed the kernels' grid")
    # the caching host allocator reuses the pinned block only after the
    # copy's stream has passed it
    return (torch.from_numpy(table).pin_memory().to(device, non_blocking=True),
            L, C)


def _specs(grads, params=None, mu=None, nu=None) -> Tuple[LeafSpec, ...]:
    if params is None:
        return tuple(_spec(g) for g in grads)
    if not len(grads) == len(params) == len(mu) == len(nu):
        raise ValueError("grads, params, mu and nu must have one leaf each")
    return tuple(_spec(g, p, m, v) for g, p, m, v in
                 zip(grads, params, mu, nu))


def _scalar(t: torch.Tensor, device: torch.device, what: str) -> int:
    if t.numel() != 1 or t.dtype != F32 or t.device != device:
        raise ValueError(f"{what} must be a float32 scalar on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def global_norm_scale(grads: Sequence[torch.Tensor], max_norm: float = 1.0,
                      over_ranks: Optional[OverRanks] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B12: (sqrt of the sum of the leaves' squared sums in flatten order,
    min(1, max_norm / (n + 1e-9))), float32 0-dim tensors on the leaves'
    device.  ``over_ranks`` sums each leaf's local sum over the mesh (a
    DTensor tree's shards)."""
    grads = list(grads)
    if not _on_card("global_norm", grads):
        return global_norm_ref(grads, max_norm, over_ranks)
    dev = grads[0].device
    table, L, C = _table(dev, _specs(grads))
    partials = torch.empty((max(C, 1),), dtype=F32, device=dev)
    sums = torch.empty((L,), dtype=F32, device=dev)
    out = torch.empty((2,), dtype=F32, device=dev)

    def finish(sums: torch.Tensor, mode: int) -> None:
        launch("adamw_norm_finish", dev, table.data_ptr(),
               partials.data_ptr(), sums.data_ptr(), out.data_ptr(),
               out[1:].data_ptr(), L, C, mode, float(max_norm), TINY)

    launch("adamw_norm_partials", dev, table.data_ptr(), partials.data_ptr(),
           L, C)
    if over_ranks is None:
        finish(sums, 0)
    else:
        finish(sums, 1)
        finish(torch.stack([over_ranks(i, sums[i]) for i in range(L)]
                           ).to(F32).contiguous(), 2)
    global_norm_scale.launches += 1
    return out[0], out[1]


global_norm_scale.launches = 0


def adamw_update(grads, mu, nu, params, lr: torch.Tensor, bc1: torch.Tensor,
                 bc2: torch.Tensor, consts: AdamWConsts,
                 scale: Optional[torch.Tensor] = None) -> None:
    """B13: every leaf's AdamW update in place (lists of leaves in one
    order); lr, bc1, bc2 and scale are float32 scalars on the leaves'
    device, ``scale`` None for no clip."""
    grads, mu, nu, params = (list(x) for x in (grads, mu, nu, params))
    if not _on_card("adamw_update", grads + mu + nu + params):
        return adamw_update_ref(grads, mu, nu, params, lr, bc1, bc2, consts,
                                scale)
    dev = grads[0].device
    table, L, C = _table(dev, _specs(grads, params, mu, nu))
    ptrs = [_scalar(t, dev, name) for t, name in
            ((lr, "lr"), (bc1, "bc1"), (bc2, "bc2"))]
    sp = None if scale is None else _scalar(scale, dev, "scale")
    launch("adamw_update", dev, table.data_ptr(), *ptrs, sp, L, C,
           *consts.kernel_args())
    adamw_update.launches += 1


adamw_update.launches = 0

