"""Wrappers of the training loss kernel B11, and its autograd Function.

For CUDA tensors each wrapper launches its hand-written kernel
(``csrc/linear_ce.cu``) or raises; for CPU tensors it runs the plain
PyTorch version in ``ref.py``.  Each counts the calls that launch its
kernel in a plain integer attribute, ``launches``:

* ``linear_ce_forward``: K1 (the logits tiles' online log-sum-exp over a
  vocab split) and the combine (lse, the loss sum and the count); for a
  vocab-sharded head, K1, a gather of every rank's partials and the
  combine;
* ``linear_ce_dlogits``: K2, the loss's cotangent on the logits of a pass
  of rows, in the model's dtype;
* ``linear_ce_gemm``: K3, a product with float32 sums (dh = dl W^T, dW =
  h^T dl).

``LinearCE`` is the autograd Function that ``chunked_cross_entropy`` calls
(on DTensors, on each rank's shards): its forward is ``linear_ce_forward``,
gives the loss sum and the count, and saves h, W, the labels and lse; its
backward runs, a pass of rows at a time, K2 and then K3 for dh and for dW.
The cotangent on the loss sum (g / max(count, 1)) stays on the device.

A vocab-sharded head's rank passes its columns of W, ``col0`` (the
vocabulary's column of its first) and a ``gather`` of K1's partials over
the ranks; the labels stay the vocabulary's.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ...models.layers import no_tf32
from .._build import launch, sm_count
from .ref import (F32, MAX_SMEM_BYTES, WG_COLS, WG_ROWS, LinearCEPlan,
                  dlogits_ref, linear_ce_bwd_ref, linear_ce_combine_ref,
                  linear_ce_partials_ref, linear_ce_plan, live_columns,
                  smem_bytes)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: K1's partials [3, n_split, N] -> every rank's, [3, ranks * n_split, N]
Gather = Callable[[torch.Tensor], torch.Tensor]


def _stored(t: torch.Tensor) -> Optional[str]:
    """How a 2-D tensor lies in memory: "rows" (its last axis contiguous,
    rows dense), "cols" (its first axis contiguous, columns dense), or
    None.  A dimension of size 1 takes any stride."""
    r, c = t.shape
    if t.stride(1) == 1 or c == 1:
        if r == 1 or t.stride(0) == c:
            return "rows"
    if t.stride(0) == 1 or r == 1:
        if c == 1 or t.stride(1) == r:
            return "cols"
    return None


def _on_card(what: str, *ts: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version), True for CUDA ones on one
    device; raises for any other device or a mix."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what}: the tensors must lie on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    return True


def _check_loss(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                vocab_size: int, col0: Optional[int] = None) -> int:
    """The loss's operands: h [N, d], w [d, V] (as stored, or the tied
    table's transpose): the whole head (``col0`` None, 1 <= vocab_size <=
    V) or a rank's columns of it from col0 >= 0; labels [N] int64.
    Returns w's layout code for the kernels (1: [d, V] stored, 0:
    table.T)."""
    if h.dim() != 2 or w.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"expected h [N, d], w [d, V] and labels [N], got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}, "
                         f"{tuple(labels.shape)}")
    N, d = h.shape
    V = w.shape[1]
    if w.shape[0] != d or labels.shape[0] != N:
        raise ValueError(f"w must be [{d}, V] and labels [{N}], got "
                         f"{tuple(w.shape)} / {tuple(labels.shape)}")
    if vocab_size < 1 or (vocab_size > V if col0 is None else col0 < 0):
        raise ValueError(f"vocab_size {vocab_size} outside [1, {V}] or "
                         f"col0 {col0} < 0")
    if h.dtype not in _SUFFIX or w.dtype != h.dtype:
        raise ValueError(f"h and w must share float32 or bfloat16, got "
                         f"{h.dtype} / {w.dtype}")
    if labels.dtype != torch.int64:
        raise ValueError(f"labels must be int64, got {labels.dtype}")
    if not h.is_contiguous() or not labels.is_contiguous():
        raise ValueError("h and labels must be contiguous")
    layout = _stored(w)
    if layout is None:
        raise ValueError(f"w must be stored [d, V] or be a [V, d] table's "
                         f"transpose, got strides {w.stride()}")
    if h.dtype == torch.bfloat16 and (d % 8 or V % 8 or any(
            t.data_ptr() % 16 for t in (h, w))):
        raise ValueError(f"the bf16 kernels load 16-byte rows by TMA: d and "
                         f"V must be multiples of 8 and h, w 16-byte "
                         f"aligned, got d={d}, V={V}")
    if N * max(d, V) >= 2 ** 62 or N >= 2 ** 31:
        raise ValueError(f"{N} rows exceed the kernels' indexing")
    return 1 if layout == "rows" else 0


def plan_for(h: torch.Tensor, w: torch.Tensor, dl_bytes: int
             ) -> LinearCEPlan:
    """``linear_ce_plan`` for these operands on their card."""
    N, d = h.shape
    plan = linear_ce_plan(N, d, w.shape[1], h.dtype, dl_bytes,
                          _stored(w) == "cols", sm_count(h.device))
    need = smem_bytes(plan)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"a block needs {need} B of shared memory, > "
                         f"{MAX_SMEM_BYTES} B")
    return plan


def linear_ce_forward(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      vocab_size: int, plan: Optional[LinearCEPlan] = None,
                      *, col0: Optional[int] = None,
                      gather: Optional[Gather] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 and the combine: h [N, d], w [d, V] (the head's columns from
    ``col0``; None: the whole head), labels [N] int64 (-1: no label) ->
    (stats [2]: the loss sum and the count, loss [] = sum / max(count, 1),
    lse [N]), all float32.  With ``gather`` the combine runs on every
    rank's K1 partials."""
    b_mn = _check_loss(h, w, labels, vocab_size, col0)
    col0 = col0 or 0
    N, d = h.shape
    V = w.shape[1]
    live = live_columns(vocab_size, col0, V)
    if not _on_card("linear_ce", h, w, labels):
        part = linear_ce_partials_ref(h, w, labels, vocab_size, col0)
        tot, cnt, lse = linear_ce_combine_ref(
            part if gather is None else gather(part), labels)
        return torch.stack([tot, cnt]), tot / torch.clamp(cnt, min=1.0), lse
    plan = plan or plan_for(h, w, 0)
    part = torch.empty((3, plan.n_split, N), dtype=F32, device=h.device)
    lse = torch.empty((N,), dtype=F32, device=h.device)
    stats = torch.empty((2,), dtype=F32, device=h.device)
    loss = torch.empty((), dtype=F32, device=h.device)
    fused = gather is None
    launch(f"linear_ce_fwd_{_SUFFIX[h.dtype]}", h.device, h.data_ptr(),
           w.data_ptr(), labels.data_ptr(), part.data_ptr(),
           lse.data_ptr() if fused else None,
           stats.data_ptr(), loss.data_ptr(), N, d, V, live, col0, b_mn,
           plan.n_split)
    if not fused:
        part = gather(part).contiguous()
        launch("linear_ce_combine", h.device, part.data_ptr(),
               labels.data_ptr(), lse.data_ptr(), stats.data_ptr(),
               loss.data_ptr(), N, part.shape[1])
    linear_ce_forward.launches += 1
    return stats, loss, lse


linear_ce_forward.launches = 0


def linear_ce_dlogits(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                      lse: torch.Tensor, scale: torch.Tensor,
                      vocab_size: int, out: torch.Tensor, *,
                      col0: Optional[int] = None) -> torch.Tensor:
    """K2: the loss's cotangent on the logits of h's rows into ``out``
    (contiguous [N, V] in h's dtype): scale (exp(logits - lse) - onehot)
    at a labelled row, exact zeros on the padded columns and the
    unlabelled rows.  lse [N] is the forward's, scale the cotangent on
    the loss sum (float32 scalar)."""
    b_mn = _check_loss(h, w, labels, vocab_size, col0)
    col0 = col0 or 0
    N, V = h.shape[0], w.shape[1]
    if lse.shape != (N,) or scale.numel() != 1 or any(
            t.dtype != F32 for t in (lse, scale)):
        raise ValueError("lse [N] and scale [] must be float32")
    if out.shape != (N, V) or out.dtype != h.dtype or \
            not out.is_contiguous() or out.device != h.device:
        raise ValueError(f"out must be a contiguous [{N}, {V}] {h.dtype} "
                         f"tensor on {h.device}")
    if h.dtype == torch.bfloat16 and out.data_ptr() % 16:
        raise ValueError("the bf16 kernel stores dl by TMA: out must be "
                         "16-byte aligned")
    if not _on_card("linear_ce_dlogits", h, w, labels, lse, scale):
        return out.copy_(dlogits_ref(h, w, labels, lse, scale, vocab_size,
                                     col0))
    lse, scale = lse.contiguous(), scale.contiguous()
    launch(f"linear_ce_dlogits_{_SUFFIX[h.dtype]}", h.device, h.data_ptr(),
           w.data_ptr(), labels.data_ptr(), lse.data_ptr(), scale.data_ptr(),
           out.data_ptr(), N, h.shape[1], V,
           live_columns(vocab_size, col0, V), col0, b_mn)
    linear_ce_dlogits.launches += 1
    return out


linear_ce_dlogits.launches = 0


def linear_ce_gemm(a: torch.Tensor, b: torch.Tensor, *,
                   out: Optional[torch.Tensor] = None,
                   c_in: Optional[torch.Tensor] = None, split: int = 1
                   ) -> torch.Tensor:
    """K3: out [M, N] = a [M, K] @ b [K, N] (+ c_in [M, N] float32) with
    float32 sums, rounded to ``out``'s dtype (a new tensor in a's dtype if
    not given).  Each operand is read as it lies: a stored [M][K] or as the
    transpose of a [K][M] tensor, b stored [K][N] or as the transpose of
    [N][K].  bf16 may split K in ``split`` (float32 partials summed in
    split order); float32 takes split 1 and a float32 out."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected a [M, K] and b [K, N], got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if a.dtype not in _SUFFIX or b.dtype != a.dtype:
        raise ValueError(f"a and b must share float32 or bfloat16, got "
                         f"{a.dtype} / {b.dtype}")
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if out.shape != (M, N) or not out.is_contiguous() or \
            out.dtype not in (F32, a.dtype):
        raise ValueError(f"out must be a contiguous [{M}, {N}] tensor of "
                         f"float32 or {a.dtype}")
    if c_in is not None and (c_in.shape != (M, N) or c_in.dtype != F32 or
                             not c_in.is_contiguous()):
        raise ValueError(f"c_in must be a contiguous [{M}, {N}] float32 "
                         f"tensor")
    extra = () if c_in is None else (c_in,)
    if not _on_card("linear_ce_gemm", a, b, out, *extra):
        with torch.no_grad(), no_tf32():
            prod = a.to(F32) @ b.to(F32)
            return out.copy_(prod if c_in is None else prod + c_in)
    sa, sb = _stored(a), _stored(b)
    if sa is None or sb is None:
        raise ValueError(f"a and b must be dense in one of their axes, got "
                         f"strides {a.stride()} / {b.stride()}")
    a_mn, b_mn = sa == "cols", sb == "rows"
    if a.dtype == F32 and (split != 1 or out.dtype != F32):
        raise ValueError("the float32 product takes split 1 and a float32 "
                         "out")
    if a.dtype == torch.bfloat16:
        if a_mn and not b_mn:
            raise ValueError("a stored [K][M] needs b stored [K][N]")
        if (M if a_mn else K) % 8 or (N if b_mn else K) % 8 or N % 2 or any(
                t.data_ptr() % 16 for t in (a, b)):
            raise ValueError(f"the bf16 product loads 16-byte rows by TMA: "
                             f"the stored rows of a [{M}, {K}] and b "
                             f"[{K}, {N}] must be multiples of 8 and "
                             f"16-byte aligned")
        if not 1 <= split <= -(-K // 64):
            raise ValueError(f"split {split} outside [1, {-(-K // 64)}]")
    elif N % 2:
        raise ValueError(f"N = {N} must be even")
    work = sem = None
    if split > 1:
        work = torch.empty((split, M, N), dtype=F32, device=a.device)
        sem = torch.zeros(-(-M // WG_ROWS) * -(-N // WG_COLS),
                          dtype=torch.int32, device=a.device)
    launch(f"linear_ce_gemm_{_SUFFIX[a.dtype]}", a.device, a.data_ptr(),
           b.data_ptr(), None if c_in is None else c_in.data_ptr(),
           out.data_ptr(), None if work is None else work.data_ptr(),
           None if sem is None else sem.data_ptr(), M, N, K, int(a_mn),
           int(b_mn), split, int(out.dtype == F32))
    linear_ce_gemm.launches += 1
    return out


linear_ce_gemm.launches = 0


def _backward(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              lse: torch.Tensor, scale: torch.Tensor, vocab_size: int,
              plan: LinearCEPlan, need_h: bool, need_w: bool,
              col0: Optional[int] = None
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """dh [N, d] and dW [d, V] on the card, a pass of ``plan.pass_rows``
    rows at a time: K2 into one dl buffer, then K3 for the pass's rows of
    dh and for dW (a float32 running sum across passes; the tied head's
    dW^T [V, d] is computed as stored and returned transposed)."""
    N, d = h.shape
    V = w.shape[1]
    tied = _stored(w) == "cols"
    R = plan.pass_rows
    dl = torch.empty((min(R, N), V), dtype=h.dtype, device=h.device)
    dh = torch.empty_like(h) if need_h else None
    dw = None
    if need_w:
        dw = torch.empty((V, d) if tied else (d, V), dtype=w.dtype,
                         device=w.device)
    passes = range(0, N, R)
    acc = None
    if need_w and len(passes) > 1:
        acc = dw if dw.dtype == F32 else torch.empty(dw.shape, dtype=F32,
                                                     device=dw.device)
    for i, r0 in enumerate(passes):
        rows = slice(r0, min(r0 + R, N))
        hp = h[rows]
        dlp = dl[:hp.shape[0]]
        linear_ce_dlogits(hp, w, labels[rows], lse[rows], scale,
                          vocab_size, out=dlp, col0=col0)
        if need_h:
            linear_ce_gemm(dlp, w.t(), out=dh[rows], split=plan.dh_split)
        if need_w:
            a, b = (dlp.t(), hp) if tied else (hp.t(), dlp)
            last = i == len(passes) - 1
            linear_ce_gemm(a, b, out=dw if acc is None or last else acc,
                           c_in=None if i == 0 else acc)
    return dh, (dw.t() if tied and dw is not None else dw)


class LinearCE(torch.autograd.Function):
    """The cross-entropy summed over h [N, d]'s labelled rows under the
    head w [d, V] (the columns from ``col0``; ``gather`` for a
    vocab-sharded head), and their count (``linear_ce_forward``);
    differentiable in h and w (``_backward``: K2 and K3, no plain logits;
    a vocab shard's dh is its share of a sum over the ranks).  On the CPU
    both directions are the plain versions; a rank of no rows (an uneven
    shard) launches nothing."""

    @staticmethod
    def forward(ctx, h, w, labels, vocab_size: int, dl_bytes: int,
                col0: Optional[int] = None,
                gather: Optional[Gather] = None):
        plan = None
        if h.shape[0] == 0:
            stats = torch.zeros(2, dtype=F32, device=h.device)
            lse = torch.zeros(0, dtype=F32, device=h.device)
        else:
            plan = plan_for(h, w, dl_bytes) if h.is_cuda else None
            stats, _, lse = linear_ce_forward(h, w, labels, vocab_size, plan,
                                              col0=col0, gather=gather)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.vocab_size, ctx.plan, ctx.col0 = vocab_size, plan, col0
        tot, cnt = stats.unbind()
        ctx.mark_non_differentiable(cnt)
        return tot, cnt

    @staticmethod
    def backward(ctx, scale, _):
        h, w, labels, lse = ctx.saved_tensors
        need_h, need_w = ctx.needs_input_grad[:2]
        scale = scale.to(F32).reshape(()).contiguous()
        if ctx.plan is not None:
            dh, dw = _backward(h, w, labels, lse, scale, ctx.vocab_size,
                               ctx.plan, need_h, need_w, ctx.col0)
        elif h.shape[0] == 0:
            dh, dw = torch.zeros_like(h), torch.zeros_like(w)
        else:
            dh, dw = linear_ce_bwd_ref(h, w, labels, lse, scale,
                                       ctx.vocab_size, ctx.col0 or 0)
        dh, dw = dh if need_h else None, dw if need_w else None
        return dh, dw, None, None, None, None, None


def linear_ce(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
              vocab_size: int, dl_bytes: int) -> torch.Tensor:
    """The mean cross-entropy over h's labelled rows (``LinearCE``): h
    [N, d], w [d, V] (stored, or a tied table's transpose), labels [N]
    (-1: no label); a backward pass of rows holds at most ``dl_bytes`` of
    dl."""
    tot, cnt = LinearCE.apply(h, w, labels.long().contiguous(), vocab_size,
                              dl_bytes)
    return tot / torch.clamp(cnt, min=1.0)
