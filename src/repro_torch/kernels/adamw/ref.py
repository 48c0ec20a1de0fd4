"""Plain PyTorch versions of the optimizer kernels B12 and B13, and a CPU
mirror of the chunk table both walk.

B12 is the gradients' global norm and clip scale of the reference's
``global_norm`` / ``clip_by_global_norm`` (``repro/optim/adamw.py:73-81``):

* a leaf's sum of squares in float32, a piece at a time;
* the leaves' sums added in the tree's flatten order (each summed over
  the mesh first where the tree is a DTensor's: ``over_ranks``);
* n = sqrt(total), scale = min(1, max_norm / (n + 1e-9)).

B13 is the body ``upd`` of ``AdamW.update`` (``repro/optim/adamw.py:51-63``)
in float32, written into p, m and v in place, with the clip folded into
the gradient's load: g' = to_dtype(g)(float(g) * scale), the bits that an
in-place clip would have written, and the gradients are not written.

The update runs over pieces of a leaf (at most ``PIECE`` elements for the
device, cut along the leading axis: a period of a stacked leaf, a block of
embedding rows), keeping the float32 temporaries to a piece rather than
seven copies of the largest leaf; the results do not change.

``chunk_table`` is the table the kernels walk: a record a leaf (its four
tensors' addresses, its elements, its head, its dtype code, its first
chunk) and a record a chunk of at most ``CHUNK`` elements.  ``regions``
repeats, on the host, how a block cuts its chunk into a scalar head,
16-byte vectors and a scalar tail; the tests hold both on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32
#: elements of the largest piece a leaf is updated in, by device type: few
#: launches a piece on a card; on the CPU, pieces whose float32
#: temporaries stay in cache and in the allocator's reused memory, which
#: runs the update several times faster than large fresh buffers
PIECE = {"cuda": 1 << 26, "cpu": 1 << 18}
#: source constants (csrc/adamw.cu): elements of a chunk (a block's
#: work), elements a thread takes a step (a 16-byte vector of bf16, two of
#: float32), the words of a leaf record and of a chunk record
CHUNK = 1 << 16
VEC = 8
LEAF_WORDS, CHUNK_WORDS = 8, 4
#: a leaf's dtype code: bits for bf16 p, bf16 g, bf16 m and v
P_BF16, G_BF16, MV_BF16 = 1, 2, 4
#: the clip scale's guard against a zero norm
TINY = 1e-9
#: (index of a leaf, its local sum of squares) -> its sum over the mesh
OverRanks = Callable[[int, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class AdamWConsts:
    """AdamW's Python constants; each meets a float32 tensor rounded to
    float32, as a tensor-scalar op rounds it (``1 - b1`` is taken in
    float64 first)."""
    b1: float
    b2: float
    eps: float
    weight_decay: float

    def kernel_args(self) -> Tuple[float, ...]:
        """(b1, 1 - b1, b2, 1 - b2, eps, wd): the kernel's six doubles."""
        return (self.b1, 1 - self.b1, self.b2, 1 - self.b2, self.eps,
                self.weight_decay)


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


# ---------------------------------------------------------------------------
# B12
# ---------------------------------------------------------------------------

def sum_squares_ref(x: torch.Tensor) -> torch.Tensor:
    """A leaf's float32 sum of squares, a piece at a time."""
    return sum(torch.sum(torch.square(p.to(F32))) for p in pieces(x))


def global_norm_ref(leaves: Sequence[torch.Tensor], max_norm: float = 1.0,
                    over_ranks: Optional[OverRanks] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the global norm, the clip scale) of ``leaves`` in flatten order,
    float32 0-dim tensors on their device."""
    total = 0
    for i, x in enumerate(leaves):
        s = sum_squares_ref(x)
        total = total + (s if over_ranks is None else over_ranks(i, s))
    n = torch.sqrt(total)
    scale = torch.clamp(torch.full((), max_norm, dtype=F32, device=n.device)
                        / (n + TINY), max=1.0)
    return n, scale


# ---------------------------------------------------------------------------
# B13
# ---------------------------------------------------------------------------

def _upd(g, m, v, p, lr, bc1, bc2, c: AdamWConsts, scale):
    gf = g.to(F32)
    if scale is not None:
        gf = (gf * scale).to(g.dtype).to(F32)
    m_new = c.b1 * m.to(F32) + (1 - c.b1) * gf
    v_new = c.b2 * v.to(F32) + (1 - c.b2) * gf * gf
    mh = m_new / bc1
    vh = v_new / bc2
    delta = mh / (torch.sqrt(vh) + c.eps)
    delta = delta + c.weight_decay * p.to(F32)
    p.copy_(p.to(F32) - lr * delta)
    m.copy_(m_new)
    v.copy_(v_new)


def adamw_leaf_ref(g, m, v, p, lr, bc1, bc2, consts: AdamWConsts,
                   scale=None) -> None:
    """One leaf's update in place, a piece at a time; ``lr``, ``bc1``,
    ``bc2`` and ``scale`` are float32 0-dim tensors (``scale`` None: no
    clip)."""
    for pg, pm, pv, pp in zip(pieces(g), pieces(m), pieces(v), pieces(p)):
        _upd(pg, pm, pv, pp, lr, bc1, bc2, consts, scale)


def adamw_update_ref(grads, mu, nu, params, lr, bc1, bc2,
                     consts: AdamWConsts, scale=None) -> None:
    """B13's plain version over lists of leaves: every leaf updated in
    place."""
    for g, m, v, p in zip(grads, mu, nu, params):
        adamw_leaf_ref(g, m, v, p, lr, bc1, bc2, consts, scale)


# ---------------------------------------------------------------------------
# The chunk table
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafSpec:
    """What the table keeps of a leaf: its tensors' (address, element
    size) in the order p, g, m, v (address 0: absent), its elements and
    its dtype code."""
    tensors: Tuple[Tuple[int, int], ...]
    numel: int
    code: int


def leaf_head(tensors: Sequence[Tuple[int, int]]) -> int:
    """The first element j < VEC from which every present tensor's 8
    elements lie at a 16-byte aligned address, or -1 if there is none
    (the leaf then runs element by element)."""
    live = [(a, s) for a, s in tensors if a]
    for j in range(VEC):
        if all((a + s * j) % 16 == 0 for a, s in live):
            return j
    return -1


def chunks(numel: np.ndarray, heads: np.ndarray) -> np.ndarray:
    """[C, 3] (leaf, start, end) of the chunks of leaves of ``numel``
    elements and ``heads``, leaf after leaf: a leaf's first chunk is
    [0, head + CHUNK), the next ones start at head + k CHUNK (an empty
    leaf has none)."""
    numel = np.asarray(numel, np.int64)
    h = np.maximum(np.asarray(heads, np.int64), 0)
    rest = np.maximum(numel - (h + CHUNK), 0)
    k = np.where(numel == 0, 0, 1 + (rest + CHUNK - 1) // CHUNK)
    leaf = np.repeat(np.arange(len(numel), dtype=np.int64), k)
    i = np.arange(int(k.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(k) - k, k)
    start = np.where(i == 0, 0, h[leaf] + i * CHUNK)
    end = np.minimum(h[leaf] + (i + 1) * CHUNK, numel[leaf])
    return np.stack([leaf, start, end], axis=1)


def chunk_table(leaves: Sequence[LeafSpec]) -> Tuple[np.ndarray, int, int]:
    """(the int64 table, leaves L, chunks C): L leaf records of
    ``LEAF_WORDS`` (p, g, m, v, n, head, code, first chunk), then C chunk
    records of ``CHUNK_WORDS`` (leaf, start, end, 0)."""
    L = len(leaves)
    recs = np.zeros((L, LEAF_WORDS), np.int64)
    # addresses above 2^63 do not occur in a process's user space
    recs[:, :4] = [[a for a, _ in lf.tensors] for lf in leaves]
    recs[:, 4] = [lf.numel for lf in leaves]
    recs[:, 5] = [leaf_head(lf.tensors) for lf in leaves]
    recs[:, 6] = [lf.code for lf in leaves]
    ch = chunks(recs[:, 4], recs[:, 5])
    recs[:, 7] = np.searchsorted(ch[:, 0], np.arange(L))
    rows = np.zeros((len(ch), CHUNK_WORDS), np.int64)
    rows[:, :3] = ch
    return np.concatenate([recs.reshape(-1), rows.reshape(-1)]), L, len(ch)


def regions(table: np.ndarray, L: int) -> List[Tuple[int, int, int, int, int]]:
    """(leaf, s, vs, ve, e) of every chunk, as the kernels cut it: scalar
    [s, vs), 8-element vectors [vs, ve), scalar [ve, e)."""
    recs = table[:L * LEAF_WORDS].reshape(L, LEAF_WORDS)
    chunks = table[L * LEAF_WORDS:].reshape(-1, CHUNK_WORDS)
    out = []
    for leaf, s, e, _ in chunks.tolist():
        head = int(recs[leaf, 5])
        if head < 0:
            out.append((leaf, s, e, e, e))
            continue
        vs = min(head, e) if s < head else s
        out.append((leaf, s, vs, vs + (e - vs) // VEC * VEC, e))
    return out
