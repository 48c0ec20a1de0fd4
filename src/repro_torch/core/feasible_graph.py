"""FIN feasible graph (Sec. III): depth-replicated, pruned, layered.

Port of ``repro/core/feasible_graph.py``: the compact banded tensors and
the dense (S, S) layer matrices, S = N * (G+1).  Every extended-graph
vertex (n, l_i) is replicated gamma+1 times; replica g ("depth") encodes
quantized accumulated latency, and an edge v_{g1} -> v'_{g2} exists iff
g2 - g1 equals the quantized edge latency (Eq. 4) and the local (3d)/(3e)
pruning admits it.

Quantization modes for Eq. (4): ``ceil`` (conservative), ``floor`` (the
default; FIN exact-checks the result and tightens delta if needed) and
``round`` (half to even, like ``np.round``).  The steepness grids are
byte-equal to the reference's when the inputs are: ``gamma * TT / delta``
takes the product first and divides tensor by tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from .extended_graph import ExtendedGraph

_INF = float("inf")


def _quant_raw(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Eq. (4) quantizer without the non-finite guard."""
    if mode == "ceil":
        return torch.ceil(x - 1e-12)
    if mode == "floor":
        return torch.floor(x + 1e-12)
    if mode == "round":
        return torch.round(x)
    raise ValueError(f"unknown quantize mode {mode!r}")


def _quant(x: torch.Tensor, mode: str) -> torch.Tensor:
    return torch.where(torch.isfinite(x), _quant_raw(x, mode), _INF)


@dataclass
class FeasibleGraph:
    """Depth-replicated feasibility graph, stored layer-wise.

    steep[i][n, n']  integer depth increment of edge (n, l_i) -> (n', l_{i+1})
                     (inf where the edge is pruned / latency-infeasible);
    init_depth[n]    depth of the source edge into (n, l_0);
    gamma, lam       resolution and lambda-proximity window (Sec. III).
    """

    ext: ExtendedGraph
    gamma: int
    lam: int
    quantize: str
    delta_eff: float
    steep: torch.Tensor        # (L-1, N, N) float64 (int values or inf)
    init_depth: torch.Tensor   # (N,) float64 (int values or inf)

    @property
    def n_states(self) -> int:
        return self.ext.n_nodes * (self.gamma + 1)

    @property
    def depth_window_lo(self) -> Optional[int]:
        """Lower bound of the lambda-proximity window on target depths, or
        None when the window is inactive (lam == gamma)."""
        return self.gamma - self.lam if self.lam < self.gamma else None

    @property
    def n_vertices(self) -> int:
        return self.ext.n_blocks * self.n_states + 1

    @property
    def n_edges(self) -> int:
        """Source edges plus one feasible-graph edge per admissible
        extended edge (n, n') and source depth g with g + steep <= gamma."""
        n_init = int(torch.isfinite(self.init_depth).sum())
        per_edge = torch.where(torch.isfinite(self.steep),
                               (self.gamma + 1 - self.steep).clamp(min=0.0),
                               0.0)
        return n_init + int(per_edge.sum())

    def layer_matrices(self) -> torch.Tensor:
        """(L-1, S, S) dense (min,+) transition matrices over the states
        s = n * (gamma+1) + g: energy weights, +inf for non-edges."""
        return batch_layer_tensors([self])[0][0]

    def init_vector(self) -> torch.Tensor:
        """(S,) initial state distances (source edges)."""
        return self.init_grid().reshape(-1)

    def banded_tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(E (L-1, N, N), steep (L-1, N, N)) -- the native banded form."""
        return self.ext.E, self.steep

    def init_grid(self) -> torch.Tensor:
        """(N, G+1) initial distances over (node, depth)."""
        return _init_grids(self.init_depth[None], self.ext.init_E[None],
                           self.gamma)[0]


def _init_grids(d0: torch.Tensor, iE: torch.Tensor, G: int) -> torch.Tensor:
    """(D, N, G+1) init grids: init_E at each finite depth <= G, else inf."""
    g = torch.arange(G + 1, dtype=d0.dtype, device=d0.device)
    hit = torch.isfinite(d0)[..., None] & (d0[..., None] == g)
    return torch.where(hit, iE[..., None], _INF)


def batch_banded_tensors(fgs: Sequence[FeasibleGraph]
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stacked banded tensors for a same-shape group of feasible graphs.

    Returns (E (D, L-1, N, N), steep (D, L-1, N, N), init (D, N, G+1)) on
    the graphs' device -- the compact inputs of the banded relaxation.
    """
    f0 = fgs[0]
    N, G, L, lam = f0.ext.n_nodes, f0.gamma, f0.ext.n_blocks, f0.lam
    if not all(fg.ext.n_nodes == N and fg.gamma == G and fg.lam == lam
               and fg.ext.n_blocks == L for fg in fgs):
        raise ValueError("batch_banded_tensors needs one (L, N, gamma, lam) "
                         "shape group")
    E = torch.stack([fg.ext.E for fg in fgs])
    st = torch.stack([fg.steep for fg in fgs])
    d0 = torch.stack([fg.init_depth for fg in fgs])
    iE = torch.stack([fg.ext.init_E for fg in fgs])
    return E, st, _init_grids(d0, iE, G)


def batch_layer_tensors(fgs: Sequence[FeasibleGraph]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked ``layer_matrices`` / ``init_vector`` for a same-shape group.

    Returns (Ws (D, L-1, S, S), init (D, S)) on the graphs' device, byte
    for byte the reference's.  One scatter over the (D, L-1, N, G+1, N)
    admissibility mask (Eq. 4 steepness, the depth budget and the lambda
    window) builds Ws with no boolean filtering: each (source state (n, g),
    target node n2) pair owns the G+1 columns of block n2 in row (n, g),
    so an admissible edge writes its energy at column n2 * (G+1) + g2 and an
    inadmissible one writes +inf at column n2 * (G+1), and no two writes
    land on one entry.
    """
    f0 = fgs[0]
    N, G, L, lam = f0.ext.n_nodes, f0.gamma, f0.ext.n_blocks, f0.lam
    if not all(fg.ext.n_nodes == N and fg.gamma == G and fg.lam == lam
               and fg.ext.n_blocks == L for fg in fgs):
        raise ValueError("batch_layer_tensors needs one (L, N, gamma, lam) "
                         "shape group")
    D, S = len(fgs), N * (G + 1)
    st = torch.stack([fg.steep for fg in fgs])          # (D, L-1, N, N)
    E = torch.stack([fg.ext.E for fg in fgs])
    dev = st.device
    finite = torch.isfinite(st)[:, :, :, None, :]       # (D, L-1, N, 1, N)
    g = torch.arange(G + 1, dtype=st.dtype, device=dev)[:, None]
    g2 = st[:, :, :, None, :] + g                       # (D, L-1, N, G+1, N)
    ok = finite & (g2 <= G)
    if lam < G:
        ok &= (g2 >= G - lam) | (g2 == g)               # Alg. 1, Fn II
    n2 = torch.arange(N, device=dev) * (G + 1)
    col = n2 + torch.where(ok, g2, 0.0).long()
    val = torch.where(ok, E[:, :, :, None, :], _INF)
    Ws = torch.full((D, L - 1, N, G + 1, S), _INF, dtype=E.dtype, device=dev)
    Ws.scatter_(4, col, val)
    d0 = torch.stack([fg.init_depth for fg in fgs])
    iE = torch.stack([fg.ext.init_E for fg in fgs])
    return Ws.reshape(D, L - 1, S, S), _init_grids(d0, iE, G).reshape(D, S)


def _check_gamma_lam(gamma: int, lam: Optional[int]) -> int:
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    lam_ = gamma if lam is None else int(lam)
    if not 1 <= lam_ <= gamma:
        raise ValueError(f"lam must lie in [1, gamma={gamma}], got {lam}")
    return lam_


def build_feasible_graph(ext: ExtendedGraph, gamma: int,
                         *, lam: Optional[int] = None,
                         quantize: str = "floor",
                         delta_eff: Optional[float] = None) -> FeasibleGraph:
    """Function I of Alg. 1: replicate vertices, create Eq. (4) edges, prune."""
    return build_feasible_graphs([ext], gamma, lam=lam, quantize=quantize,
                                 delta_effs=[delta_eff])[0]


def build_feasible_graphs(exts: Sequence[ExtendedGraph], gamma: int,
                          *, lam: Optional[int] = None,
                          quantize: str = "floor",
                          delta_effs: Optional[Sequence[Optional[float]]] = None
                          ) -> List[FeasibleGraph]:
    """Batched Function I: quantize a whole scenario group in one pass.

    Same-shape extended graphs (grouped by (L, N)) have their TT / init_T
    tensors stacked and quantized with a per-scenario delta (``delta_effs``,
    None entries fall back to each scenario's ``req.delta``).  Each returned
    graph holds views into the stacked tensors and is element for element
    identical to the reference's per-scenario build.
    """
    lam_ = _check_gamma_lam(gamma, lam)
    B = len(exts)
    if delta_effs is None:
        delta_effs = [None] * B
    deltas = [ext.req.delta if d is None else float(d)
              for ext, d in zip(exts, delta_effs)]

    out: List[Optional[FeasibleGraph]] = [None] * B
    groups: dict = {}
    for j, ext in enumerate(exts):
        groups.setdefault((ext.n_blocks, ext.n_nodes, ext.device), []
                          ).append(j)
    for (_, _, dev), idxs in groups.items():
        TT = torch.stack([exts[j].TT for j in idxs])           # (D, L-1, N, N)
        mask = torch.stack([exts[j].mask for j in idxs])
        iT = torch.stack([exts[j].init_T for j in idxs])       # (D, N)
        imask = torch.stack([exts[j].init_mask for j in idxs])
        d = torch.tensor([deltas[j] for j in idxs], dtype=torch.float64,
                         device=dev)[:, None, None, None]

        steep = _quant(gamma * TT / d, quantize)
        steep = torch.where(mask, steep, _INF)
        steep = torch.where(steep <= gamma, steep, _INF)

        init_depth = _quant(gamma * iT / d[..., 0, 0], quantize)
        init_depth = torch.where(imask, init_depth, _INF)
        init_depth = torch.where(init_depth <= gamma, init_depth, _INF)

        for pos, j in enumerate(idxs):
            out[j] = FeasibleGraph(ext=exts[j], gamma=gamma, lam=lam_,
                                   quantize=quantize, delta_eff=deltas[j],
                                   steep=steep[pos],
                                   init_depth=init_depth[pos])
    return out
