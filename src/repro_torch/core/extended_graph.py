"""Single-plane extended graph G (Sec. II-B) as float64 tensors on a device.

Port of ``repro/core/extended_graph.py``.  Vertices are (node n, block l_i)
pairs; the DNNs are chains, so G is a layered DAG stored as dense
per-transition tensors (N = #nodes, L = #blocks):

  C[i, n]            compute time of block i (backbone + attached exit) on n
  T[i, n, n']        transfer time of cut i from n to n' (0 on diagonal)
  E[i, n, n']        expected energy of edge ((n, l_i) -> (n', l_{i+1}))
  TT[i, n, n']       latency of the same edge: T[i, n, n'] + C[i+1, n']
  mask[i, n, n']     edge admissibility after local pruning (3d)-(3e)
  init_{T,E,mask}[n] source -> (n, l_0) edge (input transfer + block-0 compute)

Every tensor is byte-equal to the reference's numpy array: each expression
keeps numpy's association and broadcasting order, and every division is
tensor by tensor (a Python scalar divisor or dividend would let PyTorch
multiply by a rounded reciprocal instead).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .dnn_profile import DNNProfile
from .problem import AppRequirements
from .system_model import Network

_F64 = torch.float64
_INF = float("inf")
_NAN = float("nan")


@dataclass
class ExtendedGraph:
    network: Network
    profile: DNNProfile
    req: AppRequirements

    C: torch.Tensor          # (L, N) compute time per block per node
    T: torch.Tensor          # (L-1, N, N) cut transfer time
    E: torch.Tensor          # (L-1, N, N) expected edge energy
    TT: torch.Tensor         # (L-1, N, N) edge latency T + C[next]
    mask: torch.Tensor       # (L-1, N, N) bool, edge admissible
    init_T: torch.Tensor     # (N,) source-edge latency (input transfer + C[0])
    init_E: torch.Tensor     # (N,) source-edge expected energy
    init_mask: torch.Tensor  # (N,) bool
    surv_in: np.ndarray      # (L,) survival entering block i (host)
    surv_out: np.ndarray     # (L,) survival after block i's exit (host)
    acc_seq: np.ndarray      # (L,) accuracy of deepest exit at block <= i

    @property
    def n_nodes(self) -> int:
        return self.network.n_nodes

    @property
    def n_blocks(self) -> int:
        return self.profile.n_blocks

    @property
    def device(self) -> torch.device:
        return self.E.device


def _profile_tensors(profile: DNNProfile):
    """Per-profile host vectors shared by every scenario using the profile
    (ops per block include the attached exit head: all deployed exits run)."""
    L = profile.n_blocks
    kmax = profile.n_exits - 1
    ops = np.array([profile.block_ops_with_exit(i, kmax) for i in range(L)])
    surv_in = np.array([profile.survival_entering_block(i, kmax)
                        for i in range(L)])
    surv_out = np.array([profile.survival_after_block(i, kmax)
                         for i in range(L)])
    cut_bits = np.asarray(profile.cut_bits, dtype=np.float64)
    acc_seq = np.zeros(L)
    best = 0.0
    for i in range(L):
        e = profile.exit_at(i)
        if e is not None:
            best = max(best, e.accuracy)
        acc_seq[i] = best
    return ops, surv_in, surv_out, cut_bits, acc_seq


def build_extended_graph(network: Network, profile: DNNProfile,
                         req: AppRequirements, *,
                         device: DeviceLike = None) -> ExtendedGraph:
    """One scenario's extended graph on ``device`` (default ``cuda:0``)."""
    return build_extended_graphs([network], [profile], [req],
                                 device=device)[0]


def build_extended_graphs(networks: Sequence[Network],
                          profiles: Sequence[DNNProfile],
                          requirements: Sequence[AppRequirements], *,
                          device: DeviceLike = None) -> List[ExtendedGraph]:
    """Batched stage-1 construction for B scenarios (parallel lists).

    Scenarios sharing (network, profile, sigma) are deduplicated -- they get
    the *same* ``ExtendedGraph`` object.  The unique scenarios are grouped by
    (profile, node count) and each group is built in one pass over stacked
    (D, N, N) bandwidth / (D, N) compute tensors on the device.  Element for
    element identical to the reference's ``build_extended_graph`` per
    scenario.
    """
    dev = resolve_device(device)
    B = len(networks)
    if len(profiles) != B or len(requirements) != B:
        raise ValueError("networks, profiles and requirements must have one "
                         "entry per scenario")
    out: List[Optional[ExtendedGraph]] = [None] * B

    unique: Dict[Tuple[int, int, float], List[int]] = {}
    for b, (nw, pf, rq) in enumerate(zip(networks, profiles, requirements)):
        unique.setdefault((id(nw), id(pf), rq.sigma), []).append(b)

    groups: Dict[Tuple[int, int], List[Tuple[int, int, float]]] = {}
    for key in unique:
        b0 = unique[key][0]
        groups.setdefault((id(profiles[b0]), networks[b0].n_nodes),
                          []).append(key)

    def t(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)

    for (_, N), keys in groups.items():
        reps = [unique[k][0] for k in keys]          # one scenario per key
        profile = profiles[reps[0]]
        ops_h, surv_in_h, surv_out_h, cut_bits_h, acc_seq = \
            _profile_tensors(profile)
        ops, surv_in, surv_out, cut_bits = map(
            t, (ops_h, surv_in_h, surv_out_h, cut_bits_h))
        D = len(reps)

        bw = t(np.stack([networks[b].bandwidth for b in reps]))   # (D, N, N)
        comp_raw = t(np.stack([networks[b].compute for b in reps]))
        p_act = t(np.stack([networks[b].power_active for b in reps]))
        e_tx = t(np.stack([networks[b].e_tx for b in reps]))
        e_rx = t(np.stack([networks[b].e_rx for b in reps]))
        src = torch.as_tensor([networks[b].source_node for b in reps],
                              device=dev)
        sigma = t([requirements[b].sigma for b in reps])
        comp = torch.where(comp_raw > 0, comp_raw, _INF)

        eye = torch.eye(N, dtype=torch.bool, device=dev)
        C = ops[None, :, None] / comp[:, None, :]                # (D, L, N)

        link_ok = (bw > 0) | eye[None]
        bw_eff = torch.where(link_ok, torch.where(eye[None], _INF, bw), _NAN)
        bw_eff[:, eye] = _INF

        T = cut_bits[:-1, None, None][None] / bw_eff[:, None]    # (D, L-1, N, N)
        T = torch.where(torch.isnan(T), _INF, T)
        T[:, :, eye] = 0.0

        pair_e = e_tx[:, :, None] + e_rx[:, None, :]             # (D, N, N)
        comm_E = (surv_out[:-1, None, None] * cut_bits[:-1, None, None]
                  )[None] * pair_e[:, None]
        comm_E[:, :, eye] = 0.0
        comp_E = surv_in[1:, None][None] * p_act[:, None, :] * C[:, 1:, :]
        E = comm_E + comp_E[:, :, None, :]                       # (D, L-1, N, N)

        TT = T + C[:, 1:, :][:, :, None, :]

        load_bits = (sigma[:, None, None, None]
                     * surv_out[:-1, None, None][None]
                     * cut_bits[:-1, None, None][None])
        bw_fits = load_bits <= torch.where(eye[None], _INF, bw)[:, None]
        bw_fits |= eye[None, None]
        comp_fits = (sigma[:, None, None] * surv_in[1:][None, :, None]
                     * ops[1:][None, :, None]) <= comp[:, None, :]
        mask = link_ok[:, None] & bw_fits & comp_fits[:, :, None, :]

        in_bits = t(profile.input_bits)
        d_i = torch.arange(D, device=dev)
        is_src = torch.arange(N, device=dev)[None, :] == src[:, None]
        b_src = torch.where(is_src, _INF, bw[d_i, src])          # (D, N)
        init_T = in_bits / torch.where(b_src > 0, b_src, _NAN) + C[:, 0]
        init_T = torch.where(torch.isnan(init_T), _INF, init_T)
        init_comm = torch.where(is_src, 0.0,
                                (e_tx[d_i, src][:, None] + e_rx) * in_bits)
        init_E = init_comm + surv_in[0] * p_act * C[:, 0]
        init_mask = ((b_src > 0)
                     & (sigma[:, None] * in_bits <= b_src)
                     & (sigma[:, None] * surv_in[0] * ops[0] <= comp))

        for pos, key in enumerate(keys):
            b0 = unique[key][0]
            ext = ExtendedGraph(
                network=networks[b0], profile=profile,
                req=requirements[b0],
                C=C[pos], T=T[pos], E=E[pos], TT=TT[pos], mask=mask[pos],
                init_T=init_T[pos], init_E=init_E[pos],
                init_mask=init_mask[pos],
                surv_in=surv_in_h, surv_out=surv_out_h, acc_seq=acc_seq,
            )
            for b in unique[key]:
                out[b] = ext
    return out


def to_networkx(g: ExtendedGraph):
    """The extended graph as a networkx DiGraph (cross-validation of the DP
    against Dijkstra): a ``"src"`` vertex, a vertex ``(block, node)`` per
    state, and each admissible edge with its ``energy`` and ``latency``.
    networkx is imported here, not with the module."""
    import networkx as nx

    init_mask, init_E, init_T = (t.cpu().numpy() for t in
                                 (g.init_mask, g.init_E, g.init_T))
    mask, E, TT = (t.cpu().numpy() for t in (g.mask, g.E, g.TT))
    G = nx.DiGraph()
    G.add_node("src")
    N, L = g.n_nodes, g.n_blocks
    for n in range(N):
        if init_mask[n]:
            G.add_edge("src", (0, n), energy=float(init_E[n]),
                       latency=float(init_T[n]))
    for i in range(L - 1):
        for n in range(N):
            for n2 in range(N):
                if mask[i, n, n2]:
                    G.add_edge((i, n), (i + 1, n2), energy=float(E[i, n, n2]),
                               latency=float(TT[i, n, n2]))
    return G
