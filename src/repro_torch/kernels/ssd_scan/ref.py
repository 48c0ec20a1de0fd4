"""Plain PyTorch version of the SSD chunked-scan kernel (B9).

Port of the reference's ``models.ssm._ssd_scan``
(``repro/models/ssm.py:87-140``), an XLA program in the reference: the
sequence cut into chunks of Q; within a chunk the recurrence in its
quadratic "dual" form, across chunks a float32 [B, H, P, N] state carried
by a loop (the reference's ``lax.scan``), with n_groups = 1 and a scalar
decay per head.  Every product the reference keeps in float32
(``preferred_element_type``) runs on float32 operands.  The CPU path of
the port runs on it, the CUDA kernel is held to it on the card, and the
kernel's autograd Function differentiates it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32


def ssd_scan_ref(xh: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, a_log: torch.Tensor, *, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xh: [B, S, H, P]; Bm / Cm: [B, S, N]; dt: [B, S, H]
    (post-softplus, float32); a_log: [B, S, H] = log a_t (negative).

    S is zero-padded to a multiple of Q = min(chunk, S).  Returns
    (y [B, S, H, P] in xh's dtype, the final float32 state [B, H, P, N])."""
    Bsz, S, H, P = xh.shape
    S_orig = S
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
        dt, a_log = (F.pad(t, (0, 0, 0, pad)) for t in (dt, a_log))
        S += pad
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    zero = torch.zeros((), dtype=F32, device=xh.device)
    state = torch.zeros((Bsz, H, P, N), dtype=F32, device=xh.device)
    ys = []
    for c0 in range(0, S, Q):
        x = xh[:, c0:c0 + Q]
        b = Bm[:, c0:c0 + Q].to(F32)
        c = Cm[:, c0:c0 + Q].to(F32)
        la = torch.cumsum(a_log[:, c0:c0 + Q], dim=1)          # [B,Q,H]
        xdt = x * dt[:, c0:c0 + Q, :, None]                    # [B,Q,H,P] f32
        # intra-chunk (quadratic dual form)
        G = torch.bmm(c, b.transpose(1, 2))                    # [B,q,s]
        seg = torch.exp(la[:, :, None, :] - la[:, None, :, :])  # [B,q,s,H]
        seg = torch.where(causal[None, :, :, None], seg, zero)
        M = G[..., None] * seg                                 # [B,q,s,H]
        y_intra = torch.einsum("bqsh,bshp->bqhp", M, xdt)
        # inter-chunk via the carried state
        y_inter = torch.einsum("bqn,bhpn->bqhp", c, state) \
            * torch.exp(la)[..., None]
        # state update
        la_last = la[:, -1:, :]                                # [B,1,H]
        decay_rest = torch.exp(la_last - la)                   # [B,Q,H]
        chunk_state = torch.einsum("bqhp,bqn->bhpn",
                                   xdt * decay_rest[..., None], b)
        state = state * torch.exp(la_last)[:, 0, :, None, None] + chunk_state
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :S_orig], state


def ssd_scan_passes_ref(xh: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, *, chunk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror of the CUDA kernel's three passes, for the tests: the chunk
    states (and C·Bᵀ, shared by the heads), the sequential pass leaving
    each chunk the state that enters it, then the chunk outputs, over
    chunks of Q = min(chunk, S) whose last one is shorter (no padded
    copy).  Same arguments and result as :func:`ssd_scan_ref`."""
    Bsz, S, H, P = xh.shape
    Q = min(chunk, S)
    x, b, c = xh.to(F32), Bm.to(F32), Cm.to(F32)
    spans = [(c0, min(S, c0 + Q)) for c0 in range(0, S, Q)]
    las, gs, chunk_states = [], [], []
    for c0, c1 in spans:                                   # pass 1
        la = torch.cumsum(a_log[:, c0:c1], dim=1)          # [B,L,H]
        xdt = x[:, c0:c1] * dt[:, c0:c1, :, None]
        decay = torch.exp(la[:, -1:] - la)
        chunk_states.append(torch.einsum(
            "bshp,bsn->bhpn", xdt * decay[..., None], b[:, c0:c1]))
        gs.append(torch.einsum("bqn,bsn->bqs", c[:, c0:c1], b[:, c0:c1]))
        las.append(la)
    state = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=F32,
                        device=xh.device)
    states_in = []
    for la, cs in zip(las, chunk_states):                  # pass 2
        states_in.append(state)
        state = state * torch.exp(la[:, -1])[:, :, None, None] + cs
    ys = []
    for (c0, c1), la, g, s_in in zip(spans, las, gs, states_in):  # pass 3
        L = c1 - c0
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=xh.device))
        seg = torch.exp(la[:, :, None, :] - la[:, None, :, :])
        M = torch.where(causal[None, :, :, None], g[..., None] * seg, 0.0)
        xdt = x[:, c0:c1] * dt[:, c0:c1, :, None]
        y = torch.einsum("bqsh,bshp->bqhp", M, xdt) + torch.einsum(
            "bqn,bhpn->bqhp", c[:, c0:c1], s_in) * torch.exp(la)[..., None]
        ys.append(y.to(xh.dtype))
    return torch.cat(ys, dim=1), state
