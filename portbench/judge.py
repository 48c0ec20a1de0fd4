"""What decides ``correct``: the program's served tokens against the plain
reference, and, under churn, the placements in force against the
reference's placement model.

Served tokens.  Once the window has closed, a sample of the finished
requests is drawn from the seed, the longest among them, then others in a
seeded order until ``check_tokens`` served tokens and ``check_rows`` slot
rows are in it.  Every slot
row of the engine is one token stream from position 0 (all rows share the
position, and a recycled slot keeps what its last request left in the
caches), so the reference runs each sampled row's whole stream and reads
every head at the positions where the row's finished requests took a
token.  Two numbers are compared, each the mean over those tokens:

* ``token_gap_mean``: by how much the served token's logit lies below the
  reference's best, at the exit the program took;
* ``exit_gap_mean``: by how much the exit taken breaks first-exit-wins in
  the reference's confidences (log units): an earlier exit whose log
  confidence reached its log threshold, or a taken early exit whose log
  confidence fell short of it.

The widest of each (``token_gap``, ``exit_gap``), the 99th percentile of
the first and the shares of tokens and exits that differ from the
reference's own choice are readings, not compared: with random weights a
router's top-2 can flip on a rounding, which moves one token's logits by
whole units in bf16 as in any lower precision, so the widest gap swings
from seed to seed and does not part the program from the control.

The control is the reference in fp8 (``reference.lm``, ``quant="fp8"``) put
in the program's place on the same streams: it takes its own exits and
tokens, and its gaps are read in the float32 reference.

Placements (churn cells).  The reference replays the ticks onto its copy
of the scenario and evaluates the placement in force after each tick:
``placement_faults`` counts ticks served neither degraded nor paused on an
infeasible placement, ticks served degraded or paused where the
reference's enumeration finds a feasible placement, and ticks served
degraded on a placement that uses a failed node; ``placement_excess`` is the worst energy above the
optimum, as a share, over the ticks where the placement had to move (a
failure or a recovery, or an incumbent infeasible or out of its
hysteresis band around the energy of the last move) or moved.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .reference import lm as RLM
from .reference import placement as RPL

BAND_TOL = 1e-9


@dataclass
class Sample:
    tokens: torch.Tensor            # [R, P] the rows' streams
    rows: torch.Tensor              # [n] index into tokens' rows
    positions: torch.Tensor         # [n]
    exits: torch.Tensor             # [n] exit the program took
    served: torch.Tensor            # [n] token the program served


def sample(loop, seed: int, check_tokens: int, check_rows: int) -> Sample:
    """The rows to replay and the served tokens to judge."""
    done = [i for i in loop.infos if i.t_done is not None]
    if not done:
        raise RuntimeError("no request finished: nothing to compare")
    rng = np.random.default_rng([seed, 2])
    longest = max(done, key=lambda i: (len(i.req.tokens), -i.index))
    order = [done[int(j)] for j in rng.permutation(len(done))]
    chosen, total = [longest], len(longest.req.tokens)
    rows = {longest.row}
    for info in order:
        if total >= check_tokens and len(rows) >= check_rows:
            break
        if info is not longest and (info.row not in rows
                                    or total < check_tokens):
            chosen.append(info)
            total += len(info.req.tokens)
            rows.add(info.row)
    end: Dict[int, int] = {}
    for info in chosen:
        last = info.p0 + len(info.req.prompt) + len(info.req.tokens) - 1
        end[info.row] = max(end.get(info.row, 0), last)
    rows = sorted(end)
    P = max(end.values())
    streams = np.zeros((len(rows), P), np.int64)
    sel_r, sel_p, sel_e, sel_t = [], [], [], []
    for info in done:
        if info.row not in end:
            continue
        r = info.req
        fed = list(r.prompt) + list(r.tokens[:-1])
        stop = info.p0 + len(fed)
        if stop > end[info.row]:
            continue                        # past the row's checked part
        k = rows.index(info.row)
        streams[k, info.p0:stop] = fed
        first = info.p0 + len(r.prompt) - 1
        for j, (tok, ex) in enumerate(zip(r.tokens, r.exits_taken)):
            sel_r.append(k)
            sel_p.append(first + j)
            sel_e.append(ex)
            sel_t.append(tok)
    as_t = lambda x: torch.as_tensor(np.asarray(x, np.int64))  # noqa: E731
    return Sample(torch.as_tensor(streams), as_t(sel_r), as_t(sel_p),
                  as_t(sel_e), as_t(sel_t))


def _gaps(ref: Dict[str, torch.Tensor], names: List[str],
          exits: torch.Tensor, served: torch.Tensor,
          thresholds: List[float]) -> Dict[str, float]:
    n = exits.shape[0]
    logits = torch.stack([ref[k] for k in names])             # [X, n, V]
    at = logits[exits, torch.arange(n)]                        # [n, V]
    gap = at.amax(-1) - at.gather(1, served[:, None])[:, 0]
    lc = torch.stack([RLM.log_confidence(ref[k]) for k in names[:-1]], 1)
    lt = torch.log(torch.tensor(thresholds, dtype=lc.dtype))
    early = torch.arange(len(names) - 1)[None, :]
    skipped = (early < exits[:, None]) * (lc - lt).clamp_min(0)
    taken = (early == exits[:, None]) * (lt - lc).clamp_min(0)
    exit_gap = torch.maximum(skipped, taken).amax(-1)
    ref_exit = RLM.choose_exits(ref, names, thresholds)
    return {"token_gap_mean": float(gap.mean()),
            "token_gap": float(gap.max()),
            "token_gap_p99": float(torch.quantile(gap, 0.99)),
            "token_mismatch": float((gap > 0).float().mean()),
            "exit_gap_mean": float(exit_gap.mean()),
            "exit_gap": float(exit_gap.max()),
            "exit_mismatch": float((ref_exit != exits).float().mean())}


def judge_tokens(spec: RLM.ModelSpec, params: dict, smp: Sample,
                 thresholds: List[float], device, *,
                 control: bool = False) -> Dict[str, float]:
    """The program's numbers, and with ``control`` the fp8 control's."""
    names = RLM.heads_order(spec)
    args = (spec, params, smp.tokens.to(device), smp.rows.to(device),
            smp.positions.to(device))
    ref = {k: v.cpu() for k, v in RLM.forward(*args).items()}
    out = _gaps(ref, names, smp.exits, smp.served, thresholds)
    out["tokens_checked"] = float(smp.exits.shape[0])
    if control:
        low = {k: v.cpu() for k, v in RLM.forward(*args, quant="fp8").items()}
        ex = RLM.choose_exits(low, names, thresholds)
        stacked = torch.stack([low[k] for k in names])
        tok = RLM.first_argmax(stacked[ex, torch.arange(ex.shape[0])])
        ctl = _gaps(ref, names, ex, tok, thresholds)
        out.update({f"control_{k}": v for k, v in ctl.items()})
    return out


def judge_placements(data: dict, ticks, uplink_bps: float,
                     hysteresis: float, initial: tuple) -> Dict[str, float]:
    """``placement_faults`` and ``placement_excess`` over the ticks.

    The reference decides itself when the engine has to re-split: at a
    failure or a recovery, and where the incumbent turned infeasible or
    left its hysteresis band; the placement then in force has to be the
    optimum's energy.  Otherwise the incumbent may be held.  The engine
    may degrade or pause only where no placement is feasible, and a
    degraded placement avoids the failed nodes."""
    state = RPL.base_network(data)
    prof = RPL.Profile(data)
    req = data["req"]
    faults, excess, degraded = 0, 0.0, 0
    place, k = initial

    def optimal_excess(ev) -> float:
        best = RPL.optimum(state, prof, req)[0]
        return ev.energy / best - 1.0

    ev = RPL.evaluate(state, prof, req, place, k)
    faults += int(not ev.feasible)
    excess = max(excess, optimal_excess(ev)) if ev.feasible else excess
    band = ev.energy if ev.feasible else None
    prev = (list(place), k)
    for t in ticks:
        failed = set(state.failed)
        RPL.apply_tick(state, t.events, uplink_bps)
        topology = state.failed != failed
        if t.degraded or t.paused:
            degraded += 1
            faults += int(RPL.optimum(state, prof, req)[0] < RPL.INF
                          or (t.degraded
                              and bool(state.failed & set(t.placement))))
            band, prev = None, (t.placement, t.final_exit)
            continue
        ev = RPL.evaluate(state, prof, req, t.placement, t.final_exit)
        if not ev.feasible:
            faults += 1
            band, prev = None, (t.placement, t.final_exit)
            continue
        inc = RPL.evaluate(state, prof, req, *prev)
        must_move = (topology or band is None or not inc.feasible
                     or inc.energy > band * (1 + hysteresis) * (1 + BAND_TOL))
        if must_move or (t.placement, t.final_exit) != prev:
            excess = max(excess, optimal_excess(ev))
            band = ev.energy
        prev = (t.placement, t.final_exit)
    return {"placement_faults": float(faults),
            "placement_excess": float(excess),
            "degraded_ticks": float(degraded)}
