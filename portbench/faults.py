"""Faults planted under the timed path, to show that ``correct`` comes out
false: ``run.py --fault <name>`` on the card at a cell's own size, and the
folder's tests at CPU sizes.

Each fault is called with the set-up, before the warm-up steps, and with
the function that sets an attribute (``setattr``, or a test's
``monkeypatch.setattr``, which undoes it).  A fault always wraps the
program's own function, so planting it again in the same process, on the
next seed, plants it once.

* ``state_unchanged``: every decode step leaves the caches as they were
  (for attention, the ring slot the step writes; for SSM layers, the
  whole state);
* ``half_batch``: the second half of the batch is served the first half's
  logits;
* ``token_altered``: the gate's token is moved by one where it is made;
* ``stale_tick``: a churn tick applies nothing and keeps the placement;
* ``always_degrades``: a churn tick applies its events to the plan and
  then, with no solve, takes the degraded path (the cheapest row of the
  last feasible frontier that avoids the failed nodes).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

_ORIGINAL: Dict[str, Callable] = {}


def _original(module, name: str) -> Callable:
    key = f"{module.__name__}.{name}"
    if key not in _ORIGINAL:
        _ORIGINAL[key] = getattr(module, name)
    return _ORIGINAL[key]


def _ring_slots(caches: dict, pos: int) -> list:
    """(tensor, index, saved copy) for the part of each cache leaf that a
    step at ``pos`` writes."""
    out = []
    for layer in caches.values():
        if "k" in layer:                       # attention: one ring slot
            T = layer["k"].shape[2]
            for name in ("k", "v"):
                out.append((layer[name], (slice(None), slice(None), pos % T),
                            layer[name][:, :, pos % T].clone()))
            out.append((layer["pos"], (slice(None), pos % T),
                        layer["pos"][:, pos % T].clone()))
        else:                                  # SSM: the whole state
            for x in layer.values():
                out.append((x, (Ellipsis,), x.clone()))
    return out


def state_unchanged(setup, put=setattr) -> None:
    from repro_torch.models import transformer as T
    step = _original(T, "decode_step")

    def frozen(params, cfg, tokens, caches, pos):
        saved = _ring_slots(caches, pos)
        logits, caches, exits = step(params, cfg, tokens, caches, pos)
        with torch.no_grad():
            for x, index, old in saved:
                x[index] = old
        return logits, caches, exits
    put(T, "decode_step", frozen)


def half_batch(setup, put=setattr) -> None:
    from repro_torch.models import transformer as T
    step = _original(T, "decode_step")

    def half(params, cfg, tokens, caches, pos):
        logits, caches, exits = step(params, cfg, tokens, caches, pos)
        h = tokens.shape[0] // 2
        for x in [logits, *exits.values()]:
            x[h:] = x[:x.shape[0] - h].clone()
        return logits, caches, exits
    put(T, "decode_step", half)


def token_altered(setup, put=setattr) -> None:
    from repro_torch.runtime import serve_engine as SE
    gate = _original(SE, "ee_gate")

    def altered(logits):
        conf, arg = gate(logits)
        return conf, torch.where(arg > 0, arg - 1, arg + 1)
    put(SE, "ee_gate", altered)


def _report(eng) -> dict:
    return {"resplit": False, "held": True, "n_fail": 0, "n_recover": 0,
            "contingency_hits": 0, "contingency_misses": 0,
            "paused": eng.paused, "degraded": eng.degraded}


def stale_tick(setup, put=setattr) -> None:
    eng = setup.eng
    put(eng, "on_tick", lambda events, uplink_bps: _report(eng))


def always_degrades(setup, put=setattr) -> None:
    eng = setup.eng

    def on_tick(events, uplink_bps):
        for ev in events:
            if ev.kind == "uplink":
                eng.plan.update_uplink(uplink_bps * float(ev.value))
            elif ev.kind == "fail":
                eng.plan.mask_node(int(ev.value))
            elif ev.kind == "recover":
                eng.plan.unmask_node(int(ev.value))
        eng._handle_infeasible(eng.placement)
        return _report(eng)
    put(eng, "on_tick", on_tick)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered, "stale_tick": stale_tick,
          "always_degrades": always_degrades}
#: the faults that only a churn cell can have
CHURN_FAULTS = ("stale_tick", "always_degrades")
