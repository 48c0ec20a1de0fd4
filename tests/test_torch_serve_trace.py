"""The serving engine's spans and per-step records (``runtime/tracing.py``).

Under a CPU profiler a short run of the reduced qwen3-4b engine, with churn
ticks that hold, re-solve, fail and recover, records every span of the
serving path as a host event of function scope (no user annotation, so no
device copy on CUDA), nested as the layers are; each step's record counts
its rows exactly and carries the decode attention kernel's slot counters
(B x T and B x min(pos + 1, T) a call, one call an attention layer).  With
no profiler running nothing is recorded, and a traced run serves exactly
what an untraced one does.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get
from repro_torch.core import AppRequirements, paper_profile
from repro_torch.core.scenarios import ChurnEvent, paper_scenario
from repro_torch.kernels.decode_attn.ops import decode_attn, held_slots
from repro_torch.models import transformer as T
from repro_torch.runtime import tracing
from repro_torch.runtime.serve_engine import SplitServeEngine

B = 4
CACHE = 64
STEP_SPANS = ("serve.admit", "serve.decode", "serve.gates", "serve.emit")
TICK_SPANS = ("plan.channel", "plan.hold", "plan.resolve", "plan.failover")
#: ticks that hold the placement, leave the band (a re-solve), fail node 1
#: (a library hit) and recover it
TICKS = [[ChurnEvent("uplink", None, 1.0)],
         [ChurnEvent("uplink", None, 0.3)],
         [ChurnEvent("uplink", None, 0.3), ChurnEvent("fail", None, 1)],
         [ChurnEvent("uplink", None, 0.3), ChurnEvent("recover", None, 1)]]


@pytest.fixture(scope="module")
def model():
    cfg = get("qwen3-4b", reduced=True)
    return cfg, T.init_model(cfg, seed=0, device="cpu")


def _engine(model):
    cfg, params = model
    eng = SplitServeEngine(
        cfg, params, batch_size=B, cache_len=CACHE, thresholds=[0.05],
        network=paper_scenario(uplink_bps=1e9), profile=paper_profile("h1"),
        req=AppRequirements(alpha=0.55, delta=5e-3), on_infeasible="degrade",
        device="cpu")
    reqs = [eng.submit([1 + i, 2, 3, 4][:2 + i % 3], 3 + i % 2)
            for i in range(6)]
    return eng, reqs


def _serve(eng, reqs):
    """Two steps after each tick; each step's rows as the requests show
    them: (emitting, feeding a prompt, empty)."""
    rows = []
    for events in TICKS:
        eng.on_tick(events, uplink_bps=1e9)
        for _ in range(2):
            before = [len(r.tokens) for r in reqs]
            eng.step()
            grew = [r for r, n in zip(reqs, before) if len(r.tokens) > n]
            during = {id(r) for r in eng.slots if r is not None} | \
                {id(r) for r in grew if r.done}
            rows.append((len(grew), len(during) - len(grew),
                         B - len(during)))
    return rows


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events()
                 if e.name.startswith(("serve.", "plan."))]


def _inside(e, outer):
    return any(o.time_range.start <= e.time_range.start and
               e.time_range.end <= o.time_range.end for o in outer)


@pytest.fixture(scope="module")
def traced(model):
    eng, reqs = _engine(model)
    rows, events = _profiled(lambda: _serve(eng, reqs))
    return eng, reqs, rows, events


def test_every_span_is_a_host_event_of_function_scope(traced):
    _, _, _, events = traced
    names = {e.name for e in events}
    assert names == {"serve.step", "serve.refill", "serve.tick",
                     *STEP_SPANS, *TICK_SPANS}
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU, e.name
        assert not e.is_user_annotation, e.name


def test_spans_nest_as_the_layers_do(traced):
    _, _, _, events = traced
    by = {}
    for e in events:
        by.setdefault(e.name, []).append(e)
    assert len(by["serve.step"]) == 2 * len(TICKS)
    assert len(by["serve.tick"]) == len(TICKS)
    for name in STEP_SPANS:
        assert len(by[name]) == len(by["serve.step"]), name
        assert all(_inside(e, by["serve.step"]) for e in by[name]), name
    for name in TICK_SPANS:
        assert all(_inside(e, by["serve.tick"]) for e in by[name]), name
    assert all(_inside(e, by["serve.tick"] + by["serve.step"])
               for e in by["serve.refill"])
    assert any(_inside(e, by["serve.tick"]) for e in by["serve.refill"])


def test_each_step_record_counts_its_rows(traced, model):
    eng, _, rows, _ = traced
    cfg, _ = model
    recs = eng.trace_records
    assert [r.pos for r in recs] == list(range(len(rows)))
    assert [(r.emit_rows, r.prompt_rows, B - r.emit_rows - r.prompt_rows)
            for r in recs] == rows
    assert sum(r.emit_rows for r in recs) == eng.stats.tokens_out
    assert any(r.prompt_rows for r in recs) and any(r.emit_rows for r in recs)
    attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.pattern)
    for r in recs:
        assert r.slots_read == attn * B * CACHE
        assert r.slots_held == attn * B * min(r.pos + 1, CACHE)


def test_no_profiler_no_record_and_the_same_service(traced, model):
    eng_on, reqs_on, _, _ = traced
    eng, reqs = _engine(model)
    assert not tracing.tracing()
    assert tracing.span("serve.step") is tracing.span("serve.emit")
    _serve(eng, reqs)
    assert eng.trace_records == []
    assert dataclasses.asdict(eng.stats) == dataclasses.asdict(eng_on.stats)
    assert [(r.tokens, r.exits_taken, r.done) for r in reqs] == \
        [(r.tokens, r.exits_taken, r.done) for r in reqs_on]
    assert eng.placement.placement == eng_on.placement.placement


@pytest.mark.parametrize("T_, pos, window", [
    (16, 0, 0), (16, 5, 0), (16, 15, 0), (16, 40, 0), (16, 40, 8),
    (16, 3, 8), (8, 40, 16)])
def test_decode_attn_counts_the_slots_it_covers_and_those_held(T_, pos,
                                                                window):
    g = torch.Generator().manual_seed(pos)
    q = torch.randn(3, 4, 16, generator=g)
    k = torch.randn(3, T_, 2, 16, generator=g)
    v = torch.randn(3, T_, 2, 16, generator=g)
    cache_pos = torch.full((T_,), -1, dtype=torch.int32)
    for p in range(max(0, pos + 1 - T_), pos + 1):
        cache_pos[p % T_] = p
    read0, held0 = decode_attn.slots_read, decode_attn.slots_held
    decode_attn(q, k, v, cache_pos, pos, window=window)
    live = ((cache_pos >= 0) & (cache_pos <= pos))
    if window > 0:
        live &= cache_pos > pos - window
    assert held_slots(T_, pos, window) == int(live.sum())
    assert decode_attn.slots_read - read0 == 3 * T_
    assert decode_attn.slots_held - held0 == 3 * int(live.sum())


def test_decode_attn_counts_the_slots_its_split_plan_covers(monkeypatch):
    """``slots_read`` is summed over the plan's slot ranges, so a plan that
    skips the slots holding no position moves it (here: positions 0-5 of a
    ring of 16, read by two ranges that stop at slot 6)."""
    from repro_torch.kernels.decode_attn import ops
    q, k, v = torch.zeros(2, 4, 16), torch.zeros(2, 16, 2, 16), \
        torch.zeros(2, 16, 2, 16)
    cache_pos = torch.full((16,), -1, dtype=torch.int32)
    cache_pos[:6] = torch.arange(6, dtype=torch.int32)
    monkeypatch.setattr(ops, "split_ranges", lambda T, P: [(0, 3), (3, 6)])
    read0, held0 = decode_attn.slots_read, decode_attn.slots_held
    decode_attn(q, k, v, cache_pos, 5)
    assert decode_attn.slots_read - read0 == 2 * 6
    assert decode_attn.slots_held - held0 == 2 * 6
