"""The readers of the program's spans and counters on the tiny cells.

A traced run of each tiny cell on the CPU reports the engine's host time,
the dispatch time and the prompt rows' share; the attention cell reports
B7's held slots and the churn cell the refill time a tick, each finite
and in its range.  The CPU trace has no device operations, so
``idle_in_dispatch_share`` reports nothing.
"""
import math

import pytest

from portbench.tests import tiny

SPAN_METRICS = ("engine_host_ms", "dispatch_ms", "prompt_row_share")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("trace"))


@pytest.mark.parametrize("cell, also", [
    ("tiny.moe.chat", ("decode_attn_held_share",)),
    ("tiny.ssm.chat", ()),
    ("tiny.moe.churn", ("decode_attn_held_share", "refill_ms_per_tick"))])
def test_a_traced_run_reports_the_programs_spans_and_counters(root, cell,
                                                              also):
    res = tiny.run(root, cell, seconds=1.0, trace=True)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in SPAN_METRICS + also:
        assert name in m and math.isfinite(m[name]), (name, m)
    assert m["engine_host_ms"] > 0 and m["dispatch_ms"] > 0
    for name in ("prompt_row_share", "decode_attn_held_share"):
        if name in m:
            assert 0 < m[name] <= 100, (name, m[name])
    assert m.get("refill_ms_per_tick", 0) >= 0
    assert "idle_in_dispatch_share" not in m
    if not also:
        assert "decode_attn_held_share" not in m
