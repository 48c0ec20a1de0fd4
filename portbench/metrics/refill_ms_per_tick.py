"""Contingency refill time a churn tick: the total of the traced
sub-window's ``serve.refill`` spans (from ``on_tick`` and from the next
``step()``, on the path of the next token) over its ``serve.tick``
spans.  Spans of ``repro_torch/runtime/tracing.py``; a program without
them, or a window without ticks, reports nothing."""
LAYER = "placement"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "itl_ms_p95"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ticks = sum(1 for o in tr.host_ops if o.name == "serve.tick")
    if not ticks:
        return None
    refill = sum(o.seconds for o in tr.host_ops if o.name == "serve.refill")
    return 1e3 * refill / ticks
