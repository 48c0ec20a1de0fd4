"""The share of the traced sub-window in which the device is idle while
the host is inside ``serve.decode`` (dispatching the model step): the
device's idle stretches cut to the spans.  Its denominator is
``device_idle_share``'s, so the rest of that metric is the idle time
outside the dispatch.  Spans of ``repro_torch/runtime/tracing.py``; a
program without them, or a trace without device operations, reports
nothing."""
LAYER = "model step dispatch"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "out_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops or tr.window_s <= 0:
        return None
    spans = sorted((o.start, o.end) for o in tr.host_ops
                   if o.name == "serve.decode")
    if not spans:
        return None
    lo, hi = tr.window
    edges = [lo] + [x for iv in tr.busy_intervals() for x in iv] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    both, j = 0.0, 0
    for s, e in spans:                     # both lists sorted and disjoint
        while j < len(idle) and idle[j][1] <= s:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < e:
            both += min(e, idle[k][1]) - max(s, idle[k][0])
            k += 1
    return 100.0 * both / tr.window_s
