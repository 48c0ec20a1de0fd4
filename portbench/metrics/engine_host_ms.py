"""The engine's own host work a decode step: the traced sub-window's
``serve.step`` spans less their ``serve.decode`` (the model step's
dispatch) and ``serve.gates`` (the exit gates, where the host waits for
the device), over the steps that ran the model (a ``serve.decode`` each;
a parked step's span holds only its check).  The device has nothing
queued meanwhile.  Spans of ``repro_torch/runtime/tracing.py``; a program
without them reports nothing."""
LAYER = "serve engine"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "itl_ms_p95"


def _total(ops, name):
    return sum(o.seconds for o in ops if o.name == name)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = sum(1 for o in tr.host_ops if o.name == "serve.decode")
    if not steps:
        return None
    outer = _total(tr.host_ops, "serve.step")
    inner = _total(tr.host_ops, "serve.decode") + \
        _total(tr.host_ops, "serve.gates")
    return 1e3 * (outer - inner) / steps
