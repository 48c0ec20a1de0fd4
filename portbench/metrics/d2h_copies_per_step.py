"""Device-to-host copies a decode step (the exit gates' (conf, argmax) and
every other read-back of ``SplitServeEngine.step``), from the traced
sub-window's device operations."""
LAYER = "serve engine"
UNIT = "count"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "itl_ms_p95"


def read(run):
    tr = run.trace
    if tr is None or not tr.steps or not tr.device_ops:
        return None
    return len(tr.named("DtoH")) / tr.steps
