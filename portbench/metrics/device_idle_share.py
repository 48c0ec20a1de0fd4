"""The share of the traced sub-window in which no operation ran on the
device (the union of the kernels', copies' and sets' intervals)."""
LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "out_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
