"""Device kernels, copies and sets a decode step (what the host dispatches
for ``models/transformer.decode_step`` and the gates), from the traced
sub-window."""
LAYER = "model step dispatch"
UNIT = "count"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "out_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None or not tr.steps or not tr.device_ops:
        return None
    return len(tr.device_ops) / tr.steps
