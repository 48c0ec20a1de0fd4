"""The host's time to dispatch one model step: the mean duration of the
traced sub-window's ``serve.decode`` spans (``decode_step`` with the
tokens' copy to the device; the kernels run behind it).  Spans of
``repro_torch/runtime/tracing.py``; a program without them reports
nothing."""
LAYER = "model step dispatch"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "out_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    xs = [o.seconds for o in tr.host_ops if o.name == "serve.decode"]
    return 1e3 * sum(xs) / len(xs) if xs else None
