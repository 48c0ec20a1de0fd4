"""The share of the cache slots that the decode attention kernel (B7,
``kernels/decode_attn``) read in the traced steps which held a position
the attention may use: the kernel's ``slots_held`` over ``slots_read``
counters, as ``SplitServeEngine`` records their deltas a step in its
``trace_records`` (``repro_torch/runtime/tracing.py`` ``StepRecord``),
taken at the traced sub-window's positions.  A program without them, or
a model without attention, reports nothing."""
LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "out_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    pos = set(tr.step_pos)
    recs = [r for r in getattr(run.loop.eng, "trace_records", ())
            if r.pos in pos]
    read_ = sum(r.slots_read for r in recs)
    if not read_:
        return None
    return 100.0 * sum(r.slots_held for r in recs) / read_
