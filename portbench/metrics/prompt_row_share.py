"""The share of the occupied rows of the traced steps that fed a prompt
token instead of emitting one (the engine consumes prompts one token a
step in the rows that generate).  Counted by ``SplitServeEngine`` in its
``trace_records`` (``repro_torch/runtime/tracing.py`` ``StepRecord``),
taken at the traced sub-window's positions; a program without them
reports nothing."""
LAYER = "serve engine"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "out_tokens_per_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    pos = set(tr.step_pos)
    recs = [r for r in getattr(run.loop.eng, "trace_records", ())
            if r.pos in pos]
    rows = sum(r.prompt_rows + r.emit_rows for r in recs)
    if not rows:
        return None
    return 100.0 * sum(r.prompt_rows for r in recs) / rows
