"""The whole decode step's share of the bf16 peak: the model operations of
the window's steps (``counts.lm.step_flops``) over the window's wall time
at 989 TFLOP/s."""
from portbench.counts import lm, peaks

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "out_tokens_per_s"


def read(run):
    pos = run.window_steps()
    if not pos:
        return None
    spec = run.cell.spec
    flops = sum(lm.step_flops(spec, run.batch, p) for p in pos)
    return 100.0 * flops / (run.window_s * peaks.BF16_FLOPS)
