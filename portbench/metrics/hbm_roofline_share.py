"""The whole decode step's share of the HBM peak: the bytes the window's
steps need (``counts.lm.step_bytes``: weights and live experts once a
step, each head once, K/V at the positions held, SSM state read and
written) over the window's wall time at 3.35 TB/s."""
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
    nbytes = sum(lm.step_bytes(spec, run.batch, p) for p in pos)
    return 100.0 * nbytes / (run.window_s * peaks.HBM_BYTES_PER_S)
