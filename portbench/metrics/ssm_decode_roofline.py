"""The Mamba-2 decode core (B14, ``kernels/ssm_decode``) against its
roofline: the least time of its calls in the traced sub-window (one an SSM
layer a step, both of a call's launches) over their device time there,
read by kernel name.  A call's bytes are counted here from the
configuration: per row the float32 state and the conv tail read and
written, z, the conv inputs and dt read, the gated y written; per call the
conv weights and bias and the three per-head vectors.  Its operations are
the state update and y's contraction (5 a state element) and the conv."""
from portbench.counts import lm, peaks

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "out_tokens_per_s"
KERNEL = "ssm_decode"


def call(spec, batch):
    """(operations, bytes) of one call of the decode core (one layer)."""
    di, H, P, N = lm.ssm_dims(spec)
    C = di + 2 * N
    row = (2 * H * P * N * lm.F32_BYTES
           + 2 * (spec.d_conv - 1) * C * lm.WEIGHT_BYTES
           + (di + C + H) * lm.WEIGHT_BYTES + di * lm.WEIGHT_BYTES)
    nbytes = (batch * row + (spec.d_conv * C + C) * lm.WEIGHT_BYTES
              + 3 * H * lm.F32_BYTES)
    flops = batch * (5 * H * P * N + 2 * spec.d_conv * C)
    return float(flops), float(nbytes)


def read(run):
    tr = run.trace
    spec = run.cell.spec
    if tr is None or spec.kind != "ssm" or not tr.steps:
        return None
    ops = tr.named(KERNEL)
    if not ops:
        return None
    f, b = call(spec, tr.batch)
    calls = tr.steps * spec.n_layers
    return peaks.roofline_share(f * calls, b * calls,
                                sum(o.seconds for o in ops))
