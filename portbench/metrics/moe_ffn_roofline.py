"""The MoE experts' kernel (B10, ``kernels/moe_ffn``) against its roofline:
the least time of its calls in the traced sub-window (one an MoE layer a
step, ``counts.lm.moe_ffn_call``: every expert that the step's tokens use,
all 8 at 128 tokens and top-2) over its device time there, read by kernel
name."""
from portbench.counts import lm, peaks

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "out_tokens_per_s"
KERNEL = "moe_"


def read(run):
    tr = run.trace
    spec = run.cell.spec
    if tr is None or spec.kind != "moe_attn" or not tr.steps:
        return None
    ops = tr.named(KERNEL)
    if not ops:
        return None
    f, b = lm.moe_ffn_call(spec, tr.batch)
    calls = tr.steps * spec.n_layers
    return peaks.roofline_share(f * calls, b * calls,
                                sum(o.seconds for o in ops))
