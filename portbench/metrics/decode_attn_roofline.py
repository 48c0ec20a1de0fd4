"""The decode attention kernel (B7, ``kernels/decode_attn``) against its
roofline: the least time of its calls in the traced sub-window (one a
attention layer a step, ``counts.lm.decode_attn_call``) over its device
time there, read by kernel name."""
from portbench.counts import lm, peaks

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "out_tokens_per_s"
KERNEL = "decode_attn"


def read(run):
    tr = run.trace
    spec = run.cell.spec
    if tr is None or spec.kind != "moe_attn":
        return None
    ops = tr.named(KERNEL)
    if not ops or not tr.steps:
        return None
    flops = nbytes = 0.0
    for p in tr.step_pos:
        f, b = lm.decode_attn_call(spec, tr.batch, p)
        flops += f * spec.n_layers
        nbytes += b * spec.n_layers
    return peaks.roofline_share(flops, nbytes, sum(o.seconds for o in ops))
