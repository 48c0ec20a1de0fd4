"""The reader of the Mamba-2 decode core's roofline share
(``metrics/ssm_decode_roofline.py``): its bytes a call at the served
shape against a count by hand, 100% on a trace whose kernels take the
bound, nothing where no kernel of that name ran or the cell has no SSM
layer."""
from types import SimpleNamespace

import pytest

from portbench import cell as CELL
from portbench.counts import peaks
from portbench.tests import tiny
from portbench.trace import DeviceOp, Trace

MAMBA = "mamba2.chat.b256"


def reader():
    return CELL.reader(tiny.REPO, "metrics", "ssm_decode_roofline")


def test_bytes_a_call_at_the_served_shape():
    spec = CELL.load(tiny.REPO, MAMBA).spec
    state = 256 * 2 * 64 * 64 * 128 * 4          # read and written
    conv = 256 * 2 * 3 * (4096 + 256) * 2
    inputs = 256 * (4096 + 4096 + 256 + 64) * 2    # z, conv inputs, dt
    out = 256 * 4096 * 2
    weights = (4 * 4352 + 4352) * 2 + 3 * 64 * 4
    flops, nbytes = reader().call(spec, 256)
    assert nbytes == state + conv + inputs + out + weights == 1_093_610_752
    assert flops == 256 * (5 * 64 * 64 * 128 + 2 * 4 * 4352)


def _run(workload, names, seconds, steps=3):
    cell = CELL.load(tiny.REPO, workload)
    ops, t = [], 0.0
    for name in names:
        ops.append(DeviceOp(name, t, t + seconds))
        t += seconds
    tr = Trace(ops, [], (0.0, max(t, 1.0)), list(range(steps)), 256)
    return SimpleNamespace(cell=cell, trace=tr)


def test_share_of_a_trace_at_the_bound_is_100():
    m = reader()
    spec = CELL.load(tiny.REPO, MAMBA).spec
    _, nbytes = m.call(spec, 256)
    calls = 3 * 48
    t = nbytes * calls / peaks.HBM_BYTES_PER_S
    # two launches a call, the state pass the longer
    names = ["void (anonymous namespace)::ssm_decode_conv<bf16>(...)",
             "void (anonymous namespace)::ssm_decode_state<bf16, 32>(...)"
             ] * calls
    run = _run(MAMBA, names, t / len(names))
    assert m.read(run) == pytest.approx(100.0, rel=1e-9)
    run.trace.device_ops.append(DeviceOp("elementwise_kernel", 0.0, 1.0))
    assert m.read(run) == pytest.approx(100.0, rel=1e-9)


def test_nothing_to_read():
    m = reader()
    assert m.read(_run(MAMBA, ["elementwise_kernel"], 1e-3)) is None
    assert m.read(SimpleNamespace(cell=CELL.load(tiny.REPO, MAMBA),
                                  trace=None)) is None
    assert m.read(_run("mixtral8p.chat.b128",
                       ["ssm_decode_state"], 1e-3)) is None
