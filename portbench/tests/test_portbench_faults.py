"""``correct`` comes out false for the control and for faults planted
under the timed path.

The control is the plain reference in fp8 put in the program's place: the
harness judges its numbers against the limits, and at CPU-test sizes they
exceed them (the chip readings at the cells' sizes are in PERF.md).  Each
fault a cell can have (``portbench/faults.py``) is planted after set-up,
under a run that skips the harness's look for a card: a decode step that
leaves its state unchanged, half of the batch served another row's
result, the tokens altered where the gate produces them, and under churn
a tick that leaves the placement as it was and a tick that degrades with
no solve.  One chip has no exchange between chips to leave out.
"""
import pytest

from portbench import faults as F
from portbench.tests import tiny

MODEL_FAULTS = sorted(set(F.FAULTS) - set(F.CHURN_FAULTS))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_the_control_is_not_correct(root, workload):
    res = tiny.run(root, workload, control=True)
    assert not res["correct"], res["checks"]
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed and all(k.startswith("control_") for k in failed), failed
    for k in ("token_gap_mean", "exit_gap_mean"):
        assert res["readings"][k] <= res["checks"][f"control_{k}"]["limit"]


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
@pytest.mark.parametrize("fault", MODEL_FAULTS)
def test_a_planted_fault_is_not_correct(root, workload, fault, monkeypatch):
    res = tiny.run(root, workload,
                   fault=lambda setup: F.FAULTS[fault](setup,
                                                       monkeypatch.setattr))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(F.CHURN_FAULTS))
def test_a_tick_fault_is_not_correct(root, fault, monkeypatch):
    res = tiny.run(root, "tiny.moe.churn",
                   fault=lambda setup: F.FAULTS[fault](setup,
                                                       monkeypatch.setattr))
    assert not res["correct"], res["checks"]
    placement = [res["checks"][k] for k in ("placement_faults",
                                            "placement_excess")]
    assert any(c["value"] > c["limit"] for c in placement), placement
    assert res["checks"]["token_gap_mean"]["value"] <= \
        res["checks"]["token_gap_mean"]["limit"]


def test_a_sound_churn_run_degrades_nowhere(root):
    res = tiny.run(root, "tiny.moe.churn")
    assert res["correct"], res["checks"]
    assert res["readings"]["degraded_ticks"] == 0.0
    assert res["checks"]["placement_faults"]["value"] == 0.0
