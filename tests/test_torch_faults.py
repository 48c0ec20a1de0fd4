"""The port's fault injection (``repro_torch.core.faults``) vs the JAX
package's, as twins.

Counterpart of ``tests/test_faults.py``.  Twin ``FaultPlan``s (the same seed
and specs) must corrupt and mangle one trace into byte-equal arrays with the
same injection lists, name the same crash points and run the same stall
schedule; twin orchestrators (the reference's cohorts with
``fused_ingest="numpy"``, the port's on the CPU) must give equal
``TickReport``s (the ``t_*`` timings left out), quarantine counters and
incumbents under each ``TelemetryPolicy`` mode, and raise alike in
``raise`` mode.
"""
import numpy as np
import pytest

import repro.core.faults as RF
from repro.core.online import ChurnOrchestrator as RefOrch
from repro.core.online import population_cohorts as ref_cohorts
from repro.core.population import TelemetryPolicy as RefTelemetry
from repro.runtime.straggler import StragglerDetector as RefDetector

import repro_torch.core.faults as PF
from repro_torch.core.online import ChurnOrchestrator, population_cohorts
from repro_torch.core.population import TelemetryPolicy
from repro_torch.runtime.straggler import StragglerDetector

from test_torch_online import assert_reports

T_, U = 10, 18
CPU = "cpu"


def _trace(seed=3):
    rng = np.random.default_rng(seed)
    return 0.4 + 0.6 * rng.random((T_, U))


def _specs(mod):
    """One spec of every kind, users given and drawn, ticks in and out of
    the trace, in a deliberately unsorted order."""
    S = mod.FaultSpec
    return [S(kind="dup_tick", tick=5), S(kind="nan", tick=4, user=5),
            S(kind="stuck", tick=2, count=3), S(kind="inf", tick=1, count=4),
            S(kind="negative", tick=3, value=7.5, count=2),
            S(kind="drop_tick", tick=2), S(kind="crash", tick=6,
                                           stage="relax"),
            S(kind="nan", tick=T_ + 5, user=0), S(kind="dup_tick", tick=9),
            S(kind="stuck", tick=7, user=11, count=6),
            S(kind="crash", tick=3, stage="post"),
            S(kind="drop_tick", tick=T_ + 2)]


def _plans(seed):
    return (RF.FaultPlan(seed=seed, specs=_specs(RF)),
            PF.FaultPlan(seed=seed, specs=_specs(PF)))


@pytest.mark.parametrize("seed", [0, 1, 5, 123])
def test_corrupt_and_mangle_byte_equal(seed):
    Q = _trace(seed)
    ref, got = _plans(seed)
    qa, ia = ref.corrupt(Q)
    qb, ib = got.corrupt(Q)
    assert qa.dtype == qb.dtype and qa.tobytes() == qb.tobytes()
    assert ia == ib and len(ia) > 10
    ma, mb = ref.mangle_trace(qa), got.mangle_trace(qb)
    assert ma.dtype == mb.dtype and ma.tobytes() == mb.tobytes()
    assert len(mb) == T_ + 1                  # one drop, two dups
    assert ref.crash_ticks() == got.crash_ticks() == [(6, "relax"),
                                                       (3, "post")]
    assert np.isfinite(Q).all()               # the input is untouched


@pytest.mark.parametrize("kind", ["nan", "inf", "negative", "stuck"])
def test_corrupt_specs_twins(kind):
    Q = _trace(11)
    a = RF.FaultPlan(seed=2, specs=RF.corrupt_specs([0, 3, 8], kind=kind,
                                                    users_per_tick=3))
    b = PF.FaultPlan(seed=2, specs=PF.corrupt_specs([0, 3, 8], kind=kind,
                                                    users_per_tick=3))
    assert [vars(s) for s in a.specs] == [vars(s) for s in b.specs]
    (qa, ia), (qb, ib) = a.corrupt(Q), b.corrupt(Q)
    assert qa.tobytes() == qb.tobytes() and ia == ib


def test_mangle_of_empty_and_full_drop():
    Q = _trace()
    S = [("drop_tick", t) for t in range(T_)]
    a = RF.FaultPlan(specs=[RF.FaultSpec(kind=k, tick=t) for k, t in S])
    b = PF.FaultPlan(specs=[PF.FaultSpec(kind=k, tick=t) for k, t in S])
    ma, mb = a.mangle_trace(Q), b.mangle_trace(Q)
    assert ma.shape == mb.shape == (0, U)
    with pytest.raises(ValueError, match="qualities"):
        b.mangle_trace(Q[0])
    with pytest.raises(ValueError, match="qualities"):
        b.corrupt(Q[0])


def test_crash_hooks_fire_alike():
    ref, got = _plans(0)
    for stage in PF.CRASH_STAGES:
        for tick in range(T_):
            outcome = []
            for plan, exc in ((ref, RF.InjectedCrash),
                              (got, PF.InjectedCrash)):
                try:
                    plan.crash_hook(stage, tick)
                    outcome.append(None)
                except exc as e:
                    outcome.append(str(e))
            assert outcome[0] == outcome[1], (stage, tick)
    assert PF.CRASH_STAGES == RF.CRASH_STAGES
    assert issubclass(PF.InjectedCrash, RuntimeError)


@pytest.mark.parametrize("n", [0, 1, 3])
def test_stall_schedule_matches(n):
    a, b = RF.FaultPlan.stall_hook(n), PF.FaultPlan.stall_hook(n)
    sched = []
    for hook in (a, b):
        row = []
        for attempt in range(6):
            try:
                hook(attempt)
                row.append(None)
            except TimeoutError as e:
                row.append(str(e))
        sched.append(row)
    assert sched[0] == sched[1]
    assert sum(x is not None for x in sched[1]) == n
    with pytest.raises(OSError):
        PF.FaultPlan.stall_hook(1, exc=OSError)(0)


def test_spec_validation_matches():
    for kw, match in ((dict(kind="gamma_ray", tick=0), "unknown fault kind"),
                      (dict(kind="crash", tick=0, stage="warmup"), "stage"),
                      (dict(kind="nan", tick=0, count=0), "count"),
                      (dict(kind="nan", tick=-1), "tick")):
        with pytest.raises(ValueError, match=match):
            RF.FaultSpec(**kw)
        with pytest.raises(ValueError, match=match):
            PF.FaultSpec(**kw)


# ---------------------------------------------------------------------------
# telemetry quarantine through twin orchestrators
# ---------------------------------------------------------------------------

def _orchs(mode=None):
    ref_kw, kw = {}, {}
    if mode is not None:
        ref_kw["telemetry"] = RefTelemetry(mode=mode)
        kw["telemetry"] = TelemetryPolicy(mode=mode)
    return (RefOrch(population=ref_cohorts(U, n_extra_edge=1, gamma=8,
                                           fused_ingest="numpy", **ref_kw)),
            ChurnOrchestrator(population=population_cohorts(
                U, n_extra_edge=1, gamma=8, device=CPU, **kw)))


def _corrupted():
    Q = _trace()
    specs = [("nan", 4, 5), ("negative", 5, 5), ("inf", 4, 11),
             ("stuck", 6, 2)]
    a = RF.FaultPlan(seed=1, specs=[RF.FaultSpec(kind=k, tick=t, user=u,
                                                 count=3)
                                    for k, t, u in specs])
    b = PF.FaultPlan(seed=1, specs=[PF.FaultSpec(kind=k, tick=t, user=u,
                                                 count=3)
                                    for k, t, u in specs])
    (qa, _), (qb, _) = a.corrupt(Q), b.corrupt(Q)
    assert qa.tobytes() == qb.tobytes()
    return Q, qb


@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("mode", ["quarantine", "clamp"])
def test_telemetry_modes_twin_reports(mode, stream):
    Q, Qc = _corrupted()
    ro, po = _orchs(mode)
    ra, rb = ro.run_arrays(Qc, stream=stream), po.run_arrays(Qc,
                                                            stream=stream)
    assert_reports(ra, rb)
    for p, q in zip(ro.pops, po.pops):
        assert p.stats.quarantines == q.stats.quarantines
        assert p.stats.recoveries == q.stats.recoveries
        np.testing.assert_array_equal(p._quarantined, q._quarantined)
        assert p._inc_place.tobytes() == q._inc_place.tobytes()
        assert p._inc_energy.tobytes() == q._inc_energy.tobytes()
    if mode == "quarantine":
        assert rb[4].n_quarantined == 2
        assert sum(r.n_quarantined for r in rb) == \
            sum(r.n_recovered for r in rb)


def test_quarantine_serves_last_known_good():
    """The reference's oracle on the port: a quarantined run equals a clean
    run fed each user's last good reading."""
    Q = _trace()
    plan = PF.FaultPlan(seed=1, specs=[PF.FaultSpec(kind="nan", tick=4,
                                                    user=5),
                                       PF.FaultSpec(kind="negative", tick=5,
                                                    user=5),
                                       PF.FaultSpec(kind="inf", tick=4,
                                                    user=11)])
    Qc, _ = plan.corrupt(Q)
    _, o = _orchs("quarantine")
    reps = o.run_arrays(Qc)
    assert reps[4].n_quarantined == 2 and reps[5].n_recovered == 1
    assert reps[6].n_recovered == 1
    Qfix = Qc.copy()
    Qfix[4, 5] = Qfix[5, 5] = Q[3, 5]
    Qfix[4, 11] = Q[3, 11]
    _, clean = _orchs()
    for a, b in zip(reps, clean.run_arrays(Qfix)):
        assert abs(a.energy - b.energy) < 1e-12, a.tick
    for p, q in zip(o.pops, clean.pops):
        np.testing.assert_array_equal(p._inc_place, q._inc_place)


def test_raise_mode_rejects_corrupt_trace_alike():
    Q = _trace()
    Qc, _ = PF.FaultPlan(specs=[PF.FaultSpec(kind="nan", tick=2,
                                             user=0)]).corrupt(Q)
    ro, po = _orchs("raise")
    with pytest.raises(ValueError):
        ro.run_arrays(Qc)
    with pytest.raises(ValueError):
        po.run_arrays(Qc)
    assert ro._tick == po._tick


def test_quarantine_counters_zero_without_faults():
    ro, po = _orchs("quarantine")
    ra, rb = ro.run_arrays(_trace()), po.run_arrays(_trace())
    assert_reports(ra, rb)
    assert all(r.n_quarantined == 0 and r.n_recovered == 0 for r in rb)


def test_straggler_flags_via_injected_times_alike():
    ro, po = _orchs()
    ro._straggler_cfg = RefDetector(n_workers=4, warmup=2)
    po._straggler_cfg = StragglerDetector(n_workers=4, warmup=2)

    def times(rep):
        t = np.ones(4)
        t[1] = 10.0                      # worker 1 persistently slow
        return t

    ro.straggler_times = po.straggler_times = times
    ra, rb = ro.run_arrays(_trace()[:5]), po.run_arrays(_trace()[:5])
    assert_reports(ra, rb)
    flags = [r.n_stragglers for r in rb]
    assert any(flags) and flags[0] == 0
    # no mesh backend configured: nothing to demote
    assert all(r.n_mesh_demotions == 0 for r in rb)
