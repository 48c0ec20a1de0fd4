"""The port's churn orchestrator vs the JAX package's, as twins.

Counterparts of ``tests/test_online.py``, the ``PopulationContingency`` and
orchestrator tests of ``tests/test_contingency.py`` and the ``run_arrays``
tests of ``tests/test_stream.py``.  The reference runs its cohorts with
``fused_ingest="numpy"`` (its jnp ingest raises on the installed jax), the
port runs on ``device="cpu"``; both get the same traces, made from a seed.
After every tick the two must give equal ``TickReport``s (the ``t_*``
timings left out) and, in population mode, identical incumbents, counters
and ``state_dict`` bytes; in plan mode, the same Solutions.  The port's own
paths are held to each other the same way: ``run_arrays`` streamed under
every ``stream_overlap`` against the synchronous ``step_arrays`` loop, and
``population=`` against ``plans=``.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core.scenarios import paper_scenario as ref_paper_scenario

import repro_torch as T
from repro_torch.convert import network_from, profile_from

from test_torch_fin import assert_same
from test_torch_population import assert_twins

CPU = "cpu"
REQ = (0.5, 8e-3)


def rep(r):
    """A TickReport's fields, the ``t_*`` timings left out."""
    return {k: v for k, v in dataclasses.asdict(r).items()
            if not k.startswith("t_")}


def assert_reports(ref, got, ctx=""):
    assert len(ref) == len(got), ctx
    for t, (a, b) in enumerate(zip(ref, got)):
        assert rep(a) == rep(b), (ctx, t, rep(a), rep(b))


def assert_cohorts(ref_pops, got_pops, ctx=""):
    assert len(ref_pops) == len(got_pops), ctx
    for i, (a, b) in enumerate(zip(ref_pops, got_pops)):
        assert_twins(a, b, (ctx, i))


def assert_ledgers(ro, po, ctx=""):
    for f in ("quality", "attached", "_ref_energy", "_cur_energy"):
        a, b = getattr(ro, f), getattr(po, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (ctx, f)


def events(trace):
    """A reference churn trace as the port's events."""
    return [[T.ChurnEvent(e.kind, e.user, e.value) for e in evs]
            for evs in trace]


def cohorts(U, **kw):
    """Twin ``population_cohorts``: the reference's and the port's."""
    return (R.population_cohorts(U, fused_ingest="numpy", **kw),
            T.population_cohorts(U, device=CPU, **kw))


def orchs(U, pop_kw=None, **kw):
    """Twin population-mode orchestrators over ``cohorts``."""
    a, b = cohorts(U, **(pop_kw or {}))
    return (R.ChurnOrchestrator(population=a, **kw),
            T.ChurnOrchestrator(population=b, **kw))


def plan_orchs(U, plan_kw=None, **kw):
    """Twin plan-mode orchestrators over ``population_plans``."""
    plan_kw = plan_kw or {}
    return (R.ChurnOrchestrator(R.population_plans(U, **plan_kw), **kw),
            T.ChurnOrchestrator(T.population_plans(U, device=CPU,
                                                   **plan_kw), **kw))


def run_twins(pair, trace):
    """Step both orchestrators through ``trace`` (the reference's events);
    their reports must agree tick by tick."""
    ro, po = pair
    a = [ro.step(evs) for evs in trace]
    b = [po.step(evs) for evs in events(trace)]
    assert_reports(a, b)
    return a, b


def assert_plan_twins(ro, po):
    for u, (a, b) in enumerate(zip(ro.plans, po.plans)):
        if a.solution is None or b.solution is None:
            assert a.solution is b.solution is None, u
        else:
            assert_same(a.solution, b.solution)
        assert a.masked_nodes == b.masked_nodes, u
    assert_ledgers(ro, po)


def ar1(U, T_, seed=7, attach=True):
    """``tests/test_stream.py``'s trace: clipped Gaussian qualities and
    random edge slots."""
    rng = np.random.default_rng(seed)
    qual = np.clip(0.55 + 0.25 * rng.standard_normal((T_, U)), 0.05, 1.0)
    att = rng.integers(0, 3, size=(T_, U))
    return qual, (att if attach else None)


# ---------------------------------------------------------------------------
# tests/test_online.py: plan mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["benign", "uniform", "paper_3node",
                                  "always", "mixed"])
def test_plan_mode_traces_match_reference(case):
    """Fading, mobility, failure / recovery cycles and slices, per-plan:
    equal reports, Solutions and ledgers, tick by tick."""
    U, n_ticks, plan_kw, kw = 12, 5, {"n_extra_edge": 2}, {}
    tr_kw = dict(seed=1, sigma=0.02)
    if case == "uniform":
        tr_kw = dict(seed=9, sigma=0.15)
        kw = {"hysteresis": 0.1}
    elif case == "paper_3node":
        plan_kw = {}
        tr_kw = dict(seed=2, sigma=0.05)
    elif case == "always":
        U = 8
        kw = {"always_resolve": True}
        tr_kw = dict(seed=4, q_mean=0.5, sigma=0.15, p_move=0.25, n_edge=3)
    elif case == "mixed":
        tr_kw = dict(seed=3, p_fail=0.3, p_recover=0.5, fail_nodes=(1, 4),
                     p_move=0.2, n_edge=3, sigma=0.1)
    pair = plan_orchs(U, plan_kw, **kw)
    run_twins(pair, R.churn_trace(U, n_ticks, **tr_kw))
    assert_plan_twins(*pair)
    if case == "always":
        # per-tick optimal re-planning equals the port's cold solver
        for p in pair[1].plans:
            assert_same(p.solution, T.solve_fin(p.network, p.profile, p.req,
                                                device=CPU), meta=False)


def test_plan_mode_failure_slice_and_attach_events():
    """A failure of a used node, its recovery, a slice cut and an attach
    after a same-tick event: equal reports and plans each step."""
    pair = plan_orchs(6, {"n_extra_edge": 2}, hysteresis=0.05)
    ro, po = pair
    run_twins(pair, [[R.ChurnEvent("uplink", u, 0.3) for u in range(6)]])
    used = {n for p in po.plans if p.solution.feasible
            for n in p.solution.config.placement}
    victim = max(used)
    assert victim != 0
    a, b = run_twins(pair, [[R.ChurnEvent("fail", None, victim)]])
    assert b[0].n_resolved > 0 and b[0].n_migrations > 0
    assert all(victim not in p.solution.config.placement
               for p in po.plans if p.solution.feasible)
    run_twins(pair, [[R.ChurnEvent("recover", None, victim)],
                     [R.ChurnEvent("slice", None, 0.25)],
                     [R.ChurnEvent("slice", 0, 0.8),
                      R.ChurnEvent("attach", 0, 1)]])
    assert_plan_twins(ro, po)
    got = po.plans[0].network.bandwidth[0].copy()
    got[0] = np.inf
    assert got.tobytes() == po._uplink_vector(0).tobytes()


def test_plan_mode_validation_and_round_robin():
    plans = T.population_plans(13, device=CPU)
    names = [p.profile.name for p in plans]
    assert names == [p.profile.name for p in R.population_plans(13)]
    assert names[0] == names[6] and len(set(names)) == 6
    orch = T.ChurnOrchestrator(plans[:3])
    before = orch.quality.copy()
    with pytest.raises(ValueError, match="kind"):
        orch.step([T.ChurnEvent("teleport", 0, 1.0)])
    for kind in ("uplink", "attach"):
        with pytest.raises(ValueError, match="per-user"):
            orch.step([T.ChurnEvent(kind, None, 0.5)])
    assert orch.quality.tobytes() == before.tobytes()
    with pytest.raises(ValueError, match="exactly one"):
        T.ChurnOrchestrator()
    for kw in ({"shared_capacity": T.SharedCapacity.infinite(3)},
               {"contingency": True}):
        with pytest.raises(ValueError, match="population"):
            T.ChurnOrchestrator(plans[:2], **kw)
    with pytest.raises(ValueError, match="placement_policy"):
        T.ChurnOrchestrator(plans[:2], placement_policy="greedy")
    with pytest.raises(ValueError, match="stream_overlap"):
        T.ChurnOrchestrator(plans[:2], stream_overlap="sometimes")


# ---------------------------------------------------------------------------
# population mode: event ticks, array ticks, population= vs plans=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("always", [False, True])
def test_population_event_ticks_match_reference(always):
    U = 30
    pair = orchs(U, {"n_extra_edge": 2}, hysteresis=0.05,
                 always_resolve=always)
    run_twins(pair, R.churn_trace(U, 5, seed=3, p_fail=0.3, p_recover=0.5,
                                  fail_nodes=(1, 4), p_move=0.2, n_edge=3,
                                  sigma=0.1)
              + [[R.ChurnEvent("slice", None, 0.8)],
                 [R.ChurnEvent("fail", 5, 2), R.ChurnEvent("uplink", 5, .4)]])
    assert_cohorts(pair[0].pops, pair[1].pops)
    assert_ledgers(*pair)


def test_population_step_arrays_match_reference():
    """Array ticks with and without attachments, interleaved with an event
    tick (the factor cache heals across the two forms)."""
    U = 36
    pair = orchs(U, {"n_extra_edge": 2}, hysteresis=0.05)
    ro, po = pair
    qual, att = ar1(U, 4, seed=11)
    for t in range(4):
        a = ro.step_arrays(qual[t], att[t] if t % 2 else None)
        b = po.step_arrays(qual[t], att[t] if t % 2 else None)
        assert rep(a) == rep(b), t
        if t == 1:
            run_twins(pair, [[R.ChurnEvent("attach", 4, 2),
                              R.ChurnEvent("uplink", 7, 0.9)]])
    assert_cohorts(ro.pops, po.pops)
    assert_ledgers(ro, po)
    with pytest.raises(ValueError, match="quality"):
        po.step_arrays(qual[0][:5])


def test_population_mode_equals_plan_mode():
    """The port's two representations make the same decisions: equal
    reports and per-user incumbents on one trace."""
    U = 18
    trace = events(R.churn_trace(U, 4, seed=5, p_fail=0.3, p_recover=0.5,
                                 fail_nodes=(1,), p_move=0.2, n_edge=3,
                                 sigma=0.1))
    a = T.ChurnOrchestrator(T.population_plans(U, n_extra_edge=2,
                                               device=CPU))
    b = T.ChurnOrchestrator(population=T.population_cohorts(
        U, n_extra_edge=2, device=CPU))
    assert_reports([a.step(e) for e in trace], [b.step(e) for e in trace])
    for u, p in enumerate(a.plans):
        pop, lu = b.pops[b._pop_of[u]], b._local_of[u]
        assert p.solution.feasible == bool(pop.inc_found[lu]), u
        if p.solution.feasible:
            nb = len(p.solution.config.placement)
            assert list(pop._inc_place[lu][:nb]) == \
                p.solution.config.placement
            assert pop._inc_energy[lu] == p.solution.energy


# ---------------------------------------------------------------------------
# tests/test_stream.py: run_arrays, streamed and synchronous
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", ["auto", "always", "never"])
@pytest.mark.parametrize("stream", [True, False])
def test_run_arrays_matches_reference_sync_loop(stream, overlap):
    """The port's ``run_arrays`` (the double-buffered pipeline, or the
    synchronous loop) equals the reference's synchronous ``step_arrays``
    loop: reports, ledgers, incumbents, counters and state_dicts."""
    U, T_ = 60, 4
    qual, att = ar1(U, T_)
    ro = R.ChurnOrchestrator(population=R.population_cohorts(
        U, n_extra_edge=2, fused_ingest="numpy"), hysteresis=0.05)
    po = T.ChurnOrchestrator(population=T.population_cohorts(
        U, n_extra_edge=2, device=CPU), hysteresis=0.05,
        stream_overlap=overlap)
    a = [ro.step_arrays(qual[t], att[t]) for t in range(T_)]
    b = po.run_arrays(qual, att, stream=stream)
    assert [r.tick for r in b] == list(range(T_))
    assert_reports(a, b)
    assert_cohorts(ro.pops, po.pops)
    assert_ledgers(ro, po)
    if stream and overlap == "always":
        assert po._overlap_used


@pytest.mark.parametrize("always", [False, True])
def test_run_arrays_resumable_and_always_resolve(always):
    """Two ``run_arrays`` calls continue the tick counter and equal one
    synchronous loop; with ``always_resolve`` too."""
    U, T_ = 48, 4
    qual, _ = ar1(U, T_, seed=3, attach=False)
    ro, po = orchs(U, {"n_extra_edge": 2}, always_resolve=always)
    a = [ro.step_arrays(qual[t]) for t in range(T_)]
    b = po.run_arrays(qual[:2]) + po.run_arrays(qual[2:])
    assert [r.tick for r in b] == list(range(T_))
    assert_reports(a, b)
    assert_cohorts(ro.pops, po.pops)


def test_run_arrays_validation_and_checkpoints_raise(tmp_path):
    """Malformed traces raise; checkpoint misuse raises as in the
    reference (``checkpoint_every`` without a dir, plan mode, an empty
    dir, a trace shorter than the saved position)."""
    qual, att = ar1(24, 2)
    po = T.ChurnOrchestrator(population=T.population_cohorts(
        24, n_extra_edge=2, device=CPU))
    with pytest.raises(ValueError, match="qualities"):
        po.run_arrays(qual[:, :10])
    with pytest.raises(ValueError, match="attaches"):
        po.run_arrays(qual, att[:, :10])
    plain = T.ChurnOrchestrator(T.population_plans(1, device=CPU))
    with pytest.raises(ValueError, match="population"):
        plain.run_arrays(qual[:, :1])
    with pytest.raises(ValueError, match="population"):
        plain.step_arrays(qual[0, :1])
    # checkpoint misuse is rejected as the reference rejects it
    ro = R.ChurnOrchestrator(population=R.population_cohorts(
        24, n_extra_edge=2, fused_ingest="numpy"))
    ref_plain = R.ChurnOrchestrator(R.population_plans(1))
    d = str(tmp_path / "ck")
    for a, b, exc, match in (
            (lambda: ro.run_arrays(qual, checkpoint_every=1),
             lambda: po.run_arrays(qual, checkpoint_every=1),
             ValueError, "checkpoint_dir"),
            (lambda: ref_plain.checkpoint(d), lambda: plain.checkpoint(d),
             ValueError, "population mode"),
            (lambda: ref_plain.restore(d), lambda: plain.restore(d),
             ValueError, "population mode"),
            (lambda: ro.restore(d), lambda: po.restore(d),
             FileNotFoundError, "no restorable checkpoint")):
        with pytest.raises(exc, match=match):
            a()
        with pytest.raises(exc, match=match):
            b()
    assert po._tick == 0
    po.run_arrays(qual, checkpoint_dir=d)       # trace_pos 2
    with pytest.raises(ValueError, match="trace has only 1"):
        T.ChurnOrchestrator(population=T.population_cohorts(
            24, n_extra_edge=2, device=CPU)).resume(d, qual[:1])
    with pytest.raises(ValueError, match="trace has only 1"):
        R.ChurnOrchestrator(population=R.population_cohorts(
            24, n_extra_edge=2, fused_ingest="numpy")).resume(d, qual[:1])


def test_timing_breakdown_and_straggler_detector():
    """``Population(timing=True)`` fills the ``t_*`` split; with an
    injected time provider the straggler detector flags what the
    reference's does (the port has no mesh to demote)."""
    U, T_ = 24, 6
    qual, att = ar1(U, T_, seed=23)
    po = T.ChurnOrchestrator(population=T.population_cohorts(
        U, n_extra_edge=2, device=CPU, timing=True))
    reps = po.run_arrays(qual, att)
    assert sum(r.t_ingest_ms + r.t_relax_ms + r.t_post_ms
               for r in reps) > 0.0
    plain = T.ChurnOrchestrator(population=T.population_cohorts(
        U, n_extra_edge=2, device=CPU))
    assert all(r.t_post_ms == r.t_reprice_ms == 0.0
               for r in plain.run_arrays(qual, att))
    times = [np.array([1.0, 1.0, 1.0, 5.0 if t >= 2 else 1.0])
             for t in range(T_)]
    ro, po = orchs(U, {"n_extra_edge": 2}, straggler=True)
    for o in (ro, po):
        o.straggler_times = lambda r: times[r.tick]
    a = [ro.step_arrays(qual[t]) for t in range(T_)]
    b = [po.step_arrays(qual[t]) for t in range(T_)]
    assert_reports(a, b)
    assert sum(r.n_stragglers for r in b) > 0
    assert po._straggler_det.ewma.tobytes() == \
        ro._straggler_det.ewma.tobytes()
    assert po._relaxers() == []


# ---------------------------------------------------------------------------
# placement_policy="frontier" (B3 through Plan.frontier and the cohorts)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["population", "plans"])
def test_frontier_policy_matches_reference(mode):
    """``benchmarks/bench_online.py``'s frontier trace (fading, mobility,
    failure / recovery cycles, per-tick re-planning) at migration weight
    1e-8 J/bit, in both representations."""
    U, n_ticks = 24, 7
    trace = R.churn_trace(U, n_ticks, seed=5, q_mean=0.5, sigma=0.15,
                          p_fail=0.3, p_recover=0.5, fail_nodes=(4,),
                          p_move=0.1, n_edge=3)
    kw = dict(always_resolve=True, placement_policy="frontier",
              migration_weight=1e-8)
    if mode == "population":
        pair = orchs(U, {"n_extra_edge": 2}, **kw)
    else:
        pair = plan_orchs(U, {"n_extra_edge": 2}, **kw)
    a, b = run_twins(pair, trace)
    assert sum(r.n_resolved for r in b) == U * n_ticks
    if mode == "population":
        assert_cohorts(pair[0].pops, pair[1].pops)
    else:
        assert_plan_twins(*pair)
    assert_ledgers(*pair)


def test_frontier_policy_weight_zero_is_argmin():
    U = 18
    trace = events(R.churn_trace(U, 4, seed=5, q_mean=0.5, sigma=0.15,
                                 p_fail=0.3, p_recover=0.5, fail_nodes=(4,),
                                 p_move=0.1, n_edge=3))
    a, b = (T.ChurnOrchestrator(population=T.population_cohorts(
        U, n_extra_edge=2, device=CPU), always_resolve=True,
        placement_policy=pol) for pol in ("argmin", "frontier"))
    ra = [a.step(e) for e in trace]
    rb = [b.step(e) for e in trace]
    assert [r.energy for r in ra] == [r.energy for r in rb]
    for p1, p2 in zip(a.pops, b.pops):
        assert p1._inc_place.tobytes() == p2._inc_place.tobytes()


# ---------------------------------------------------------------------------
# tests/test_contingency.py: PopulationContingency and the orchestrator
# ---------------------------------------------------------------------------

def _scenario():
    return ref_paper_scenario(n_extra_edge=1)


def _cont_twin(U, **kw):
    nw = _scenario()
    pf = R.paper_profile("h2")
    return (R.Population(nw, pf, R.AppRequirements(*REQ), U,
                         fused_ingest="numpy", **kw),
            T.Population(network_from(nw), profile_from(pf),
                         T.AppRequirements(*REQ), U, device=CPU, **kw))


def _pin_keys(p):
    return sorted(p._state_key(p._states[s].stq, p._states[s].mask)
                  for s in p._pinned)


def _assert_libs(ra, rb):
    assert dataclasses.asdict(ra.stats) == dataclasses.asdict(rb.stats)
    assert list(ra._observed.items()) == list(rb._observed.items())
    assert ra.pop._pinned == rb.pop._pinned
    assert ra.pop._state_ids == rb.pop._state_ids
    assert_twins(ra.pop, rb.pop)


def test_population_refill_prebuilds_and_coverage_hits():
    """Refill, coverage probe and a covered failure tick: the same state
    ids, pins, counters and incumbents as the reference, and the failure
    tick relaxes nothing."""
    pair = _cont_twin(6)
    libs = []
    for p, C in zip(pair, (R.PopulationContingency,
                           T.PopulationContingency)):
        p.solve(range(6), build_solutions=False)
        libs.append(C(p))
    n = [lib.refill() for lib in libs]
    assert n[0] == n[1] > 0
    assert pair[1].stats.prebuilt_states == n[1]
    assert pair[1].stats.dp_relaxes == pair[0].stats.dp_relaxes
    _assert_libs(*libs)
    cov = [lib.coverage(1, "fail") for lib in libs]
    assert cov[0] == cov[1] and cov[1][0] > 0 and cov[1][1] == 0
    r0 = pair[1].stats.dp_relaxes
    for p in pair:
        p.mask_node(1)
        p.solve(range(6), build_solutions=False)
    assert pair[1].stats.dp_relaxes == r0
    _assert_libs(*libs)


def test_refill_duplicate_keys_resolve_to_the_first_newborn():
    """Two live states with one pack (unmasked, and node 1 masked) share
    candidates inside one refill: the edge pair's joint failure is state
    A's tier mask and state B's toggle of node 2.  The batched refill
    gives each key its first newborn and hands out the reference's ids."""
    pair = _cont_twin(6)
    libs = []
    for p, C in zip(pair, (R.PopulationContingency,
                           T.PopulationContingency)):
        p.mask_node(1, users=[3, 4, 5])
        p.solve(range(6), build_solutions=False)
        assert p.n_states == 2
        libs.append(C(p))
    both = np.zeros(pair[1].N, dtype=bool)
    both[[1, 2]] = True
    key = pair[1]._state_key(pair[1]._states[0].stq, both)
    assert key not in pair[1]._state_ids
    n = [lib.refill(extra_masks=[both]) for lib in libs]
    assert n[0] == n[1]
    _assert_libs(*libs)
    assert pair[1]._state_ids[key] == pair[0]._state_ids[key]
    keys = list(pair[1]._state_ids)
    assert len(keys) == len(set(keys)) == pair[1].n_states
    assert [pair[1]._state_ids[k] for k in keys] == \
        [pair[0]._state_ids[k] for k in keys]


def test_population_pins_survive_compaction_and_extra_masks():
    pair = _cont_twin(3, max_states=2)
    libs = []
    window = np.zeros(pair[1].N, dtype=bool)
    window[[2, 3]] = True
    for p, C, P in zip(pair, (R.PopulationContingency,
                              T.PopulationContingency),
                       (R.ContingencyPolicy, T.ContingencyPolicy)):
        p.solve(range(3), build_solutions=False)
        libs.append(C(p, policy=P(tier_groups=())))
    for lib in libs:
        lib.refill(extra_masks=[window])
    _assert_libs(*libs)
    for sid in np.unique(pair[1]._user_state):
        st = pair[1]._states[int(sid)]
        s2 = pair[1]._state_ids.get(pair[1]._state_key(st.stq, window))
        assert s2 is not None and int(s2) in pair[1]._pinned
    keys = _pin_keys(pair[1])
    rng = np.random.default_rng(0)
    for _ in range(4):
        f = rng.uniform(0.3, 1.0, (3, 1))
        for p in pair:
            p.ingest(p._bw_vec * f)
    assert pair[1].stats.state_evictions > 0
    _assert_libs(*libs)
    for k in keys:
        sid = pair[1]._state_ids.get(k)
        assert sid is not None and pair[1]._states[sid].dps is not None
    for p in pair:
        p.update_slice(0.9)
    assert pair[1]._pinned == set()


def test_population_observed_state_roundtrip():
    pop = _cont_twin(6)[1]
    pc = T.PopulationContingency(pop)
    pc.coverage(1, "fail")
    pc2 = T.PopulationContingency(pop)
    pc2.restore_state(pc.state_dict())
    assert pc2._observed == pc._observed
    ref = R.PopulationContingency(_cont_twin(6)[0])
    ref.coverage(1, "fail")
    for k, v in ref.state_dict().items():
        assert v.tobytes() == pc.state_dict()[k].tobytes(), k
    with pytest.raises(ValueError, match="do not fit"):
        pc2.restore_state(
            {"obs_masks": np.zeros((1, pop.N + 1), dtype=bool),
             "obs_counts": np.ones(1, dtype=np.int64)})
    with pytest.raises(ValueError, match="kind"):
        pc.coverage(1, "explode")


@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_orchestrator_contingency_zero_relax_ticks(sigma):
    """The tier-outage trace with the library on: equal reports and
    cohorts to the reference, hits and no misses, and (frozen channel)
    no failure tick relaxes a state; equal to a run without the library."""
    U, n_ticks = 8, 12
    trace = R.churn_trace(U, n_ticks, seed=3, p_fail=0.4, p_recover=0.5,
                          fail_nodes=(1, 2), failure_mode="tier",
                          sigma=sigma, q_mean=0.65)
    pair = _cont_twin(U)
    ro = R.ChurnOrchestrator(population=pair[0], contingency=True)
    po = T.ChurnOrchestrator(population=pair[1], contingency=True)
    warm = [[R.ChurnEvent("uplink", u, 0.65) for u in range(U)]]
    run_twins((ro, po), warm)
    r0 = pair[1].stats.dp_relaxes
    a, b = run_twins((ro, po), trace)
    assert_twins(*pair)
    assert sum(r.contingency_hits for r in b) > 0
    assert sum(r.contingency_misses for r in b) == 0
    assert sum(r.contingency_prebuilt for r in b) > 0
    if sigma == 0.0:
        assert pair[1].stats.dp_relaxes == r0
    plain = T.ChurnOrchestrator(population=_cont_twin(U)[1])
    c = [plain.step(e) for e in events(warm + trace)][1:]
    assert [r.energy for r in c] == [r.energy for r in b]
    assert plain.pops[0]._inc_place.tobytes() == \
        pair[1]._inc_place.tobytes()
