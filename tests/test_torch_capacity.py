"""The port's shared-capacity congestion pricing vs the JAX package's.

Counterparts of ``tests/test_capacity.py``.  Twin cohorts -- the
reference's with ``fused_ingest="numpy"``, the port's on the CPU -- go
through the same ingests, capacities and churn; every congestion pass must
give equal ``CongestionReport``s, equal price exponents (the trajectory,
tick by tick), bit-equal loads and identical incumbents, counters and
``state_dict`` bytes.  On the port alone, the reference's oracles hold:
``accumulate_loads`` equals a scalar replay of the grouped reduction, the
admitted set never violates a capacity (brute-force joint loads), and no
unplaced user has a frontier row that fits.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.core.capacity import CongestionController as RefController
from repro.core.capacity import SharedCapacity as RefCapacity
from repro.core.multiapp import PAPER_MULTIAPP_REQS
from repro.core.scenarios import paper_scenario as ref_paper_scenario

import repro_torch as T
from repro_torch.convert import network_from, profile_from, requirements_from
from repro_torch.core.problem import (Config, config_link_loads,
                                      config_node_loads)

from test_torch_online import assert_cohorts, assert_ledgers, events, rep
from test_torch_population import assert_twins

CPU = "cpu"
APPS2 = ("h1", "h5")


def _req(r):
    return requirements_from(r.alpha, r.delta, r.sigma)


def _pop_twin(nw, app="h1", U=8, prof=None, req=None, **kw):
    prof = prof if prof is not None else R.paper_profile(app)
    req = req if req is not None else PAPER_MULTIAPP_REQS[app]
    return (R.Population(nw, prof, req, U, fused_ingest="numpy", **kw),
            T.Population(network_from(nw), profile_from(prof), _req(req), U,
                         device=CPU, **kw))


def _ingest_random(pair, seed, lo=0.3, hi=1.2):
    q = np.random.default_rng(seed).uniform(lo, hi, pair[0].U) * 1e9
    for p in pair:
        p.ingest(q)
        p.solve(build_solutions=False)
    return pair


def _ctrls(pops_pair, caps, **kw):
    """Twin controllers over twin cohort lists; ``caps`` = (node, link)
    arrays and SharedCapacity keywords."""
    (node_cap, link_cap), sc_kw = caps
    return (RefController(RefCapacity(node_cap=node_cap.copy(),
                                      link_cap=link_cap.copy(), **sc_kw),
                          pops_pair[0], **kw),
            T.CongestionController(T.SharedCapacity(
                node_cap=node_cap.copy(), link_cap=link_cap.copy(), **sc_kw),
                pops_pair[1], **kw))


def assert_same_loads(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def assert_ctrls(rc, pc, ctx=""):
    """Equal prices, applied cells, slices and state_dict bytes; twin
    cohorts; equal loads."""
    for f in ("node_k", "link_k", "node_cap", "link_cap"):
        assert getattr(rc, f).tobytes() == getattr(pc, f).tobytes(), (ctx, f)
    a, b = rc.state_dict(), pc.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), \
            (ctx, k)
    assert_cohorts(rc.pops, pc.pops, ctx)
    assert_same_loads(rc.loads(), pc.loads())


def run_tick_twins(rc, pc):
    a, b = rc.run_tick(), pc.run_tick()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert_ctrls(rc, pc)
    return b


def _scalar_replay_loads(pops):
    """Scalar replay of the canonical grouped reduction (groups by the raw
    (exit | placement) int32 row bytes, ascending; ``count * row``)."""
    N = pops[0].N
    node = np.zeros(N)
    link = np.zeros((N, N))
    for p in pops:
        groups = {}
        for u in range(p.U):
            if not p.inc_found[u]:
                continue
            row = np.empty(1 + p.L, dtype=np.int32)
            row[0] = p._inc_exit[u]
            row[1:] = p._inc_place[u]
            groups.setdefault(row.tobytes(), []).append(u)
        for key in sorted(groups):
            members = groups[key]
            k = int(p._inc_exit[members[0]])
            nb = p.profile.exits[k].block + 1
            cfg = Config(placement=[int(x) for x in
                                    p._inc_place[members[0]][:nb]],
                         final_exit=k)
            nrow = np.array(config_node_loads(p.profile, cfg, p.req.sigma,
                                              N))
            lrow = np.zeros((N, N))
            for a, b, x in config_link_loads(p.profile, cfg, p.src,
                                             p.req.sigma):
                lrow[a, b] += x
            node += float(len(members)) * nrow
            link += float(len(members)) * lrow
    return node, link


def _assert_caps_hold(ctrl, tol=0.0):
    """Oracle: brute-force per-user joint loads of the admitted set never
    exceed a capacity, and the canonical reduction holds exactly."""
    N = ctrl.pops[0].N
    node = np.zeros(N)
    link = np.zeros((N, N))
    for p in ctrl.pops:
        for u in range(p.U):
            if not p.inc_found[u]:
                continue
            k = int(p._inc_exit[u])
            nb = p.profile.exits[k].block + 1
            cfg = Config(placement=[int(x) for x in p._inc_place[u][:nb]],
                         final_exit=k)
            nr, lr = T.config_load_rows(p.profile, cfg, p.req.sigma, N,
                                        p.src)
            node += nr
            link += lr
    assert (node <= ctrl.node_cap * (1.0 + tol)).all()
    assert (link <= ctrl.link_cap * (1.0 + tol)).all()
    nl, ll = T.accumulate_loads(ctrl.pops)
    assert (nl <= ctrl.node_cap).all() and (ll <= ctrl.link_cap).all()


def _no_fitting_row(ctrl, k_per_exit=4):
    """Every unplaced user has no frontier row that fits the final residual
    capacity at the final prices (each rejection cross-checked against a
    canonical install)."""
    for pi, p in enumerate(ctrl.pops):
        for lu in np.nonzero(~p.inc_found)[0]:
            lu = int(lu)
            for row in p.frontier(lu, k_per_exit=k_per_exit).rows:
                assert not ctrl._fits(pi, lu, row.config, row.energy)
                save = (p._inc_place[lu].copy(), int(p._inc_exit[lu]),
                        float(p._inc_energy[lu]), bool(p._solved[lu]),
                        p._solutions[lu])
                p.set_incumbents(np.array([lu]), [row.config], [row.energy])
                nl, ll = T.accumulate_loads(ctrl.pops)
                assert (nl > ctrl.node_cap).any() \
                    or (ll > ctrl.link_cap).any()
                p._inc_place[lu] = save[0]
                p._inc_exit[lu] = save[1]
                p._inc_energy[lu] = save[2]
                p._solved[lu] = save[3]
                p._solutions[lu] = save[4]


def _busy_node(pops, nl):
    src = pops[0].src
    return int(np.argmax(np.where(np.arange(pops[0].N) == src, -1.0, nl)))


def _inf_links(N):
    return np.full((N, N), np.inf)


# ---------------------------------------------------------------------------
# loads and validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "masked", "aggregate"])
def test_accumulate_loads_matches_reference_and_replay(case):
    nw = ref_paper_scenario(n_extra_edge=1)
    kw = {"check_aggregate_load": True} if case == "aggregate" else {}
    a = _ingest_random(_pop_twin(nw, "h1", U=10, **kw), 0)
    b = _ingest_random(_pop_twin(nw, "h3", U=7, user_ids=np.arange(10, 17),
                                 **kw), 1, lo=0.05, hi=0.5)
    if case == "masked":
        for p in (a[0], a[1]):
            p.mask_node(2, users=[0, 1, 2])
            p.solve(build_solutions=False)
    ref = R.accumulate_loads([a[0], b[0]], return_groups=True)
    got = T.accumulate_loads([a[1], b[1]], return_groups=True)
    assert_same_loads(ref[:2], got[:2])
    assert_same_loads(got[:2], _scalar_replay_loads([a[1], b[1]]))
    assert len(ref[2]) == len(got[2])
    for (pi, cfg, mem, nr, lr), (qi, cfg2, mem2, nr2, lr2) in \
            zip(ref[2], got[2]):
        assert (pi, cfg.placement, cfg.final_exit) == \
            (qi, cfg2.placement, cfg2.final_exit)
        assert mem.tobytes() == mem2.tobytes()
        assert_same_loads((nr, lr), (nr2, lr2))


def test_validation_and_price_weights():
    with pytest.raises(ValueError, match="node_cap"):
        T.SharedCapacity(node_cap=np.ones((2, 2)), link_cap=np.ones((2, 2)))
    with pytest.raises(ValueError, match="link_cap"):
        T.SharedCapacity(node_cap=np.ones(3), link_cap=np.ones((2, 2)))
    with pytest.raises(ValueError, match="positive"):
        T.SharedCapacity(node_cap=np.zeros(2), link_cap=np.ones((2, 2)))
    with pytest.raises(ValueError, match="price_step"):
        T.SharedCapacity.infinite(3, price_step=1.0)
    for step, cap in ((2.0, 4096.0), (3.0, 100.0), (1.5, 1.5)):
        assert T.SharedCapacity.infinite(2, price_step=step,
                                         price_cap=cap).k_max == \
            RefCapacity.infinite(2, price_step=step, price_cap=cap).k_max
    for mode in ("uniform", "latency"):
        assert T.app_price_weights(mode=mode) == \
            R.app_price_weights(mode=mode)
        assert T.app_price_weights(list(APPS2), mode=mode) == \
            R.app_price_weights(list(APPS2), mode=mode)
    with pytest.raises(ValueError, match="unknown apps"):
        T.app_price_weights(["h9"])
    nw = ref_paper_scenario(n_extra_edge=1)
    pop = _pop_twin(nw)[1]
    with pytest.raises(ValueError, match="price_weights"):
        T.CongestionController(T.SharedCapacity.infinite(pop.N), [pop],
                               weights=[1.0, 1.0])
    with pytest.raises(ValueError, match="nodes"):
        T.CongestionController(T.SharedCapacity.infinite(pop.N + 1), [pop])
    with pytest.raises(ValueError, match="price_weights="):
        T.ChurnOrchestrator(population=[pop], price_weights=[1.0])


# ---------------------------------------------------------------------------
# controller passes: pricing, admission (the brute-force oracle), links
# ---------------------------------------------------------------------------

def _starved_pair(U=12):
    """Local execution infeasible and uniform 1 Gb/s rates: every user
    offloads, the setting of the admission tests."""
    nw = ref_paper_scenario(n_extra_edge=1)
    nw.compute[nw.source_node] *= 1e-3
    pair = _pop_twin(nw, "h1", U=U)
    bw = np.full((U, nw.n_nodes), 1e9)
    bw[:, nw.source_node] = np.inf
    for p in pair:
        p.ingest(bw)
        p.solve(build_solutions=False)
    return pair


def _starved_ctrls():
    """Twin controllers over ``_starved_pair``: every shared node capped
    near 3 users' load, price cap 4, 6 iterations."""
    pair = _starved_pair()
    assert pair[1].inc_found.all()
    nl, _ = T.accumulate_loads([pair[1]])
    node_cap = np.full(pair[1].N, np.inf)
    for n in range(pair[1].N):
        if n != pair[1].src and nl[n] > 0:
            node_cap[n] = nl[n] * 3.0 / 12 * 1.01
    return pair, _ctrls(([pair[0]], [pair[1]]),
                        ((node_cap, _inf_links(pair[1].N)),
                         dict(price_cap=4.0, max_iters=6)))


def test_admission_when_prices_cap_matches_reference():
    """Pricing cannot fix it (price cap 4), admission evicts to
    feasibility: equal reports and incumbents; the brute-force oracles
    hold on the port."""
    pair, (rc, pc) = _starved_ctrls()
    r = run_tick_twins(rc, pc)
    assert r.capped and not r.converged and r.n_rejected > 0
    p = pair[1]
    assert 0 < int(p.inc_found.sum()) < 12
    assert r.unplaced_ids == sorted(int(g) for g in p.user_ids[~p.inc_found])
    _assert_caps_hold(pc, tol=1e-12)
    _no_fitting_row(pc)
    assert not np.isfinite(p._inc_energy[~p.inc_found]).any()


def test_moved_gids_are_exactly_the_changed_incumbents():
    """``CongestionReport.moved_gids`` (equal to the reference's) is the
    set of users whose found flag, exit, placement or energy changed."""
    pair, (rc, pc) = _starved_ctrls()
    p = pair[1]
    f0, e0, pl0, en0 = (p.inc_found.copy(), p._inc_exit.copy(),
                        p._inc_place.copy(), p._inc_energy.copy())
    r = run_tick_twins(rc, pc)
    assert r.touched
    changed = [int(p.user_ids[u]) for u in range(p.U)
               if f0[u] != p.inc_found[u] or (p.inc_found[u] and (
                   e0[u] != p._inc_exit[u]
                   or (pl0[u] != p._inc_place[u]).any()
                   or en0[u] != p._inc_energy[u]))]
    assert r.moved_gids == sorted(changed) and r.moved_gids
    assert set(r.unplaced_ids) <= set(r.moved_gids)


@pytest.mark.parametrize("max_iters", [16, 2])
def test_pricing_resolves_oversubscription_matches_reference(max_iters):
    """Caps that repricing alone can meet: converged, no eviction, and a
    warm next pass is a no-op; cut one iteration short, the report still
    says converged when the last bump cleared the overload."""
    nw = ref_paper_scenario(n_extra_edge=1)
    pair = _ingest_random(_pop_twin(nw, "h1", U=12), 0, lo=1.0, hi=1.0)
    nl, _ = T.accumulate_loads([pair[1]])
    busy = _busy_node([pair[1]], nl)
    node_cap = np.full(pair[1].N, np.inf)
    node_cap[busy] = nl[busy] * 0.4
    rc, pc = _ctrls(([pair[0]], [pair[1]]),
                    ((node_cap, _inf_links(pair[1].N)),
                     dict(max_iters=max_iters)))
    r = run_tick_twins(rc, pc)
    assert r.converged and not r.capped and r.n_evicted == 0
    assert pc.node_price[busy] > 1.0
    _assert_caps_hold(pc, tol=1e-12)
    r2 = run_tick_twins(rc, pc)
    assert r2.iterations == 1 and r2.n_repriced == 0


def test_link_capacity_and_zero_weight_cohort_match_reference():
    """A choked edge -> cloud backhaul link repriced through
    ``update_backhaul``; then a sheltered (w = 0) cohort beside a priced
    one."""
    nw = ref_paper_scenario(n_extra_edge=1)
    pair = _ingest_random(_pop_twin(nw, "h1", U=10), 1, lo=1.0, hi=1.0)
    cloud = int(np.argmax(nw.compute))
    prof = pair[1].profile
    k = len(prof.exits) - 1
    nb = prof.exits[k].block + 1
    place = [1] * (nb // 2) + [cloud] * (nb - nb // 2)
    for p, mod in zip(pair, (R, T)):
        cfg = mod.Config(placement=list(place), final_exit=k)
        ev = mod.evaluate_config(p.network0, p.profile, p.req, cfg)
        assert ev.feasible
        p.set_incumbents(np.arange(p.U), [cfg] * p.U, [ev.energy] * p.U)
    _nl, ll = T.accumulate_loads([pair[1]])
    link_cap = _inf_links(pair[1].N)
    link_cap[1, cloud] = ll[1, cloud] * 0.5
    rc, pc = _ctrls(([pair[0]], [pair[1]]),
                    ((np.full(pair[1].N, np.inf), link_cap), {}))
    r = run_tick_twins(rc, pc)
    assert r.converged and r.touched and pc.link_price[1, cloud] > 1.0
    assert pair[1]._proto.stats.backhaul_updates > 0
    _assert_caps_hold(pc, tol=1e-12)

    a = _ingest_random(_pop_twin(nw, "h1", U=6), 0, lo=1.0, hi=1.0)
    b = _ingest_random(_pop_twin(nw, "h1", U=6, user_ids=np.arange(6, 12)),
                       0, lo=1.0, hi=1.0)
    nl, _ = T.accumulate_loads([a[1], b[1]])
    busy = _busy_node([a[1]], nl)
    node_cap = np.full(a[1].N, np.inf)
    node_cap[busy] = nl[busy] * 0.4
    rc, pc = _ctrls(([a[0], b[0]], [a[1], b[1]]),
                    ((node_cap, _inf_links(a[1].N)), {}),
                    weights=[0.0, 1.0])
    s0 = a[1]._proto.stats.slice_updates
    run_tick_twins(rc, pc)
    assert a[1]._proto.stats.slice_updates == s0
    _assert_caps_hold(pc, tol=1e-12)


def test_renegotiate_slice_composes_with_prices_and_state_roundtrip():
    """A slice renegotiation under prices composes (base * step**(-k*w))
    as in the reference; the controller's ``state_dict`` equals the
    reference's, and ``restore_state`` into fresh cohorts re-installs the
    priced tensors, so the next pass matches the original's."""
    nw = ref_paper_scenario(n_extra_edge=1)

    def congested():
        pair = _ingest_random(_pop_twin(nw, "h1", U=12), 0, lo=1.0, hi=1.0)
        nl, _ = T.accumulate_loads([pair[1]])
        busy = _busy_node([pair[1]], nl)
        node_cap = np.full(pair[1].N, np.inf)
        node_cap[busy] = nl[busy] * 0.4
        return pair, busy, ((node_cap, _inf_links(pair[1].N)), {})

    pair, busy, caps = congested()
    rc, pc = _ctrls(([pair[0]], [pair[1]]), caps)
    run_tick_twins(rc, pc)
    assert pc.node_k[busy] > 0
    for c in (rc, pc):
        c.renegotiate_slice(0.9)
    frac = pc.step ** (-pc.node_k.astype(np.float64))
    assert pair[1]._proto._slice_frac.tobytes() == \
        (np.full(pair[1].N, 0.9) * frac).tobytes()
    assert pair[1]._proto._slice_frac.tobytes() == \
        pair[0]._proto._slice_frac.tobytes()
    for c in (rc, pc):
        c.node_k[busy] += 1
        c._apply_prices()
    assert_ctrls(rc, pc)
    with pytest.raises(ValueError, match="finite"):
        pc.renegotiate_slice(0.0)
    snap = pc.state_dict()
    fresh, _busy, caps = congested()
    fc = T.CongestionController(T.SharedCapacity(
        node_cap=caps[0][0], link_cap=caps[0][1]), [fresh[1]])
    fc.restore_state(snap)
    fresh[1].restore_state(pair[1].state_dict())
    assert fresh[1]._proto._slice_frac.tobytes() == \
        pair[1]._proto._slice_frac.tobytes()
    assert fresh[1]._proto.network.bandwidth.tobytes() == \
        pair[1]._proto.network.bandwidth.tobytes()
    a, b = pc.run_tick(), fc.run_tick()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    da, db = pair[1].state_dict(), fresh[1].state_dict()
    assert all(da[k].tobytes() == db[k].tobytes() for k in da)
    with pytest.raises(ValueError, match="cohorts"):
        fc.restore_state({**snap, "base_slice": np.ones((2, pair[1].N))})


# ---------------------------------------------------------------------------
# the orchestrator, coupled
# ---------------------------------------------------------------------------

def _cap_orchs(U, cap_frac=None, weights=None, pop_kw=None, **kw):
    """Twin coupled orchestrators over h1 / h5 cohorts on the one-helper
    scenario; ``cap_frac`` caps the busiest shared node of an uncoupled
    probe (None: infinite capacity)."""
    pk = dict(apps={a: PAPER_MULTIAPP_REQS[a] for a in APPS2},
              n_extra_edge=1, **(pop_kw or {}))
    probe = T.population_cohorts(U, device=CPU, **pk)
    N = probe[0].N
    node_cap = np.full(N, np.inf)
    if cap_frac is not None:
        probe_o = T.ChurnOrchestrator(population=probe)
        nl, _ = T.accumulate_loads(probe_o.pops)
        busy = _busy_node(probe_o.pops, nl)
        node_cap[busy] = max(nl[busy] * cap_frac, 1.0)
    return (
        R.ChurnOrchestrator(population=R.population_cohorts(
            U, fused_ingest="numpy", **pk),
            shared_capacity=RefCapacity(node_cap=node_cap.copy(),
                                        link_cap=_inf_links(N)),
            price_weights=weights, **kw),
        T.ChurnOrchestrator(population=T.population_cohorts(
            U, device=CPU, **pk),
            shared_capacity=T.SharedCapacity(node_cap=node_cap.copy(),
                                             link_cap=_inf_links(N)),
            price_weights=weights, **kw))


def _trajectory_twins(pair, trace):
    """Step the twins; equal reports and price exponents every tick."""
    ro, po = pair
    traj = []
    for evs, pev in zip(trace, events(trace)):
        a, b = ro.step(evs), po.step(pev)
        assert rep(a) == rep(b), (rep(a), rep(b))
        assert ro.congestion.node_k.tobytes() == \
            po.congestion.node_k.tobytes()
        assert ro.congestion.link_k.tobytes() == \
            po.congestion.link_k.tobytes()
        traj.append(po.congestion.node_k.copy())
    assert_cohorts(ro.pops, po.pops)
    assert_ledgers(ro, po)
    return traj


@pytest.mark.parametrize("weights", ["uniform", "latency"])
def test_congested_churn_price_trajectory_matches_reference(weights):
    U = 16
    pair = _cap_orchs(U, cap_frac=0.5,
                      weights=T.app_price_weights(list(APPS2), mode=weights))
    traj = _trajectory_twins(pair, R.churn_trace(U, n_ticks=4, seed=13))
    assert traj[-1].max() > 0
    po = pair[1]
    _assert_caps_hold(po.congestion, tol=1e-12)
    for p in po.pops:
        e = np.where(p.inc_found, p._inc_energy, np.inf)
        assert np.array_equal(po._cur_energy[p.user_ids], e)


def test_infinite_caps_bitexact_vs_uncoupled():
    """Infinite capacity: the port's coupled run equals its uncoupled run
    and the reference's coupled run, and the controller stays inactive."""
    U = 16
    trace = R.churn_trace(U, n_ticks=5, seed=13)
    pair = _cap_orchs(U)
    _trajectory_twins(pair, trace)
    po = pair[1]
    plain = T.ChurnOrchestrator(population=T.population_cohorts(
        U, device=CPU, apps={a: PAPER_MULTIAPP_REQS[a] for a in APPS2},
        n_extra_edge=1))
    for pev in events(trace):
        plain.step(pev)
    for p1, p2 in zip(plain.pops, po.pops):
        assert_twins(p1, p2)
    assert po.congestion.node_price.max() == 1.0
    assert not po.congestion._active


def test_slice_event_unpriced_coupled_bitexact_vs_uncoupled():
    """A slice event through an idle controller composes to exactly the
    base fraction: coupled == uncoupled == the reference's coupled."""
    U = 12
    pair = _cap_orchs(U)
    ev = [R.ChurnEvent(kind="slice", user=None, value=0.8)]
    _trajectory_twins(pair, [ev])
    plain = T.ChurnOrchestrator(population=T.population_cohorts(
        U, device=CPU, apps={a: PAPER_MULTIAPP_REQS[a] for a in APPS2},
        n_extra_edge=1))
    plain.step(events([ev])[0])
    assert not pair[1].congestion._active
    for p1, p2 in zip(plain.pops, pair[1].pops):
        assert p1._proto._slice_frac.tobytes() == \
            p2._proto._slice_frac.tobytes()
        assert_twins(p1, p2)


def test_slice_event_composes_and_array_ticks_match_reference():
    """A slice event on a priced run composes with the prices in every
    cohort, then array ticks (the synchronous path ``run_arrays`` takes
    under congestion) continue the trajectory."""
    U = 16
    pair = _cap_orchs(U, cap_frac=0.4)
    _trajectory_twins(pair, [[], [R.ChurnEvent("slice", None, 0.9)]])
    po = pair[1]
    for pi, p in enumerate(po.pops):
        w = po.congestion.weights[pi]
        expect = 0.9 * po.congestion.step \
            ** (-po.congestion.node_k.astype(np.float64) * w)
        assert p._proto._slice_frac.tobytes() == expect.tobytes()
    qual = np.random.default_rng(2).uniform(0.3, 1.0, (3, U))
    a = [pair[0].step_arrays(q) for q in qual]
    b = po.run_arrays(qual)
    assert [rep(r) for r in a] == [rep(r) for r in b]
    assert_cohorts(pair[0].pops, po.pops)
    _assert_caps_hold(po.congestion, tol=1e-12)


# ---------------------------------------------------------------------------
# the randomized fixed points (tests/test_capacity.py's seeded sweep)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_random_capacity_fixed_points(seed):
    """Random small populations, caps and price grids: the port's pass
    equals the reference's, never leaves a capacity violated among the
    admitted users, and leaves no unplaced user a fitting row; infinite
    caps are read-only."""
    rng = np.random.default_rng(3000 + seed)
    nw = ref_paper_scenario(n_extra_edge=int(rng.integers(0, 2)))
    n_blocks = int(rng.integers(2, 5))
    prof = R.synthetic_profile(n_blocks, min(n_blocks,
                                             int(rng.integers(1, 3))),
                               seed=3000 + seed)
    alpha = float(rng.uniform(0.0, max(e.accuracy for e in prof.exits)))
    req = R.AppRequirements(alpha=alpha,
                            delta=float(rng.uniform(1e-3, 20e-3)))
    U = int(rng.integers(2, 9))
    pair = _pop_twin(nw, U=U, prof=prof, req=req)
    q = rng.uniform(0.2, 1.2, U) * 1e9
    for p in pair:
        p.ingest(q)
        p.solve(build_solutions=False)
    assert_twins(*pair)
    if not pair[1].inc_found.any():
        return
    nl, ll = T.accumulate_loads([pair[1]])
    assert_same_loads((nl, ll), _scalar_replay_loads([pair[1]]))
    inc = pair[1]._inc_place.copy()
    r0 = T.CongestionController(T.SharedCapacity.infinite(pair[1].N),
                                [pair[1]]).run_tick()
    assert r0.converged and not r0.touched and r0.moved_gids == []
    assert inc.tobytes() == pair[1]._inc_place.tobytes()

    src = nw.source_node
    N = pair[1].N
    node_cap = np.full(N, np.inf)
    link_cap = _inf_links(N)
    for n in range(N):
        if n != src and nl[n] > 0 and rng.random() < 0.7:
            node_cap[n] = nl[n] * float(rng.uniform(0.2, 1.5))
    lo = ll.copy()
    lo[src, :] = 0.0
    lo[:, src] = 0.0
    for i, j in zip(*np.nonzero(lo > 0)):
        if rng.random() < 0.5:
            link_cap[i, j] = ll[i, j] * float(rng.uniform(0.2, 1.5))
    if not (np.isfinite(node_cap).any() or np.isfinite(link_cap).any()):
        return
    sc_kw = dict(price_step=float(rng.uniform(1.5, 4.0)),
                 price_cap=float(rng.choice([4.0, 64.0, 4096.0])),
                 max_iters=int(rng.integers(2, 10)))
    fk = int(rng.integers(1, 5))
    rc, pc = _ctrls(([pair[0]], [pair[1]]), ((node_cap, link_cap), sc_kw),
                    frontier_k=fk)
    r = run_tick_twins(rc, pc)
    assert r.iterations <= pc.capacity.max_iters
    _assert_caps_hold(pc, tol=1e-12)
    _no_fitting_row(pc, k_per_exit=fk)
    assert r.unplaced_ids == sorted(
        int(g) for g in pair[1].user_ids[~pair[1].inc_found])
