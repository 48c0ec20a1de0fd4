"""k-best FIN and the Pareto frontier of the PyTorch port vs the JAX package.

* ``solve_fin`` / ``solve_many`` with ``n_best > 1`` on the port's
  ``minplus`` backend return exactly the reference's ``minplus`` solutions
  (its float64 numpy k-best engine); the port's ``f32`` k-best picks the
  reference ``pallas`` configurations (interpret mode, one tiny case).
* The frontier module's functions are bit-equal on seeded inputs:
  ``pareto_mask``, ``frontier_from_rows``, ``brute_force_frontier``,
  ``eval_config_users`` and ``scan_state_users``.
* ``Plan(n_best=32).frontier(k_per_exit=None)`` rows equal the reference's.

Scenarios are carried across with ``repro_torch.convert``; everything runs
on the CPU.
"""
import itertools

import numpy as np
import pytest

import repro.core as R
from repro.core import fin as rfin
from repro.core import frontier as rfr
from repro.core.multiapp import PAPER_MULTIAPP_REQS
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.core.scenarios import sweep_scenarios as ref_sweep

import repro_torch as T
from repro_torch.convert import (config_from, network_from, profile_from,
                                 requirements_from, scenarios_from)
from repro_torch.core import fin as tfin
from repro_torch.core import frontier as tfr

from test_torch_fin import assert_same, same_config

CPU = "cpu"


def _req(r):
    return requirements_from(r.alpha, r.delta, r.sigma)


def _small_scenario(seed: int):
    """The reference frontier tests' small random scenario, both sides."""
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(2, 5))
    prof = R.synthetic_profile(n_blocks,
                               min(n_blocks, int(rng.integers(1, 3))),
                               seed=seed)
    frac = rng.uniform(1e-4, 1e-2, 3)
    frac[0] = rng.uniform(1e-4, 5e-3)
    nw = R.make_network(("mobile", "edge", "cloud"), compute_frac=frac,
                        bw_frac=float(rng.uniform(0.001, 0.01)))
    alpha = float(rng.uniform(0.0, max(e.accuracy for e in prof.exits)))
    req = R.AppRequirements(alpha=alpha,
                            delta=float(rng.uniform(1e-3, 20e-3)))
    return (nw, prof, req), (network_from(nw), profile_from(prof), _req(req))


def _rows(fr):
    return ([(r.energy, r.latency, r.accuracy, r.final_exit,
              tuple(r.config.placement)) for r in fr.rows],
            None if fr.argmin is None else fr.rows.index(fr.argmin))


# ---------------------------------------------------------------------------
# k-best solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_best", [2, 4, 32])
def test_solve_fin_kbest_matches_reference(n_best):
    ref_nw = ref_paper_scenario(n_extra_edge=2)
    nw = network_from(ref_nw)
    for app in ("h1", "h2", "h4", "h6"):
        ref_pf = R.paper_profile(app)
        pf = profile_from(ref_pf)
        ref_req = PAPER_MULTIAPP_REQS[app]
        for gamma in (3, 10):
            for quantize in ("floor", "ceil"):
                want = R.solve_fin(ref_nw, ref_pf, ref_req, gamma=gamma,
                                   quantize=quantize, n_best=n_best)
                got = T.solve_fin(nw, pf, _req(ref_req), gamma=gamma,
                                  quantize=quantize, n_best=n_best,
                                  device=CPU)
                assert_same(want, got)


@pytest.mark.parametrize("n_best", [2, 4, 32])
def test_solve_many_kbest_matches_reference(n_best):
    ps, ns, rs = ref_sweep(deltas_ms=(0.8, 2.0, 5.0, 12.0),
                           uplinks_bps=(1e9, 0.4e9), n_extra_edge=2)
    tp, tn, tr = scenarios_from(ps, ns, rs)
    for gamma, lam in ((3, None), (10, 4), (25, None)):
        want = R.solve_many(ps, ns, rs, gamma=gamma, lam=lam, n_best=n_best)
        got = T.solve_many(tp, tn, tr, gamma=gamma, lam=lam, n_best=n_best,
                           device=CPU)
        assert len(got) == len(want) >= 40
        for w, g in zip(want, got):
            assert_same(w, g)


def test_f32_kbest_picks_pallas_configs():
    """The reference's k-slot Pallas kernel in interpret mode (slow, so one
    tiny case) against the port's float32 k-slot chain."""
    ref_nw = ref_paper_scenario()
    ref_pf = R.paper_profile("h6")
    ref_req = R.AppRequirements(0.93, 0.5e-3)
    want = R.solve_fin(ref_nw, ref_pf, ref_req, gamma=5, n_best=2,
                       backend="pallas")
    got = T.solve_fin(network_from(ref_nw), profile_from(ref_pf),
                      _req(ref_req), gamma=5, n_best=2, backend="f32",
                      device=CPU)
    assert want.found and same_config(want, got)
    assert want.energy == got.energy


def test_n_best_validation():
    nw = T.paper_scenario()
    pf = T.paper_profile("h1")
    req = T.AppRequirements(0.55, 5e-3)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="n_best"):
            T.solve_fin(nw, pf, req, n_best=bad, device=CPU)
        with pytest.raises(ValueError, match="n_best"):
            T.solve_many(pf, nw, req, n_best=bad, device=CPU)
        with pytest.raises(ValueError, match="n_best"):
            T.Plan(nw, pf, req, n_best=bad, device=CPU)


# ---------------------------------------------------------------------------
# frontier units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_pareto_mask_bit_equal(seed):
    rng = np.random.default_rng(seed)
    R_ = 40
    e = np.round(rng.uniform(0, 4, R_), 1)          # many exact ties
    lat = np.round(rng.uniform(0, 4, R_), 1)
    acc = rng.choice([0.7, 0.8, 0.9], R_)
    e[5], lat[5], acc[5] = e[3], lat[3], acc[3]     # a duplicate tuple
    for keep in (None, int(rng.integers(R_))):
        want = rfr.pareto_mask(e, lat, acc, always_keep=keep)
        got = tfr.pareto_mask(e, lat, acc, always_keep=keep)
        np.testing.assert_array_equal(got, want)
    assert tfr.pareto_mask([], [], []).shape == (0,)


@pytest.mark.parametrize("seed", range(6))
def test_brute_force_and_frontier_from_rows_bit_equal(seed):
    (rnw, rpf, rrq), (nw, pf, rq) = _small_scenario(100 + seed)
    want = rfr.brute_force_frontier(rnw, rpf, rrq)
    got = tfr.brute_force_frontier(nw, pf, rq)
    assert _rows(got) == _rows(want)
    # frontier_from_rows over every config, with a pinned argmin pair
    pairs_r, pairs_t = [], []
    for k in range(rpf.n_exits):
        for place in itertools.product(range(rnw.n_nodes),
                                       repeat=rpf.exits[k].block + 1):
            rc = R.Config(placement=list(place), final_exit=k)
            tc = config_from(place, k)
            pairs_r.append((rc, R.evaluate_config(rnw, rpf, rrq, rc)))
            pairs_t.append((tc, T.evaluate_config(nw, pf, rq, tc)))
    feas = [j for j, (_, ev) in enumerate(pairs_r) if ev.feasible]
    pin = feas[len(feas) // 2] if feas else None
    want = rfr.frontier_from_rows(pairs_r, None if pin is None
                                  else pairs_r[pin])
    got = tfr.frontier_from_rows(pairs_t, None if pin is None
                                 else pairs_t[pin])
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("check_aggregate_load", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_eval_config_users_bit_equal(seed, check_aggregate_load):
    rng = np.random.default_rng(seed)
    ref_nw = ref_paper_scenario(n_extra_edge=int(rng.integers(0, 3)))
    nw = network_from(ref_nw)
    N, src = ref_nw.n_nodes, ref_nw.source_node
    bwv = rng.uniform(0.05, 1.5, (9, N)) * 1e9
    bwv[0, 1] = 0.0                                  # a dead link
    bwv[:, src] = np.inf
    for app in ("h1", "h3", "h5"):
        ref_pf = R.paper_profile(app)
        pf = profile_from(ref_pf)
        ref_req = R.AppRequirements(0.5, float(rng.uniform(2e-3, 9e-3)))
        for _ in range(6):
            k = int(rng.integers(ref_pf.n_exits))
            place = rng.integers(0, N, ref_pf.exits[k].block + 1).tolist()
            want = rfr.eval_config_users(
                ref_pf, ref_req, ref_nw.nodes, ref_nw.bandwidth,
                ref_nw.compute, src, R.Config(place, k), bwv,
                check_aggregate_load=check_aggregate_load)
            got = tfr.eval_config_users(
                pf, _req(ref_req), nw.nodes, nw.bandwidth, nw.compute, src,
                config_from(place, k), bwv,
                check_aggregate_load=check_aggregate_load)
            for a, b in zip(got[:3], want[:3]):
                assert a == b
            assert got[3].tobytes() == want[3].tobytes()
            np.testing.assert_array_equal(got[4], want[4])


def _candidates(fin_mod, dp, profile):
    """``candidate(k, j)``: the j-th ``_iter_configs_at_exit`` item."""
    cache = {}

    def candidate(k, j):
        if k not in cache:
            cache[k] = ([], fin_mod._iter_configs_at_exit(dp, profile, k))
        got, it = cache[k]
        while len(got) <= j:
            item = next(it, None)
            if item is None:
                return None
            got.append(item)
        return got[j]
    return candidate


@pytest.mark.parametrize("n_best", [1, 4])
@pytest.mark.parametrize("seed", range(3))
def test_scan_state_users_bit_equal(seed, n_best):
    rng = np.random.default_rng(seed)
    ref_nw = ref_paper_scenario(n_extra_edge=2)
    nw = network_from(ref_nw)
    N, src = ref_nw.n_nodes, ref_nw.source_node
    app = ("h1", "h2", "h5")[seed]
    ref_pf = R.paper_profile(app)
    pf = profile_from(ref_pf)
    ref_req = PAPER_MULTIAPP_REQS[app]
    rq = _req(ref_req)
    adm = [k for k in range(ref_pf.n_exits)
           if ref_pf.accuracy_of(k) >= ref_req.alpha - 1e-12]
    rfg = R.build_feasible_graph(R.build_extended_graph(ref_nw, ref_pf,
                                                        ref_req), 10)
    tfg = T.build_feasible_graph(T.build_extended_graph(nw, pf, rq,
                                                        device=CPU), 10)
    rdp = rfin._run_dp_batch([rfg], n_best=n_best)[0]
    tdp = tfin._run_dp_batch([tfg], n_best)[0]
    Us = 12
    bwv = rng.uniform(0.05, 1.2, (Us, N)) * 1e9
    bwv[:, src] = np.inf
    bound = rng.uniform(0, 2, Us) * 1e-2
    bound[::3] = np.nan
    for bound_energy in (None, bound):
        want = rfr.scan_state_users(
            rdp, ref_pf, adm, _candidates(rfin, rdp, ref_pf),
            lambda cfg, users: rfr.eval_config_users(
                ref_pf, ref_req, ref_nw.nodes, ref_nw.bandwidth,
                ref_nw.compute, src, cfg, bwv[users]),
            Us, bound_energy=bound_energy)
        got = tfr.scan_state_users(
            tdp, pf, adm, _candidates(tfin, tdp, pf),
            lambda cfg, users: tfr.eval_config_users(
                pf, rq, nw.nodes, nw.bandwidth, nw.compute, src, cfg,
                bwv[users]),
            Us, bound_energy=bound_energy)
        assert got.found.any()
        for f in ("exit", "cand", "energy", "latency", "e_comp", "e_comm"):
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f


def test_frontier_best_and_cheapest_avoiding():
    ref_pf = R.paper_profile("h2")
    pf = profile_from(ref_pf)
    out = []
    for mod, cfg_of, ev_of, prof in (
            (rfr, R.Config, R.problem.ConfigEval, ref_pf),
            (tfr, T.Config, T.ConfigEval, pf)):
        a = cfg_of(placement=[0, 0, 0], final_exit=1)
        b = cfg_of(placement=[4, 4, 4], final_exit=1)
        ev_a = ev_of(energy=1.0, energy_comp=1.0, energy_comm=0.0,
                     latency=2.0, accuracy=0.78, feasible=True)
        ev_b = ev_of(energy=1.2, energy_comp=1.2, energy_comm=0.0,
                     latency=1.0, accuracy=0.78, feasible=True)
        fr = mod.frontier_from_rows([(a, ev_a), (b, ev_b)], (a, ev_a))
        row0, bits0 = fr.best(profile=prof, old_config=b,
                              migration_weight=0.0)
        row1, bits1 = fr.best(profile=prof, old_config=b,
                              migration_weight=1.0)
        pick = mod.frontier_pick(fr, b, True, 1.1, prof, 1e-9)
        out.append((row0.config.placement, bits0, row1.config.placement,
                    bits1, fr.cheapest_avoiding([0]).config.placement,
                    fr.cheapest_avoiding([0, 4]), pick[1:]))
    assert out[0] == out[1]
    assert out[1][2] == [4, 4, 4] and out[1][3] == 0.0


# ---------------------------------------------------------------------------
# Plan.frontier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", ["floor", "round"])
def test_plan_frontier_rows_equal_reference(quantize):
    for seed in range(5):
        (rnw, rpf, rrq), (nw, pf, rq) = _small_scenario(100 + seed)
        ref = R.Plan(rnw, rpf, rrq, gamma=10, quantize=quantize, n_best=32)
        got = T.Plan(nw, pf, rq, gamma=10, quantize=quantize, n_best=32,
                     device=CPU)
        want_fr = ref.frontier(k_per_exit=None)
        got_fr = got.frontier(k_per_exit=None)
        assert _rows(got_fr) == _rows(want_fr), seed
        assert_same(ref.solution, got.solution)
        if quantize == "floor":
            # floor covers every exactly-feasible config (the reference's
            # brute-force acceptance test): the rows are the enumeration's
            brute = {(r[3], r[4]) for r in _rows(
                tfr.brute_force_frontier(nw, pf, rq))[0]}
            rows = {(r[3], r[4]) for r in _rows(got_fr)[0]}
            assert brute <= rows


def test_plan_frontier_per_exit_on_paper_grid():
    """k_per_exit=4 at n_best=4 over every app after uplink deltas, with
    the frontier's argmin equal to the warm solve."""
    ref_nw = ref_paper_scenario(n_extra_edge=2)
    nw = network_from(ref_nw)
    rng = np.random.default_rng(6)
    for app in ("h1", "h2", "h3", "h4", "h5", "h6"):
        ref_pf = R.paper_profile(app)
        ref_req = PAPER_MULTIAPP_REQS[app]
        ref = R.Plan(ref_nw, ref_pf, ref_req, gamma=25, n_best=4)
        got = T.Plan(nw, profile_from(ref_pf), _req(ref_req), gamma=25,
                     n_best=4, device=CPU)
        for _ in range(2):
            q = float(rng.uniform(0.3, 1.0)) * 1e9
            ref.update_uplink(q)
            got.update_uplink(q)
            fr = got.frontier(k_per_exit=4)
            assert _rows(fr) == _rows(ref.frontier(k_per_exit=4)), app
            sol = got.solve()
            if sol.feasible:
                assert fr.argmin.config == sol.config
                assert fr.argmin.energy == sol.energy
