"""FIN solver of the PyTorch port vs the JAX package's reference.

``solve_fin`` / ``solve_many`` with the port's ``minplus`` backend must
return exactly the reference's ``backend="minplus"`` solutions: the same
configuration, every ``ConfigEval`` field bit-equal, and the same ``meta``
apart from timings.  The port's ``f32`` backend must pick the reference
``jnp`` backend's configurations (and its ``pallas`` one on a tiny case).
MCP and Opt must match on the paper scenario.  The scenarios are carried
across with ``repro_torch.convert``; everything runs on the CPU.
"""
import numpy as np
import pytest

import repro.core as R
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.core.scenarios import sweep_scenarios as ref_sweep

import repro_torch as T
from repro_torch.convert import (network_from, profile_from,
                                 requirements_from, scenarios_from)

APPS = ("h1", "h2", "h3", "h4", "h5", "h6")
CPU = "cpu"
EVAL_FIELDS = ("energy", "energy_comp", "energy_comm", "latency", "accuracy",
               "feasible", "violations", "_energy_rate")
TIMINGS = ("batch_time",)


def assert_same(ref, got, *, meta=True):
    assert ref.found == got.found
    assert ref.solver == got.solver
    if meta:
        want = {k: v for k, v in ref.meta.items() if k not in TIMINGS}
        have = {k: v for k, v in got.meta.items() if k not in TIMINGS}
        assert have == want
    if not ref.found:
        return
    assert got.config.placement == ref.config.placement
    assert got.config.final_exit == ref.config.final_exit
    for f in EVAL_FIELDS:
        assert getattr(got.eval, f) == getattr(ref.eval, f), f


def same_config(ref, got) -> bool:
    if ref.found != got.found:
        return False
    return (not ref.found
            or (got.config.placement == ref.config.placement
                and got.config.final_exit == ref.config.final_exit))


@pytest.fixture(scope="module")
def scenario():
    ref = ref_paper_scenario()
    return ref, network_from(ref)


@pytest.mark.parametrize("n_extra_edge", [0, 2])
@pytest.mark.parametrize("app", APPS)
def test_solve_fin_matches_reference(app, n_extra_edge):
    ref_nw = ref_paper_scenario(n_extra_edge=n_extra_edge)
    nw = network_from(ref_nw)
    ref_pf = R.paper_profile(app)
    pf = profile_from(ref_pf)
    alpha = min(e.accuracy for e in ref_pf.exits)
    for gamma in (3, 10, 25):
        for delta in (2e-3, 5e-3, 12e-3):
            ref_req = R.AppRequirements(alpha, delta)
            req = requirements_from(alpha, delta)
            for quantize in ("floor", "ceil"):
                want = R.solve_fin(ref_nw, ref_pf, ref_req, gamma=gamma,
                                   quantize=quantize, backend="minplus")
                got = T.solve_fin(nw, pf, req, gamma=gamma, quantize=quantize,
                                  device=CPU)
                assert_same(want, got)


@pytest.mark.parametrize("n_extra_edge", [0, 2])
@pytest.mark.parametrize("gamma", [3, 10, 25])
def test_solve_many_sweep_matches_reference(gamma, n_extra_edge):
    """The grid of the reference's solve_many test, batched and looped."""
    ps, ns, rs = ref_sweep(deltas_ms=(2.0, 5.0, 12.0),
                           uplinks_bps=(1e9, 0.5e9),
                           n_extra_edge=n_extra_edge)
    tp, tn, tr = scenarios_from(ps, ns, rs)
    want = R.solve_many(ps, ns, rs, gamma=gamma, backend="minplus")
    got = T.solve_many(tp, tn, tr, gamma=gamma, device=CPU)
    assert len(got) == len(want) >= 20
    for w, g in zip(want, got):
        assert_same(w, g)
    if gamma == 10:
        for pf, nw, rq, g in zip(tp, tn, tr, got):
            assert_same(g, T.solve_fin(nw, pf, rq, gamma=gamma, device=CPU),
                        meta=False)


def test_solve_many_mixed_sizes_and_broadcast(scenario):
    ref_nw, nw = scenario
    ref_profs = [R.paper_profile("h2"), R.paper_profile("h6"),
                 R.synthetic_profile(4, 2, seed=0),
                 R.synthetic_profile(1, 1, seed=2)]
    profs = [profile_from(p) for p in ref_profs]
    want = R.solve_many(ref_profs, ref_nw, R.AppRequirements(0.0, 8e-3))
    got = T.solve_many(profs, nw, requirements_from(0.0, 8e-3), device=CPU)
    for w, g in zip(want, got):
        assert_same(w, g)


def test_solve_many_infeasible_alpha_slot(scenario):
    ref_nw, nw = scenario
    ref_pf = R.paper_profile("h2")            # best exit accuracy < 0.95
    ref_reqs = [R.AppRequirements(0.80, 5e-3), R.AppRequirements(0.95, 5e-3)]
    reqs = [requirements_from(r.alpha, r.delta) for r in ref_reqs]
    want = R.solve_many(ref_pf, ref_nw, ref_reqs)
    got = T.solve_many(profile_from(ref_pf), nw, reqs, device=CPU)
    assert got[0].feasible and not got[1].found
    assert "alpha" in got[1].meta["reason"]
    for w, g in zip(want, got):
        assert_same(w, g)


@pytest.mark.parametrize("quantize", ["floor", "round"])
def test_solve_many_tighten_loop_and_lambda(scenario, quantize):
    """Small gamma with a lambda window drives the tighten loop and the ceil
    rescue pass; both must follow the reference round for round."""
    ps, ns, rs = ref_sweep(apps=("h1", "h3", "h5"),
                           deltas_ms=(0.8, 1.5, 3.0, 6.0),
                           uplinks_bps=(0.4e9, 2e9), n_extra_edge=1)
    tp, tn, tr = scenarios_from(ps, ns, rs)
    for lam in (None, 2):
        want = R.solve_many(ps, ns, rs, gamma=3, lam=lam, quantize=quantize)
        got = T.solve_many(tp, tn, tr, gamma=3, lam=lam, quantize=quantize,
                           device=CPU)
        for w, g in zip(want, got):
            assert_same(w, g)
    assert any(g.meta.get("tighten_rounds", 0) for g in got) or \
        any(g.meta.get("used_ceil_pass") for g in got)


def test_f32_picks_jnp_configs():
    ps, ns, rs = ref_sweep(apps=("h2", "h6"), deltas_ms=(2.0, 8.0),
                           uplinks_bps=(1e9, 0.3e9), n_extra_edge=2)
    tp, tn, tr = scenarios_from(ps, ns, rs)
    for gamma in (10, 25):
        want = R.solve_many(ps, ns, rs, gamma=gamma, backend="jnp")
        got = T.solve_many(tp, tn, tr, gamma=gamma, backend="f32",
                           device=CPU)
        assert all(same_config(w, g) for w, g in zip(want, got))
        exact = T.solve_many(tp, tn, tr, gamma=gamma, device=CPU)
        for g, x in zip(got, exact):
            if g.found:
                assert abs(g.energy - x.energy) <= \
                    T.core.tolerances.DIST_RTOL_F32 * x.energy


def test_f32_matches_pallas_solve_fin(scenario):
    """The reference test's pallas case (h6, gamma=5): interpret mode."""
    ref_nw, nw = scenario
    ref_pf = R.paper_profile("h6")
    want = R.solve_fin(ref_nw, ref_pf, R.AppRequirements(0.93, 0.5e-3),
                       gamma=5, backend="pallas")
    got = T.solve_fin(nw, profile_from(ref_pf), requirements_from(0.93, 0.5e-3),
                      gamma=5, backend="f32", device=CPU)
    assert same_config(want, got)
    assert want.energy == got.energy


@pytest.mark.parametrize("app", APPS)
def test_mcp_and_opt_match_reference(scenario, app):
    ref_nw, nw = scenario
    ref_pf = R.paper_profile(app)
    pf = profile_from(ref_pf)
    for alpha, delta in ((0.5, 5e-3), (0.8, 2e-3), (0.0, 12e-3)):
        ref_req = R.AppRequirements(alpha, delta)
        req = requirements_from(alpha, delta)
        assert_same(R.solve_mcp(ref_nw, ref_pf, ref_req),
                    T.solve_mcp(nw, pf, req, device=CPU))
        assert_same(R.solve_opt(ref_nw, ref_pf, ref_req),
                    T.solve_opt(nw, pf, req))


def test_fin_all_exit_costs_matches_banded_reference(scenario):
    ref_nw, nw = scenario
    for app in ("h2", "h5"):
        ref_pf = R.paper_profile(app)
        want = R.fin_all_exit_costs(ref_nw, ref_pf, R.AppRequirements(0.5, 5e-3),
                                    gamma=10, backend="banded")
        got = T.fin_all_exit_costs(nw, profile_from(ref_pf),
                                   requirements_from(0.5, 5e-3), gamma=10,
                                   backend="banded", device=CPU)
        assert got.tobytes() == want.tobytes()


def test_convert_carries_fields_across(scenario):
    ref_nw, nw = scenario
    assert nw.bandwidth.tobytes() == ref_nw.bandwidth.tobytes()
    assert [n.name for n in nw.nodes] == [n.name for n in ref_nw.nodes]
    for app in APPS:
        ref_pf = R.paper_profile(app)
        pf = profile_from(ref_pf)
        assert pf.cut_bits == ref_pf.cut_bits
        assert [e.phi for e in pf.exits] == [e.phi for e in ref_pf.exits]
        cfg = T.convert.config_from([0, 1, 1][:ref_pf.exits[1].block + 1], 1)
        rcfg = R.Config(placement=list(cfg.placement), final_exit=1)
        req = R.AppRequirements(0.0, 5e-3)
        want = R.evaluate_config(ref_nw, ref_pf, req, rcfg)
        got = T.evaluate_config(nw, pf, requirements_from(0.0, 5e-3), cfg)
        for f in EVAL_FIELDS:
            assert getattr(got, f) == getattr(want, f), (app, f)
    # the port's own scenario builders equal the carried-across ones
    own = T.paper_scenario(n_extra_edge=2)
    assert own.bandwidth.tobytes() == \
        ref_paper_scenario(n_extra_edge=2).bandwidth.tobytes()
    ps, ns, rs = T.sweep_scenarios(apps=("h4",), deltas_ms=(3.0,))
    rps, rns, rrs = ref_sweep(apps=("h4",), deltas_ms=(3.0,))
    assert ps[0].block_ops == rps[0].block_ops and rs[0] == \
        requirements_from(rrs[0].alpha, rrs[0].delta, rrs[0].sigma)


@pytest.mark.parametrize("backend", ["jnp", "pallas", "cuda"])
def test_reference_only_backend_names_raise(scenario, backend):
    """The reference's float32 jnp / pallas engines are the port's f32
    backend, and no backend is named after a device: these names raise."""
    _, nw = scenario
    pf = profile_from(R.paper_profile("h6"))
    with pytest.raises(ValueError, match="backend"):
        T.solve_fin(nw, pf, requirements_from(0.5, 5e-3), backend=backend,
                    device=CPU)
    with pytest.raises(ValueError, match="minplus"):
        T.solve_many(pf, nw, requirements_from(0.5, 5e-3), backend=backend,
                     device=CPU)


def test_n_best_outside_one_raises(scenario):
    """Only a slot count below one raises: n_best > 1 is the k-best DP
    (``test_torch_frontier.py``)."""
    _, nw = scenario
    pf = profile_from(R.paper_profile("h6"))
    req = requirements_from(0.5, 5e-3)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="n_best"):
            T.solve_fin(nw, pf, req, n_best=bad, device=CPU)
        with pytest.raises(ValueError, match="n_best"):
            T.solve_many(pf, nw, req, n_best=bad, device=CPU)
    assert T.solve_fin(nw, pf, req, n_best=2, device=CPU).found


def test_solve_many_broadcast_length_mismatch_raises(scenario):
    _, nw = scenario
    pf = profile_from(R.paper_profile("h6"))
    with pytest.raises(ValueError, match="requirements has length 2"):
        T.solve_many([pf] * 3, nw, [requirements_from(0.5, 5e-3)] * 2,
                     device=CPU)


def test_relax_chunk_env_surfaces_from_solver(monkeypatch, scenario):
    """An invalid chunk budget raises at the solver entry; a tiny valid
    budget splits the CPU relaxation into many chunks without changing a
    number."""
    _, nw = scenario
    pf = profile_from(R.paper_profile("h2"))
    reqs = [requirements_from(0.8, d) for d in (2e-3, 5e-3, 9e-3)]
    whole = T.solve_many(pf, nw, reqs, device=CPU)
    monkeypatch.setenv("REPRO_RELAX_CHUNK_BYTES", "1")
    for w, g in zip(whole, T.solve_many(pf, nw, reqs, device=CPU)):
        assert_same(w, g)
    monkeypatch.setenv("REPRO_RELAX_CHUNK_BYTES", "bogus")
    with pytest.raises(ValueError, match="REPRO_RELAX_CHUNK_BYTES"):
        T.solve_many([pf] * 3, nw, reqs[0], device=CPU)
