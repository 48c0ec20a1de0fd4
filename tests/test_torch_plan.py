"""The plan IR of the PyTorch port vs the JAX package's ``Plan``.

Counterparts of ``tests/test_plan.py``: the same delta sequences go to a
reference ``Plan`` and to the port's ``Plan`` (on the CPU), and after every
delta both must return the same Solution (configuration, every
``ConfigEval`` field, ``meta`` apart from timings) and the same
``PlanStats``.  The incrementally maintained tensors must equal a fresh
build, ``update_uplinks`` must equal per-plan updates, ``solve_plans`` must
equal ``solve_fin``, and the validation errors must fire.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.multiapp import PAPER_MULTIAPP_REQS
from repro.core.scenarios import paper_scenario as ref_paper_scenario

import repro_torch as T
from repro_torch.convert import (config_from, network_from, profile_from,
                                 requirements_from)

from test_torch_fin import assert_same, same_config

APPS = ("h1", "h2", "h3", "h4", "h5", "h6")
CPU = "cpu"
EXT_FIELDS = ("C", "T", "E", "TT", "mask", "init_T", "init_E", "init_mask")


def _req(r):
    return requirements_from(r.alpha, r.delta, r.sigma)


def _pair(ref_nw, ref_pf, ref_req, **kw):
    """A reference plan and the port's plan of the same scenario; the port's
    ``f32`` backend is paired with the reference's ``jnp``."""
    ref_kw = dict(kw)
    if kw.get("backend") == "f32":
        ref_kw["backend"] = "jnp"
    return (R.Plan(ref_nw, ref_pf, ref_req, **ref_kw),
            T.Plan(network_from(ref_nw), profile_from(ref_pf), _req(ref_req),
                   device=CPU, **kw))


def _assert_twins(ref, got, msg=""):
    """Same solution, the same counters and the same versions."""
    assert_same(ref.solve(), got.solve())
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(ref.stats), msg
    assert (got.version, got.env_version) == (ref.version, ref.env_version)


@pytest.fixture(scope="module")
def ref_network():
    return ref_paper_scenario(n_extra_edge=2)


# ---------------------------------------------------------------------------
# delta sequences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_best", [1, 4])
@pytest.mark.parametrize("app", APPS)
def test_uplink_deltas_match_reference(ref_network, app, n_best):
    """AR(1) fades + hard jumps: identical solutions and stats each step,
    and the warm solve equals a cold port solve."""
    ref, got = _pair(ref_network, R.paper_profile(app),
                     PAPER_MULTIAPP_REQS[app], n_best=n_best)
    _assert_twins(ref, got)
    rng = np.random.default_rng(7)
    q = 0.6
    for t in range(12):
        if t % 5 == 2:
            q = float(rng.uniform(0.3, 1.0))
        else:
            q = float(np.clip(0.65 + 0.95 * (q - 0.65)
                              + rng.normal(0, 0.04), 0.3, 1.0))
        ref.update_uplink(q * 1e9)
        got.update_uplink(q * 1e9)
        _assert_twins(ref, got, (app, t))
        cold = T.solve_fin(got.network, got.profile, got.req,
                           gamma=got.gamma, n_best=n_best, device=CPU)
        assert_same(got.solution, cold, meta=False)


def _random_delta_run(seed: int, quantize: str, gamma: int,
                      n_best: int = 1) -> None:
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(2, 6))
    ref_pf = R.synthetic_profile(n_blocks,
                                 min(n_blocks, int(rng.integers(1, 4))),
                                 seed=seed)
    ref_nw = ref_paper_scenario(n_extra_edge=int(rng.integers(0, 3)))
    N = ref_nw.n_nodes
    alpha = float(rng.uniform(0.0, max(e.accuracy for e in ref_pf.exits)))
    ref_req = R.AppRequirements(alpha=alpha,
                                delta=float(rng.uniform(1e-3, 20e-3)))
    ref, got = _pair(ref_nw, ref_pf, ref_req, gamma=gamma,
                     quantize=quantize, n_best=n_best,
                     lam=None if seed % 2 else max(1, gamma - 2))
    for t in range(8):
        r = rng.random()
        if r < 0.4:
            q = float(rng.uniform(0.1, 1.2)) * 1e9
            for p in (ref, got):
                p.update_uplink(q)
        elif r < 0.5:
            vec = rng.uniform(0.1, 1.2, N) * 1e9
            for p in (ref, got):
                p.update_uplink(vec)
        elif r < 0.65:
            frac = float(rng.uniform(0.3, 1.0))
            nodes = None if rng.random() < 0.5 else [int(rng.integers(N))]
            for p in (ref, got):
                p.update_slice(frac, nodes)
        elif r < 0.8:
            sc = rng.uniform(0.5, 1.5, (N, N))
            for p in (ref, got):
                p.update_backhaul(sc)
        else:
            n = int(rng.integers(1, N))
            for p in (ref, got):
                if p.masked_nodes:
                    p.unmask_node(p.masked_nodes[0])
                else:
                    p.mask_node(n)
        _assert_twins(ref, got, (seed, t))


@pytest.mark.parametrize("quantize", ["floor", "ceil", "round"])
@pytest.mark.parametrize("gamma", [3, 10, 25])
def test_random_delta_sequences_match_reference(quantize, gamma):
    """Mixed uplink / per-target / slice / backhaul / mask deltas, with and
    without a lambda window: solutions and PlanStats after every delta."""
    for seed in range(3):
        _random_delta_run(1000 * gamma + seed, quantize, gamma)


@pytest.mark.parametrize("gamma", [3, 10])
def test_random_delta_sequences_kbest_match_reference(gamma):
    for seed in range(3):
        _random_delta_run(2000 * gamma + seed, "floor", gamma, n_best=4)


def test_mixed_deltas_drive_bounded_resume_and_cache(ref_network):
    """Backhaul / slice deltas that move only later layers resume the chain
    (bounded re-relax); in-cell fades reuse the cached grids."""
    ref, got = _pair(ref_network, R.paper_profile("h1"),
                     PAPER_MULTIAPP_REQS["h1"], gamma=25)
    _assert_twins(ref, got)
    N = ref_network.n_nodes
    for t in range(30):
        kind = t % 3
        for p in (ref, got):
            if kind == 0:
                p.update_backhaul(np.random.default_rng(t).uniform(
                    0.6, 1.4, (N, N)))
            elif kind == 1:
                p.update_slice(float(np.random.default_rng(t).uniform(
                    0.5, 1.0)), [int(t % (N - 1)) + 1])
            else:
                p.update_uplink(p.network.bandwidth[0, 1] * (1 + 1e-12))
        _assert_twins(ref, got, t)
    assert got.stats.bounded_relaxes > 0 and got.stats.dp_cache_hits > 0


def test_masked_solve_avoids_the_failed_node(ref_network):
    ref, got = _pair(ref_network, R.paper_profile("h1"),
                     PAPER_MULTIAPP_REQS["h1"])
    for p in (ref, got):
        p.update_uplink(0.3e9)
    for victim in (1, 4):
        for p in (ref, got):
            p.mask_node(victim)
        _assert_twins(ref, got, victim)
        sol = got.solution
        if sol.found:
            assert victim not in sol.config.placement
        assert got.masked_nodes == ref.masked_nodes == [victim]
        cfg = config_from([0, victim, victim], 1)
        assert not got.evaluate(cfg).feasible
        for p in (ref, got):
            p.unmask_node(victim)
    _assert_twins(ref, got, "after recovery")


# ---------------------------------------------------------------------------
# tensor-level equivalence
# ---------------------------------------------------------------------------

def test_ext_tensors_equal_fresh_build_after_deltas(ref_network):
    ref, got = _pair(ref_network, R.paper_profile("h2"),
                     PAPER_MULTIAPP_REQS["h2"])
    rng = np.random.default_rng(0)
    for _ in range(10):
        q = float(rng.uniform(0.3, 1.0)) * 1e9
        ref.update_uplink(q)
        got.update_uplink(q)
    for p in (ref, got):
        p.update_slice(0.7)
        p.update_uplink(0.45e9)
        p.update_backhaul(0.8)
    fresh = T.build_extended_graph(got.network, got.profile, got.req,
                                   device=CPU)
    for f in EXT_FIELDS:
        assert torch.equal(getattr(got.ext, f), getattr(fresh, f)), f
        np.testing.assert_array_equal(getattr(got.ext, f).numpy(),
                                      getattr(ref.ext, f))


@pytest.mark.parametrize("quantize", ["floor", "ceil", "round"])
def test_quant_tensors_equal_fresh_build(ref_network, quantize):
    """The maintained steep / init tensors equal a fresh stage-2 build (and
    the reference's) for every quantizer mode, after uplink, slice and
    backhaul deltas: the bit-exact requantizers on the device."""
    ref, got = _pair(ref_network, R.paper_profile("h1"),
                     PAPER_MULTIAPP_REQS["h1"], quantize=quantize)
    rng = np.random.default_rng(2)
    for t in range(8):
        q = float(rng.uniform(0.3, 1.0)) * 1e9
        for p in (ref, got):
            p.update_uplink(q)
            if t == 3:
                p.update_slice(0.6, [2])
            if t == 5:
                p.update_backhaul(1.7)
    for mi, mode in enumerate(got._modes):
        fg = T.build_feasible_graph(got.ext, got.gamma, quantize=mode)
        assert torch.equal(got._steep[mi], fg.steep)
        assert torch.equal(got._init_depth[mi], fg.init_depth)
        assert torch.equal(got._grid[mi], fg.init_grid())
        assert got._steep[mi].numpy().tobytes() == ref._steep[mi].tobytes()
        assert got._grid[mi].numpy().tobytes() == ref._grid[mi].tobytes()


# ---------------------------------------------------------------------------
# population forms
# ---------------------------------------------------------------------------

def _population(ref_nw, users=1, **kw):
    refs, gots = [], []
    for app in APPS:
        for _ in range(users):
            a, b = _pair(ref_nw, R.paper_profile(app),
                         PAPER_MULTIAPP_REQS[app], **kw)
            refs.append(a)
            gots.append(b)
    return refs, gots


def test_update_uplinks_equals_per_plan_updates(ref_network):
    _, batch = _population(ref_network)
    _, single = _population(ref_network)
    rng = np.random.default_rng(9)
    for t in range(6):
        qs = rng.uniform(0.3, 1.0, len(APPS)) * 1e9
        if t == 4:
            qs = rng.uniform(0.3, 1.0, (len(APPS), ref_network.n_nodes)) * 1e9
        before = [p._quant_version for p in batch]
        changed = T.update_uplinks(batch, qs)
        for p, q in zip(single, qs):
            p.update_uplink(q)
        for pa, pb, ch, v0 in zip(batch, single, changed, before):
            for name in ("_steep", "_init_depth", "_grid"):
                assert torch.equal(getattr(pa, name), getattr(pb, name))
            np.testing.assert_array_equal(pa.network.bandwidth,
                                          pb.network.bandwidth)
            assert pa._quant_version == pb._quant_version
            assert ch == (pa._quant_version != v0)


def test_update_uplinks_and_solve_plans_match_reference(ref_network):
    """The batched forms against the reference's batched forms: changed
    flags, solutions and stats per tick; and solve_plans == solve_fin."""
    refs, gots = _population(ref_network, users=2, gamma=25)
    rng = np.random.default_rng(4)
    for t in range(4):
        qs = rng.uniform(0.3, 1.0, len(refs)) * 1e9
        assert T.update_uplinks(gots, qs) == R.update_uplinks(refs, qs)
        if t == 2:
            for p in (refs[1], gots[1]):
                p.mask_node(4)
        for a, b in zip(R.solve_plans(refs), T.solve_plans(gots)):
            assert_same(a, b)
        for a, b in zip(refs, gots):
            assert dataclasses.asdict(b.stats) == dataclasses.asdict(a.stats)
            assert b.solution is not None
    for p, s in zip(gots, T.solve_plans(gots)):
        if not p.masked_nodes:
            assert_same(s, T.solve_fin(p.network, p.profile, p.req, gamma=25,
                                       device=CPU), meta=False)


def test_solve_plans_heterogeneous_population():
    """Mixed n_blocks / n_nodes / gamma / quantizer / n_best groups in ONE
    solve_plans call equal per-plan solves and the reference."""
    small, big = ref_paper_scenario(), ref_paper_scenario(n_extra_edge=3)
    specs = []
    for app in APPS:
        prof, req = R.paper_profile(app), PAPER_MULTIAPP_REQS[app]
        specs += [(small, prof, req, {}), (big, prof, req, {}),
                  (big, prof, req, dict(quantize="ceil")),
                  (small, prof, req, dict(gamma=25, n_best=2)),
                  (big, prof, req, dict(backend="f32"))]
    pairs = [_pair(nw, pf, rq, **kw) for nw, pf, rq, kw in specs]
    twins = [_pair(nw, pf, rq, **kw)[1] for nw, pf, rq, kw in specs]
    rng = np.random.default_rng(17)
    for t in range(2):
        qs = rng.uniform(0.3, 1.0, len(pairs)) * 1e9
        R.update_uplinks([a for a, _ in pairs], qs)
        T.update_uplinks([b for _, b in pairs], qs)
        want = R.solve_plans([a for a, _ in pairs])
        got = T.solve_plans([b for _, b in pairs])
        for p, q in zip(twins, qs):
            p.update_uplink(q)
        for (a, b), w, g, tw in zip(pairs, want, got, twins):
            if b.backend == "minplus":
                assert_same(w, g)
            else:
                assert same_config(w, g)
            assert_same(g, tw.solve(), meta=False)


# ---------------------------------------------------------------------------
# validation and migration accounting
# ---------------------------------------------------------------------------

def test_validation_errors(ref_network):
    nw = network_from(ref_network)
    pf = T.paper_profile("h2")
    req = T.AppRequirements(0.55, 5e-3)
    plan = T.Plan(nw, pf, req, device=CPU)
    with pytest.raises(ValueError, match="source"):
        plan.mask_node(nw.source_node)
    for bad in (-1, nw.n_nodes, 1.0):
        with pytest.raises(ValueError, match="node index"):
            plan.mask_node(bad)
    with pytest.raises(ValueError, match="backend"):
        T.Plan(nw, pf, req, backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="lam"):
        T.Plan(nw, pf, req, gamma=5, lam=9, device=CPU)
    with pytest.raises(ValueError, match="backhaul"):
        plan.update_backhaul(0.0)
    with pytest.raises(ValueError, match="population size"):
        T.update_uplinks([plan, plan], np.ones(3))
    with pytest.raises(ValueError, match="node count"):
        T.update_uplinks([plan], np.ones((1, nw.n_nodes + 1)))
    with pytest.raises(ValueError, match="NaN/Inf/negative"):
        T.update_uplinks([plan], np.array([np.nan]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.Plan(nw, pf, req)


def test_migration_delta_matches_reference():
    ref_pf = R.paper_profile("h2")
    pf = profile_from(ref_pf)
    cases = [([0, 0, 1, 1, 2], 2, [0, 1, 1, 1, 2], 2),
             ([0, 0, 1, 1, 2], 2, [0, 0, 1, 1, 2], 2),
             ([0, 0, 1, 1, 2], 2, [0], 0)]
    for pa, ka, pb, kb in cases:
        want = R.migration_delta(ref_pf, R.Config(pa, ka), R.Config(pb, kb))
        got = T.migration_delta(pf, config_from(pa, ka), config_from(pb, kb))
        assert got == want
    assert T.migration_delta(pf, None, config_from([0], 0)) == (0, 0.0)
    moved, bits = T.migration_delta(pf, config_from([0, 0, 1, 1, 2], 2),
                                    config_from([0, 1, 1, 1, 2], 2))
    assert moved == 1 and bits == pf.cut_bits[1]


def test_adopt_and_install_solution(ref_network):
    ref, got = _pair(ref_network, R.paper_profile("h3"),
                     PAPER_MULTIAPP_REQS["h3"], n_best=4)
    for p in (ref, got):
        p.update_uplink(0.5e9)
    fr_r, fr_t = ref.frontier(), got.frontier()
    last_r, last_t = fr_r.rows[-1], fr_t.rows[-1]
    a = ref.adopt(last_r.config)
    b = got.adopt(last_t.config)
    assert b.eval == T.evaluate_config(got.network, got.profile, got.req,
                                       last_t.config)
    assert (a.eval.energy, a.meta["policy"]) == (b.eval.energy,
                                                 b.meta["policy"])
    # the adopted incumbent survives a frontier refresh at the same version
    got.frontier()
    assert got.solution.meta.get("policy") == "frontier"
    sol = got._argmin_solution
    relaxes = got.stats.dp_relaxes
    got.install_solution(sol, got._dp_cache[1])
    assert got.solution.meta["contingency"]
    got.solve()
    assert got.stats.dp_relaxes == relaxes
