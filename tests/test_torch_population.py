"""The PyTorch port's ``Population`` vs the JAX package's, as twin cohorts.

Counterparts of ``tests/test_population.py``: the reference
``Population(fused_ingest="numpy")`` and the port's ``Population`` on the
CPU, with its ``device`` ingest (the fused-ingest kernel's plain version)
and with its ``numpy`` oracle, go through identical sequences -- ingests
(scalar, per-user and per-target; partial; deferred), ``ingest_factors``,
failures and recoveries, compute-slice and backhaul repricings, state-table
compaction, the tighten fallback, telemetry screening, frontiers, installed
incumbents, the pivot-majority gate and the streaming solve.  After every
step both must hold identical incumbent arrays, ``inc_found`` and
``PopulationStats`` counters (the ``t_*`` timings left out) and
byte-equal ``state_dict()``s, and return the same Solutions; a restore
must resume bit-identically.  The reference's jnp ingest is not run (it
raises on the installed jax).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.multiapp import PAPER_MULTIAPP_REQS
from repro.core.population import TelemetryPolicy as RefTelemetry
from repro.core.scenarios import paper_scenario as ref_paper_scenario

import repro_torch as T
from repro_torch.convert import (config_from, network_from, profile_from,
                                 requirements_from)
from repro_torch.core.population import TelemetryPolicy

from test_torch_fin import assert_same

CPU = "cpu"
INGESTS = ("device", "numpy")


def _req(r):
    return requirements_from(r.alpha, r.delta, r.sigma)


def _twin(ref_nw, ref_pf, ref_req, U, fused_ingest="device", **kw):
    """A reference cohort and the port's cohort (on the CPU) of the same
    scenario; ``telemetry`` is carried across as its own policy object."""
    ref_kw = dict(kw)
    if "telemetry" in kw:
        pol = kw["telemetry"]
        ref_kw["telemetry"] = RefTelemetry(pol.mode, pol.stuck_window)
    return (R.Population(ref_nw, ref_pf, ref_req, U, fused_ingest="numpy",
                         **ref_kw),
            T.Population(network_from(ref_nw), profile_from(ref_pf),
                         _req(ref_req), U, device=CPU,
                         fused_ingest=fused_ingest, **kw))


def _app_twin(app, U, fused_ingest="device", n_extra_edge=2, **kw):
    return _twin(ref_paper_scenario(n_extra_edge=n_extra_edge),
                 R.paper_profile(app), PAPER_MULTIAPP_REQS[app], U,
                 fused_ingest, **kw)


def _counters(p):
    return {k: v for k, v in dataclasses.asdict(p.stats).items()
            if not k.startswith("t_")}


def assert_twins(ref, got, ctx=""):
    """Identical incumbents and counters, byte-equal state_dicts."""
    assert np.array_equal(ref.inc_found, got.inc_found), ctx
    for f in ("_inc_place", "_inc_exit", "_inc_energy", "_solved",
              "_user_state"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (ctx, f)
    assert _counters(got) == _counters(ref), ctx
    assert got.n_states == ref.n_states, ctx
    a, b = ref.state_dict(), got.state_dict()
    assert sorted(a) == sorted(b), ctx
    for k in a:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), (ctx, k)
        assert a[k].tobytes() == b[k].tobytes(), (ctx, k)


def assert_solutions(ra, rb, ctx=""):
    assert len(ra) == len(rb), ctx
    for u, (a, b) in enumerate(zip(ra, rb)):
        assert_same(a, b)


def _both(pair, fn):
    """``fn`` on both cohorts; the two results."""
    return fn(pair[0]), fn(pair[1])


def _same_arrays(xs, ys, ctx=""):
    for x, y in zip(xs, ys):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), ctx


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_ingest", INGESTS)
@pytest.mark.parametrize("app", ["h1", "h4", "h6"])
def test_channel_ticks_match_reference(app, fused_ingest):
    """Per-user scalar ticks: the same change flags, Solutions, gate output
    and state each tick."""
    pair = _app_twin(app, 12, fused_ingest)
    assert_solutions(*_both(pair, lambda p: p.solve()))
    assert_twins(*pair, "cold")
    rng = np.random.default_rng(7)
    for t in range(6):
        q = rng.uniform(0.3, 1.0, 12) * 1e9
        ch = _both(pair, lambda p: p.ingest(q))
        assert ch[0].tobytes() == ch[1].tobytes(), t
        _same_arrays(*_both(pair, lambda p: p.evaluate_incumbents()), t)
        assert_solutions(*_both(pair, lambda p: p.solve()), t)
        assert_twins(*pair, (app, t))


@pytest.mark.parametrize("fused_ingest", INGESTS)
def test_ingest_forms_partial_and_deferred(fused_ingest):
    """A scalar, per-target rows, a partial user set, ``requant=False``
    followed by a solve of a subset, and ``ingest_factors`` eager and
    deferred (the lazy bandwidth store)."""
    pair = _app_twin("h1", 10, fused_ingest)
    N = pair[0].N
    rng = np.random.default_rng(3)
    steps = [
        lambda p: p.ingest(0.7e9),
        lambda p: p.ingest(rng_vec),
        lambda p: p.ingest(rng_q[:4] * 1e9, users=np.array([1, 3, 5, 7])),
        lambda p: p.ingest(rng_vec[:3], users=np.array([0, 2, 9])),
        lambda p: p.ingest(rng_q * 1e9, requant=False),
        lambda p: p.ingest_factors(rng_q, fac),
        lambda p: p.ingest_factors(rng_q[::-1].copy(), fac, requant=False),
    ]
    fac = rng.uniform(0.2, 1.0, (10, N)) * 1e9
    for t, step in enumerate(steps):
        rng_q = rng.uniform(0.3, 1.0, 10)
        rng_vec = rng.uniform(0.2, 1.0, (10, N)) * 1e9
        ch = _both(pair, step)
        if ch[0] is None:
            assert ch[1] is None
            users = np.array([0, 4, 8])
            assert_solutions(*_both(pair, lambda p: p.solve(users)), t)
            _same_arrays(*_both(pair, lambda p: p.evaluate_incumbents()), t)
        else:
            assert ch[0].tobytes() == ch[1].tobytes(), t
        assert_solutions(*_both(pair, lambda p: p.solve()), t)
        assert_twins(*pair, t)


def test_ingest_shape_validation():
    _, got = _app_twin("h1", 4)
    N = got.N
    with pytest.raises(ValueError, match="leading dimension"):
        got.ingest(np.ones(3) * 1e9)
    with pytest.raises(ValueError, match=r"\(4, \d+\)"):
        got.ingest(np.ones((4, N + 1)) * 1e9)
    with pytest.raises(ValueError, match="ndim"):
        got.ingest(np.ones((4, N, 2)))
    with pytest.raises(ValueError, match="ingest_factors"):
        got.ingest_factors(np.ones(3), np.ones((4, N)))


# ---------------------------------------------------------------------------
# failures and repricings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_ingest", INGESTS)
def test_masks_slices_and_backhaul(fused_ingest):
    """Cohort-wide and per-user failures and recoveries, scalar and
    per-node slices, scalar and per-link backhaul repricings."""
    pair = _app_twin("h2", 8, fused_ingest)
    N = pair[0].N
    rng = np.random.default_rng(9)
    sc = rng.uniform(0.5, 1.5, (N, N))
    steps = [
        lambda p: p.mask_node(4),
        lambda p: p.mask_node(2, users=[1, 5]),
        lambda p: p.unmask_node(4),
        lambda p: p.update_slice(0.5),
        lambda p: p.update_slice(np.array([1.0, 0.6, 0.8, 1.0, 0.7])),
        lambda p: p.update_backhaul(0.9),
        lambda p: p.update_backhaul(sc),
        lambda p: p.unmask_node(2, users=[5]),
        lambda p: p.update_slice(1.0),
    ]
    for t, step in enumerate(steps):
        q = rng.uniform(0.3, 1.0, 8) * 1e9
        _both(pair, lambda p: p.ingest(q))
        _both(pair, step)
        assert _both(pair, lambda p: p.masked_nodes)[0] == \
            pair[1].masked_nodes
        assert_solutions(*_both(pair, lambda p: p.solve()), t)
        assert_twins(*pair, t)
    with pytest.raises(ValueError, match="source"):
        pair[1].mask_node(pair[1].src)


def test_state_table_compaction():
    pair = _app_twin("h1", 8, max_states=4)
    N = pair[0].N
    rng = np.random.default_rng(1)
    for t in range(8):
        vec = rng.uniform(0.2, 1.0, (8, N)) * 1e9
        _both(pair, lambda p: p.ingest(vec))
        assert_solutions(*_both(pair, lambda p: p.solve()), t)
        assert_twins(*pair, t)
    assert pair[1].stats.state_evictions > 0


def _seeded_twin(seed, gamma, quantize="floor", U=16, **kw):
    """The random scenario of ``tests/test_population.py`` for ``seed``."""
    rng = np.random.default_rng(seed)
    n_blocks = int(rng.integers(2, 6))
    prof = R.synthetic_profile(n_blocks,
                               min(n_blocks, int(rng.integers(1, 4))),
                               seed=seed)
    nw = ref_paper_scenario(n_extra_edge=int(rng.integers(0, 3)))
    alpha = float(rng.uniform(0.0, max(e.accuracy for e in prof.exits)))
    req = R.AppRequirements(alpha=alpha,
                            delta=float(rng.uniform(1e-3, 20e-3)))
    return rng, _twin(nw, prof, req, U, gamma=gamma, quantize=quantize,
                      **kw)


@pytest.mark.parametrize("vector_postpass", [True, False])
@pytest.mark.parametrize("seed", [4, 40, 89])
def test_tighten_fallback_matches_reference(seed, vector_postpass):
    """Scenarios whose round-0 scan finds no feasible path for some users:
    the batched tighten loop (B2 at each round's ``delta_eff``, cached
    tighten cells) and the per-user Plan fallback of the scalar path."""
    rng, pair = _seeded_twin(seed, 3, vector_postpass=vector_postpass)
    for t in range(3):
        q = rng.uniform(0.1, 1.2, 16) * 1e9
        _both(pair, lambda p: p.ingest(q))
        assert_solutions(*_both(pair, lambda p: p.solve()), t)
        assert_twins(*pair, t)
    assert pair[1].stats.fallbacks > 0
    rounds = {s.meta.get("tighten_rounds") for s in pair[1].solutions()}
    assert rounds - {0}


# ---------------------------------------------------------------------------
# telemetry screening
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,stuck", [("clamp", 0), ("quarantine", 0),
                                        ("quarantine", 2)])
def test_telemetry_policies_match_reference(mode, stuck):
    pair = _app_twin("h1", 8, telemetry=TelemetryPolicy(mode, stuck))
    N = pair[0].N
    rng = np.random.default_rng(13)
    frozen = rng.uniform(0.2, 1.0, N) * 1e9
    for t in range(7):
        vec = rng.uniform(0.2, 1.0, (8, N)) * 1e9
        vec[t % 8, (t % (N - 1)) + 1] = [np.nan, -1e9, np.inf][t % 3]
        vec[7] = frozen                      # a stuck sensor
        _both(pair, lambda p: p.ingest(vec))
        _same_arrays(*_both(pair, lambda p: p._quarantined), t)
        assert_solutions(*_both(pair, lambda p: p.solve()), t)
        assert_twins(*pair, t)
    c = pair[1].stats
    assert c.telemetry_bad > 0
    assert (c.telemetry_clamped > 0) == (mode == "clamp")
    assert (c.quarantines > 0) == (mode == "quarantine")


def test_telemetry_raise_names_the_users():
    pair = _app_twin("h1", 4)
    vec = np.full((4, pair[0].N), 0.5e9)
    vec[2, 1] = np.nan
    for p in pair:
        with pytest.raises(ValueError, match=r"\[2\]"):
            p.ingest(vec)
    _same_arrays(*_both(pair, lambda p: p.state_dict()["bw_vec"]))


# ---------------------------------------------------------------------------
# incumbents, frontiers and the gate
# ---------------------------------------------------------------------------

def test_frontiers_and_installed_incumbents():
    pair = _app_twin("h1", 10)
    rng = np.random.default_rng(21)
    q = rng.uniform(0.3, 1.0, 10) * 1e9
    _both(pair, lambda p: p.ingest(q))
    _both(pair, lambda p: p.solve())
    users = np.array([0, 3, 4, 9])
    fa, fb = _both(pair, lambda p: p.frontiers(users, k_per_exit=3))
    for a, b in zip(fa, fb):
        assert len(a.rows) == len(b.rows) and len(a.rows) > 0
        for ra, rb in zip(a.rows, b.rows):
            assert ra.config.placement == rb.config.placement
            assert ra.config.final_exit == rb.config.final_exit
            assert (ra.energy, ra.latency) == (rb.energy, rb.latency)
        assert (a.argmin.config.placement, a.argmin.energy) == \
            (b.argmin.config.placement, b.argmin.energy)
    one = _both(pair, lambda p: p.frontier(2, k_per_exit=None))
    assert len(one[0].rows) == len(one[1].rows)
    # install frontier rows (and a None) as incumbents, then gate
    rows = [fa[0].rows[-1], fa[1].rows[0], None]
    cfgs_ref = [r.config if r else None for r in rows]
    cfgs_got = [config_from(c.placement, c.final_exit) if c else None
                for c in cfgs_ref]
    energies = [r.energy if r else np.inf for r in rows]
    pair[0].set_incumbents(users[:3], cfgs_ref, energies)
    pair[1].set_incumbents(users[:3], cfgs_got, energies)
    assert pair[1]._inc_single is None
    _same_arrays(*_both(pair, lambda p: p.evaluate_incumbents()))
    _same_arrays(*_both(pair, lambda p: p.evaluate_incumbents(users)))
    assert_twins(*pair)


def test_pivot_majority_gate_at_scale():
    """U >= 4096 takes the gate's pivot-majority path: a modal incumbent
    evaluated once over the store, the minority through the grouped path;
    with failures, with a uniform cohort and with mixed incumbents."""
    U = 4096
    pair = _app_twin("h1", U)
    rng = np.random.default_rng(5)
    q = rng.uniform(0.3, 1.0, U)
    _both(pair, lambda p: p.attach_many(1e9 * q))
    assert_twins(*pair, "attach")
    for t in range(3):
        q = np.clip(0.65 + 0.95 * (q - 0.65) + rng.normal(0, 0.05, U),
                    0.3, 1.0)
        ch = _both(pair, lambda p: p.ingest(1e9 * q))
        ev = _both(pair, lambda p: p.evaluate_incumbents())
        _same_arrays(ev[0], ev[1], t)
        users = np.nonzero(ch[0] | ~ev[0][1])[0]
        _both(pair, lambda p: p.solve(users, build_solutions=False))
        if t == 1:
            _both(pair, lambda p: p.mask_node(3, users=np.arange(0, U, 64)))
        assert_twins(*pair, t)
    _same_arrays(*_both(pair, lambda p: p.evaluate_incumbents()), "masked")
    # a uniform cohort: the uniform-incumbent fast path
    _both(pair, lambda p: p.ingest(0.8e9))
    _both(pair, lambda p: p.unmask_node(3))
    _both(pair, lambda p: p.solve(build_solutions=False))
    assert pair[1]._inc_single is not None
    _same_arrays(*_both(pair, lambda p: p.evaluate_incumbents()), "uniform")
    assert_twins(*pair, "uniform")


def test_streaming_solve_equals_reference():
    """``solve_begin(stream=True)`` relaxes on the 1-thread executor while a
    deferred ingest of the next tick lands; ``solve_finish`` gives the
    reference's synchronous solve."""
    ref, got = _app_twin("h6", 16)
    rng = np.random.default_rng(2)
    for t in range(4):
        q = rng.uniform(0.3, 1.0, 16) * 1e9
        ref.ingest(q)
        got.ingest(q)
        pend = got.solve_begin(stream=True)
        want = ref.solve()
        assert_solutions(want, got.solve_finish(pend), t)
        assert_twins(ref, got, t)
    assert got._relax_executor is not None
    got._relax_executor.shutdown()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_ingest", INGESTS)
def test_state_dict_restore_resumes_bit_identically(fused_ingest):
    """A snapshot taken after mixed deltas restores into fresh cohorts
    (the repricings re-applied first) of both implementations, which then
    run on identically to the uninterrupted twins."""
    pair = _app_twin("h1", 12, fused_ingest)
    rng = np.random.default_rng(17)
    for t in range(3):
        q = rng.uniform(0.3, 1.0, 12) * 1e9
        _both(pair, lambda p: p.ingest(q))
        if t == 1:
            _both(pair, lambda p: p.mask_node(2, users=[0, 1, 2]))
        _both(pair, lambda p: p.solve())
    _both(pair, lambda p: p.update_backhaul(0.9))
    snaps = _both(pair, lambda p: p.state_dict())
    fresh = _app_twin("h1", 12, fused_ingest)
    _both(fresh, lambda p: p.update_backhaul(0.9))
    fresh[0].restore_state(snaps[0])
    fresh[1].restore_state(snaps[1])
    assert_twins(*fresh, "restored")
    for t in range(3):
        q = rng.uniform(0.3, 1.0, 12) * 1e9
        for pr in (pair, fresh):
            _both(pr, lambda p: p.ingest(q))
            assert_solutions(*_both(pr, lambda p: p.solve()), t)
        assert_twins(*fresh, t)
        _same_arrays([pair[1].state_dict()[k] for k in sorted(snaps[1])],
                     [fresh[1].state_dict()[k] for k in sorted(snaps[1])], t)
    bad = dict(snaps[1], user_ids=np.arange(12) + 1)
    with pytest.raises(ValueError, match="user_ids"):
        fresh[1].restore_state(bad)


# ---------------------------------------------------------------------------
# quantizers, gammas and apps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["h1", "h4", "h6"])
@pytest.mark.parametrize("gamma", [3, 10])
@pytest.mark.parametrize("quantize", ["floor", "ceil", "round"])
def test_quantizers_gammas_and_apps(quantize, gamma, app):
    U = 64
    pair = _app_twin(app, U, gamma=gamma, quantize=quantize)
    N = pair[0].N
    rng = np.random.default_rng(gamma)
    steps = [lambda p: p.ingest(q),
             lambda p: p.ingest(vec),
             lambda p: p.mask_node(3, users=np.arange(0, U, 3)),
             lambda p: p.update_slice(0.7),
             lambda p: p.unmask_node(3)]
    for t, step in enumerate(steps):
        q = rng.uniform(0.1, 1.2, U) * 1e9
        vec = rng.uniform(0.1, 1.2, (U, N)) * 1e9
        _both(pair, lambda p: p.ingest(q))
        _both(pair, step)
        assert_solutions(*_both(pair, lambda p: p.solve()), t)
    assert_twins(*pair)


# ---------------------------------------------------------------------------
# engines and construction
# ---------------------------------------------------------------------------

def test_f32_population_agrees_with_minplus():
    nw = T.paper_scenario(n_extra_edge=2)
    pf = T.paper_profile("h2")
    req = _req(PAPER_MULTIAPP_REQS["h2"])
    ref = T.Population(nw, pf, req, 4, device=CPU)
    f32 = T.Population(nw, pf, req, 4, backend="f32", device=CPU)
    rng = np.random.default_rng(11)
    for t in range(3):
        q = rng.uniform(0.3, 1.0, 4) * 1e9
        ref.ingest(q)
        f32.ingest(q)
        for a, b in zip(ref.solve(), f32.solve()):
            assert a.found == b.found, t
            if a.found:
                assert a.config.placement == b.config.placement, t
                assert a.config.final_exit == b.config.final_exit, t
                assert a.energy == b.energy, t


@pytest.mark.parametrize("gamma", [10, 25])
@pytest.mark.parametrize("app", ["h1", "h2", "h3", "h4", "h5", "h6"])
def test_f32_population_agrees_with_reference(app, gamma):
    """The port's float32 cohort (``backend="f32"``, on the CPU) against the
    reference's float32 cohort (``backend="jnp"``, numpy ingest): 24 users
    through 4 ticks of rates on [0.2, 2] Gb/s give the same change flags,
    Solutions (found, placement, final exit, energy) and counters."""
    nw = ref_paper_scenario(n_extra_edge=2)
    pf = R.paper_profile(app)
    req = PAPER_MULTIAPP_REQS[app]
    ref = R.Population(nw, pf, req, 24, gamma=gamma, backend="jnp",
                       fused_ingest="numpy")
    f32 = T.Population(network_from(nw), profile_from(pf), _req(req), 24,
                       gamma=gamma, backend="f32", device=CPU)
    rng = np.random.default_rng(gamma)
    for t in range(4):
        q = rng.uniform(0.2, 2.0, 24) * 1e9
        ch = ref.ingest(q), f32.ingest(q)
        assert ch[0].tobytes() == ch[1].tobytes(), t
        for a, b in zip(ref.solve(), f32.solve()):
            assert a.found == b.found, t
            if a.found:
                assert a.config.placement == b.config.placement, t
                assert a.config.final_exit == b.config.final_exit, t
                assert a.energy == b.energy, t
        assert _counters(f32) == _counters(ref), t
    assert np.array_equal(ref.inc_found, f32.inc_found)


def test_constructor_validation():
    nw = T.paper_scenario(n_extra_edge=2)
    pf = T.paper_profile("h1")
    req = _req(PAPER_MULTIAPP_REQS["h1"])
    with pytest.raises(ValueError, match="backend"):
        T.Population(nw, pf, req, 2, backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="dense"):
        T.Population(nw, pf, req, 2, backend="dense", device=CPU)
    with pytest.raises(ValueError, match="f32"):
        T.Population(nw, pf, req, 2, backend="jnp", device=CPU)
    with pytest.raises(ValueError, match="n_users"):
        T.Population(nw, pf, req, 0, device=CPU)
    with pytest.raises(ValueError, match="int16"):
        T.Population(nw, pf, req, 2, gamma=40000, device=CPU)
    with pytest.raises(ValueError, match="device"):
        T.Population(nw, pf, req, 2, fused_ingest="jnp", device=CPU)
    with pytest.raises(ValueError, match="fused_ingest"):
        T.Population(nw, pf, req, 2, fused_ingest="xla", device=CPU)
    for name in ("Mesh", "mesh-f32", "meshes"):
        with pytest.raises(ValueError, match="backend"):
            T.Population(nw, pf, req, 2, backend=name, device=CPU)
    mesh = T.Population(nw, pf, req, 2, backend="mesh", device=CPU)
    assert (mesh.backend, mesh._plan_backend, mesh._engine) == \
        ("mesh", "f32", "f32")
    assert mesh._mesh_relaxer is None          # built at the first relax
    pop = T.Population(nw, pf, req, 3, device=CPU)
    assert pop.device == torch.device("cpu") and pop.n_users == 3
    assert pop.n_states == 1 and pop.depth_window_lo is None
    assert (pop.h2d_bytes, pop.d2h_bytes) == (0, 0)


def test_identical_users_share_one_state_and_solve():
    pair = _app_twin("h1", 64)
    _both(pair, lambda p: p.solve())
    assert pair[1].n_states == 1
    assert pair[1].stats.dp_relaxes == 1
    assert pair[1].stats.unique_solves == 1
    _both(pair, lambda p: p.ingest(np.full(64, 0.999e9)))
    _both(pair, lambda p: p.solve())
    assert_twins(*pair)
