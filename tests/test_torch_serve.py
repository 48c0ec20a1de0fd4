"""The port's split-serving engine and contingency library vs the JAX
package's.

Twin engines -- the reference ``SplitServeEngine`` and the port's, on the
CPU -- serve the same requests with the same weights (the reference's
``init_model`` through ``convert.transformer_params_from``), the same exit
thresholds and the same FIN placement problem, and go through the same
failures, recoveries and reference ``churn_trace`` ticks (converted to the
port's ``ChurnEvent``).  After every operation both must hold identical
token streams, ``exits_taken``, placements, frontiers, contingency
counters and every ``EngineStats`` field (energies bit for bit: the tier
accounting is the same host arithmetic over the same placements).  The
library built for the same plan must equal the reference's entry for
entry.  The config is the reduced qwen3-4b (float32).
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.core as R
from repro.configs import get as ref_get
from repro.core.contingency import ContingencyLibrary as RefLibrary
from repro.core.contingency import NoFeasiblePlacement as RefNoFeasible
from repro.core.contingency import candidate_masks as ref_candidate_masks
from repro.core.contingency import tier_groups_of as ref_tier_groups_of
from repro.core.multiapp import PAPER_MULTIAPP_REQS
from repro.core.scenarios import ChurnEvent as RefChurnEvent
from repro.core.scenarios import churn_trace as ref_churn_trace
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.models import transformer as RT
from repro.runtime.serve_engine import SplitServeEngine as RefEngine
from repro.runtime.serve_engine import serve_with_churn as ref_serve_with_churn

import repro_torch as T
from repro_torch.configs import get
from repro_torch.convert import (network_from, profile_from,
                                 requirements_from, transformer_params_from)
from repro_torch.core.contingency import (ContingencyLibrary,
                                          NoFeasiblePlacement,
                                          candidate_masks, tier_groups_of)
from repro_torch.core.scenarios import ChurnEvent, churn_trace
from repro_torch.runtime.serve_engine import (SplitServeEngine,
                                              serve_with_churn)

CPU = "cpu"
#: exit-0 threshold of the reduced model: about half of its tokens exit
#: early (its exit-0 confidences run 0.027-0.082 at random init)
THRESHOLD = 0.05


@pytest.fixture(scope="module")
def setup():
    cfg_r = ref_get("qwen3-4b", reduced=True)
    params_r = RT.init_model(jax.random.PRNGKey(0), cfg_r)
    cfg = get("qwen3-4b", reduced=True)
    params = transformer_params_from(jax.tree.map(np.asarray, params_r), cfg,
                                     device="cpu")
    return cfg_r, params_r, cfg, params


def _twins(setup, network=None, profile=None, req=None, **kw):
    """The reference engine and the port's (on the CPU) on one problem."""
    cfg_r, params_r, cfg, params = setup
    kw.setdefault("batch_size", 4)
    kw.setdefault("cache_len", 64)
    ref = RefEngine(cfg_r, params_r, network=network, profile=profile,
                    req=req, **kw)
    got = SplitServeEngine(
        cfg, params, network=None if network is None else network_from(
            network),
        profile=None if profile is None else profile_from(profile),
        req=None if req is None else requirements_from(req.alpha, req.delta,
                                                       req.sigma),
        device=CPU, **kw)
    return ref, got


def _rows(fr):
    return None if fr is None else [
        (r.energy, r.latency, r.accuracy, r.final_exit,
         tuple(r.config.placement)) for r in fr]


def _cfg(c):
    return None if c is None else (list(c.placement), c.final_exit)


def _assert_twins(ref, got, reqs=None, msg=""):
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(ref.stats), msg
    assert got.stats.measured_phi == ref.stats.measured_phi, msg
    assert (got.pos, got.paused, got.degraded) == \
        (ref.pos, ref.paused, ref.degraded), msg
    assert _cfg(got.placement) == _cfg(ref.placement), msg
    assert _rows(got.frontier) == _rows(ref.frontier), msg
    if ref.plan is not None:
        assert got.plan.masked_nodes == ref.plan.masked_nodes, msg
        assert dataclasses.asdict(got.plan.stats) == \
            dataclasses.asdict(ref.plan.stats), msg
    if ref.contingency is not None:
        assert dataclasses.asdict(got.contingency.stats) == \
            dataclasses.asdict(ref.contingency.stats), msg
    for r, g in reqs or ():
        assert (g.rid, g.tokens, g.exits_taken, g.done) == \
            (r.rid, r.tokens, r.exits_taken, r.done), msg


def _submit(ref, got, n, max_new, prompt_len=3):
    reqs = []
    for i in range(n):
        prompt = [1 + i % 7] + list(range(2, prompt_len + 1))
        reqs.append((ref.submit(prompt, max_new), got.submit(prompt,
                                                             max_new)))
    return reqs


def _placed_twins(setup, **kw):
    """The failover-bench setup: h1 on paper_scenario(n_extra_edge=1), in
    the off-mobile channel regime, with a freshly keyed library."""
    nw = ref_paper_scenario(n_extra_edge=1)
    ref, got = _twins(setup, nw, R.paper_profile("h1"),
                      PAPER_MULTIAPP_REQS["h1"], **kw)
    for eng in (ref, got):
        eng.plan.update_uplink(0.3e9)
        eng._replace()
        if eng.contingency is not None:
            eng.refresh_contingency()
    return ref, got, nw


def _weak_source_twins(setup, **kw):
    """A source node that cannot serve alone: masking every helper leaves
    no feasible placement."""
    nw = ref_paper_scenario(n_extra_edge=1)
    nw.compute[nw.source_node] *= 1e-3
    return _twins(setup, nw, R.paper_profile("h2"),
                  R.AppRequirements(alpha=0.5, delta=8e-3), **kw) + (nw,)


# ---------------------------------------------------------------------------
# decode and gating
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thresholds,batch,n_req,max_new", [
    ([THRESHOLD], 4, 10, 5),      # mixed exits, slots refilled
    ([0.0], 2, 3, 4),             # everything exits at the first exit
    ([1.1], 3, 5, 6),             # nothing exits early
    (None, 4, 6, 3),              # the default 0.9 thresholds
])
def test_engine_without_placement_matches_reference(setup, thresholds, batch,
                                                    n_req, max_new):
    ref, got = _twins(setup, thresholds=thresholds, batch_size=batch)
    reqs = _submit(ref, got, n_req, max_new)
    for _ in range(200):
        if not (any(ref.slots) or ref.queue):
            break
        ref.step()
        got.step()
        _assert_twins(ref, got, reqs)
    assert all(g.done for _, g in reqs)
    assert got.stats.tokens_out == n_req * max_new
    if thresholds == [THRESHOLD]:
        assert set(got.stats.exit_histogram) == {0, 1}


@pytest.mark.parametrize("app,alpha,delta", [("h2", 0.5, 8e-3),
                                             ("h1", 0.55, 5e-3),
                                             ("h5", 0.93, 1e-3)])
def test_engine_with_placement_matches_reference(setup, app, alpha, delta):
    """FIN placement and tier accounting: same placement, frontier and
    energies, token for token."""
    ref, got = _twins(setup, ref_paper_scenario(), R.paper_profile(app),
                      R.AppRequirements(alpha=alpha, delta=delta),
                      thresholds=[THRESHOLD])
    _assert_twins(ref, got)
    reqs = _submit(ref, got, 7, 4)
    ref.run(max_steps=100)
    got.run(max_steps=100)
    _assert_twins(ref, got, reqs)
    assert got.stats.energy_j > 0 and got.stats.blocks_saved > 0


def _arch_setup(arch):
    cfg_r = ref_get(arch, reduced=True)
    params_r = RT.init_model(jax.random.PRNGKey(0), cfg_r)
    cfg = get(arch, reduced=True)
    params = transformer_params_from(jax.tree.map(np.asarray, params_r), cfg,
                                     device="cpu")
    return cfg_r, params_r, cfg, params


def _median_exit_conf(cfg_r, params_r, batch):
    """The median confidence of each early exit over one decode step of
    ``batch`` seeded tokens at position 0 (the reference's gate)."""
    from repro.kernels.ee_gate.ops import ee_gate as ref_ee_gate
    toks = np.random.default_rng(3).integers(0, cfg_r.vocab_size,
                                             (batch, 1)).astype(np.int32)
    _, _, exits = RT.decode_step(params_r, cfg_r, jax.numpy.asarray(toks),
                                 RT.init_caches(cfg_r, batch, 8),
                                 jax.numpy.int32(0))
    return [float(np.median(np.asarray(ref_ee_gate(exits[f"exit_{p}"])[0])))
            for p in cfg_r.exit_layer_list]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mixtral-8x22b"])
def test_engine_on_ssm_and_moe_matches_reference(arch):
    """Twin engines on the reduced Mamba-2 (SSM states carried across
    steps and into recycled slots) and Mixtral (MoE, a 16-slot sliding
    window that wraps): placement, a failure and a recovery mid-serving,
    and the same tokens, exits and stats after every step."""
    setup = _arch_setup(arch)
    thresholds = _median_exit_conf(setup[0], setup[1], 16)
    ref, got, nw = _placed_twins(setup, thresholds=thresholds, batch_size=3)
    reqs = _submit(ref, got, 7, 5)
    victim = ref.placement.placement[-1]
    assert victim != nw.source_node
    for step in range(60):
        if not (any(ref.slots) or ref.queue):
            break
        if step in (4, 9):
            for eng in (ref, got):
                (eng.fail_node if step == 4 else eng.recover_node)(victim)
        ref.step()
        got.step()
        _assert_twins(ref, got, reqs, f"{arch} step {step}")
    assert all(g.done for _, g in reqs)
    assert got.pos > 16 and set(got.stats.exit_histogram) == {0, 1}
    assert got.stats.replacements >= 2


# ---------------------------------------------------------------------------
# failover, contingency and degradation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("contingency", [True, False])
@pytest.mark.parametrize("ops", [
    (("fail", 1), ("fail", 2), ("recover", 1), ("recover", 2)),
    (("fails", (1, 2)), ("recover", 1), ("recover", 2)),
    (("fail", "last"), ("recover", "last")),
])
def test_failover_sequences_match_reference(setup, ops, contingency):
    """Failures and recoveries with serving steps in between: contingency
    hits / misses, re-splits and migration accounting are identical."""
    ref, got, nw = _placed_twins(setup, contingency=contingency,
                                 thresholds=[THRESHOLD], batch_size=2)
    reqs = _submit(ref, got, 4, 6)
    last = ref.placement.placement[-1]
    for kind, node in ops:
        node = last if node == "last" else node
        for eng in (ref, got):
            if kind == "fails":
                eng.fail_nodes(list(node))
            elif kind == "fail":
                eng.fail_node(node)
            else:
                eng.recover_node(node)
            eng.step()
            eng.step()
        _assert_twins(ref, got, reqs, f"{kind} {node}")
    if contingency:
        assert got.stats.contingency_hits > 0


def test_migration_aware_resplit_matches_reference(setup):
    """migration_weight = 1: the recovery re-split keeps the incumbent in
    both engines."""
    ref, got, nw = _placed_twins(setup, migration_weight=1.0)
    victim = next(p for p in ref.placement.placement if p != nw.source_node)
    for eng in (ref, got):
        eng.fail_node(victim)
    _assert_twins(ref, got)
    kept = list(got.placement.placement)
    for eng in (ref, got):
        eng.recover_node(victim)
    _assert_twins(ref, got)
    assert got.placement.placement == kept


@pytest.mark.parametrize("policy", ["pause", "degrade", "raise"])
def test_on_infeasible_policies_match_reference(setup, policy):
    ref, got, nw = _weak_source_twins(setup, on_infeasible=policy)
    reqs = _submit(ref, got, 2, 3)
    if policy == "raise":
        with pytest.raises(RefNoFeasible) as e_ref:
            ref.fail_nodes([1, 2, 3])
        with pytest.raises(NoFeasiblePlacement) as e_got:
            got.fail_nodes([1, 2, 3])
        assert e_got.value.masked_nodes == e_ref.value.masked_nodes
        assert _rows(e_got.value.frontier) == _rows(e_ref.value.frontier)
        assert isinstance(e_got.value, RuntimeError)
        return
    if policy == "degrade":
        # channel collapse: no placement is feasible at 0.1x uplink
        rep = got.on_tick([ChurnEvent("uplink", 0, 0.1)])
        assert rep == ref.on_tick([RefChurnEvent("uplink", 0, 0.1)])
        assert got.degraded and got.stats.degrades == 1
        _assert_twins(ref, got, reqs)
    for eng in (ref, got):
        eng.fail_nodes([1, 2, 3])
        eng.step()
    _assert_twins(ref, got, reqs)
    assert got.paused
    for eng in (ref, got):
        eng.recover_node(3)
        eng.run(max_steps=40)
    _assert_twins(ref, got, reqs)
    assert not got.paused and got.stats.tokens_out == 6


def test_engine_validation_errors(setup):
    cfg_r, params_r, cfg, params = setup
    bare = SplitServeEngine(cfg, params, batch_size=2, cache_len=64,
                            device=CPU)
    for call in (lambda: bare.fail_node(1), lambda: bare.recover_node(1),
                 lambda: bare.on_tick([])):
        with pytest.raises(RuntimeError, match="no placement plan"):
            call()
    ref, got, nw = _placed_twins(setup)
    for bad in (-1, nw.n_nodes, 1.5, "1"):
        with pytest.raises(ValueError):
            got.fail_node(bad)
        with pytest.raises(ValueError):
            got.recover_node(bad)
    with pytest.raises(ValueError):
        got.fail_node(nw.source_node)
    with pytest.raises(ValueError):
        got.fail_nodes([1, nw.n_nodes])
    assert not got.plan._masked.any()
    with pytest.raises(ValueError, match="unsupported churn event"):
        got.on_tick([ChurnEvent("attach", 0, 1)])
    for kw in (dict(on_infeasible="retry"), dict(migration_weight=-1.0),
               dict(frontier_k=0), dict(hysteresis=-0.1)):
        with pytest.raises(ValueError):
            SplitServeEngine(cfg, params, batch_size=2, cache_len=64,
                             device=CPU, **kw)
    with pytest.raises(ValueError, match="encoder-only"):
        SplitServeEngine(get("hubert-xlarge", reduced=True), params,
                         batch_size=2, cache_len=8, device=CPU)
    with pytest.raises(ValueError):
        serve_with_churn(got, [], steps_per_tick=-1)


# ---------------------------------------------------------------------------
# churn-driven serving
# ---------------------------------------------------------------------------

def _port_events(tick):
    return [ChurnEvent(e.kind, e.user, e.value) for e in tick]


@pytest.mark.parametrize("seed,p_fail,p_recover,fail_nodes,mode", [
    (5, 0.3, 0.6, (1,), "iid"),
    (7, 0.25, 0.5, (1, 2), "iid"),
    (3, 0.3, 0.5, (1, 2), "tier"),
])
def test_serve_with_churn_matches_reference(setup, seed, p_fail, p_recover,
                                            fail_nodes, mode):
    """A reference churn trace (fades, failures, recoveries), converted to
    the port's events: identical tick reports, and after every tick
    identical placements, library counters and engine state."""
    ref, got, nw = _placed_twins(setup, thresholds=[THRESHOLD])
    reqs = _submit(ref, got, 3, 10)
    trace = ref_churn_trace(1, 12, seed=seed, p_fail=p_fail,
                            p_recover=p_recover, fail_nodes=fail_nodes,
                            failure_mode=mode)
    assert [_port_events(t) for t in trace] == churn_trace(
        1, 12, seed=seed, p_fail=p_fail, p_recover=p_recover,
        fail_nodes=fail_nodes, failure_mode=mode)
    n_topo = 0
    for t, tick in enumerate(trace):
        rep_r = ref_serve_with_churn(ref, [tick], steps_per_tick=2)
        rep_g = serve_with_churn(got, [_port_events(tick)], steps_per_tick=2)
        assert rep_g == rep_r, t
        n_topo += rep_g[0]["n_fail"] + rep_g[0]["n_recover"]
        _assert_twins(ref, got, reqs, f"tick {t}")
    assert n_topo > 0
    assert got.stats.contingency_hits + got.stats.contingency_misses > 0


# ---------------------------------------------------------------------------
# the contingency library
# ---------------------------------------------------------------------------

def _entry_view(e):
    return (e.masked, e.solution.feasible, _cfg(e.solution.config),
            e.solution.energy if e.solution.feasible else None,
            _rows(e.frontier), _cfg(e.base_config), e.moved, e.bits)


@pytest.mark.parametrize("app,extra", [("h1", 1), ("h2", 2), ("h6", 1)])
def test_contingency_library_entries_match_reference(app, extra):
    """Same candidate masks and tier groups, and after a refill, a mask
    change and a second refill the same entries (solution, frontier,
    migration price), lookups and counters."""
    nw = ref_paper_scenario(n_extra_edge=extra)
    req = PAPER_MULTIAPP_REQS[app]
    ref_plan = R.Plan(nw, R.paper_profile(app), req)
    plan = T.Plan(network_from(nw), profile_from(R.paper_profile(app)),
                  requirements_from(req.alpha, req.delta, req.sigma),
                  device=CPU)
    for p in (ref_plan, plan):
        p.update_uplink(0.3e9)
        p.solve()
    assert tier_groups_of(plan.network) == ref_tier_groups_of(nw)
    base = np.zeros(nw.n_nodes, dtype=bool)
    base[1] = True
    kw = dict(tier_groups=ref_tier_groups_of(nw), max_masks=6,
              observed=[np.ones(nw.n_nodes, dtype=bool)])
    assert [m.tolist() for m in candidate_masks(base, 0, **kw)] == \
        [m.tolist() for m in ref_candidate_masks(base, 0, **kw)]
    ref_lib, lib = RefLibrary(ref_plan), ContingencyLibrary(plan)
    for step in range(2):
        assert lib.refill() == ref_lib.refill()
        assert sorted(lib._entries) == sorted(ref_lib._entries)
        for key in ref_lib._entries:
            assert _entry_view(lib._entries[key]) == \
                _entry_view(ref_lib._entries[key])
        for n in range(1, nw.n_nodes):
            m = plan._masked.copy()
            m[n] = not m[n]
            got, want = lib.lookup(m), ref_lib.lookup(m)
            assert (got is None) == (want is None)
        assert dataclasses.asdict(lib.stats) == \
            dataclasses.asdict(ref_lib.stats)
        assert dataclasses.asdict(plan.stats) == \
            dataclasses.asdict(ref_plan.stats)
        for p in (ref_plan, plan):
            p.mask_node(1)
    for p in (ref_plan, plan):
        p.update_uplink(0.5e9)
    assert lib.stale and ref_lib.stale
    assert lib.lookup(plan._masked) is None
    assert ref_lib.lookup(ref_plan._masked) is None
    assert dataclasses.asdict(lib.stats) == dataclasses.asdict(ref_lib.stats)
    assert lib.state_dict()["obs_counts"].tolist() == \
        ref_lib.state_dict()["obs_counts"].tolist()


def test_no_feasible_placement_payload():
    err = NoFeasiblePlacement([2, 1])
    assert err.masked_nodes == [2, 1] and err.frontier is None
    assert isinstance(err, RuntimeError) and "[2, 1]" in str(err)
