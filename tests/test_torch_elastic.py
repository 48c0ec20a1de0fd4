"""The port's elastic rescale and FIN failover
(``repro_torch.runtime.elastic``) vs the JAX package's.

Counterpart of ``tests/test_elastic.py`` (the mesh planner on the port's
``ArchConfig``s, held to the reference's outputs) and of the
``fin_failover`` test of ``tests/test_contingency.py``.  Twin
``fin_failover`` runs over the reference's ``Plan`` and the port's (on the
CPU), with and without a ``ContingencyLibrary``, fail and recover every
non-source node: identical Solutions, ``blocks_moved``,
``migration_bits`` and ``library_hit``, and the warm result bit-equal to a
cold ``solve_fin`` on the reduced network.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
from repro.configs import get as ref_get
from repro.core.contingency import ContingencyLibrary as RefLibrary
from repro.core.multiapp import PAPER_MULTIAPP_REQS
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.runtime import elastic as RE

import repro_torch as T
from repro_torch.configs import get
from repro_torch.convert import (network_from, profile_from,
                                 requirements_from)
from repro_torch.core.contingency import ContingencyLibrary
from repro_torch.runtime.elastic import (FinFailover, MeshPlan,
                                         candidate_meshes, fin_failover,
                                         plan_rescale)

from test_torch_fin import assert_same

CPU = "cpu"
ARCHS = ("qwen3-4b",)


def test_candidates_respect_divisibility():
    cfg = get("qwen3-4b")
    cands = candidate_meshes(cfg, 256)
    assert cands, "must find a mesh at full size"
    for m in cands:
        assert cfg.d_model % m.model == 0
        assert cfg.d_ff % m.model == 0
        assert cfg.padded_vocab % m.model == 0


def test_degraded_mesh_found_after_loss():
    cands = candidate_meshes(get("qwen3-4b"), 250)
    assert cands and 200 <= cands[0].chips <= 250


@pytest.mark.parametrize("chips", [1, 7, 64, 128, 240, 250, 251, 255, 256])
def test_candidate_meshes_match_reference(chips):
    for name in ARCHS:
        got = candidate_meshes(get(name), chips)
        want = RE.candidate_meshes(ref_get(name), chips)
        assert [dataclasses.astuple(m) for m in got] == \
            [dataclasses.astuple(m) for m in want]
    pure = dataclasses.replace(get("qwen3-4b"), parallelism_mode="pure_dp")
    ref_pure = dataclasses.replace(ref_get("qwen3-4b"),
                                   parallelism_mode="pure_dp")
    assert [m.chips for m in candidate_meshes(pure, chips)] == \
        [m.chips for m in RE.candidate_meshes(ref_pure, chips)]


@pytest.mark.parametrize("chips,batch", [(128, 256), (240, 256), (255, 256),
                                         (250, 250), (0, 8)])
def test_plan_rescale_matches_reference(chips, batch):
    old, ref_old = MeshPlan(data=16, model=16), RE.MeshPlan(data=16,
                                                            model=16)
    got = plan_rescale(get("qwen3-4b"), old, chips, param_bytes=8.8e9,
                       global_batch=batch)
    want = RE.plan_rescale(ref_get("qwen3-4b"), ref_old, chips,
                           param_bytes=8.8e9, global_batch=batch)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.astuple(got.new) == dataclasses.astuple(want.new)
        assert got.moved_bytes == want.moved_bytes
        assert got.batch_ok == want.batch_ok
        if got.new.model != old.model:
            assert got.moved_bytes == 8.8e9


def _plans(app, n_extra_edge=1, uplink=0.3e9):
    nw = ref_paper_scenario(n_extra_edge=n_extra_edge)
    pf = R.paper_profile(app)
    req = PAPER_MULTIAPP_REQS[app]
    ref = R.Plan(nw, pf, req)
    got = T.Plan(network_from(nw), profile_from(pf),
                 requirements_from(req.alpha, req.delta, req.sigma),
                 device=CPU)
    for p in (ref, got):
        p.update_uplink(uplink)
        p.solve()
    return ref, got


def _same_failover(a, b, ctx):
    assert isinstance(b, FinFailover)
    assert_same(a.solution, b.solution, meta=False)
    assert a.feasible == b.feasible, ctx
    assert (a.blocks_moved, a.migration_bits, a.library_hit) == \
        (b.blocks_moved, b.migration_bits, b.library_hit), ctx
    for x, y in ((a.old_config, b.old_config), (a.new_config, b.new_config)):
        assert (x is None) == (y is None), ctx
        if x is not None:
            assert (x.placement, x.final_exit) == \
                (y.placement, y.final_exit), ctx


def _cold_reduced(plan, victim):
    """``solve_fin`` on the plan's network with ``victim`` removed, its
    placement mapped back to the full network's node ids."""
    nw = plan.network
    keep = [i for i in range(nw.n_nodes) if i != victim]
    red = T.Network(nodes=[nw.nodes[i] for i in keep],
                    bandwidth=nw.bandwidth[np.ix_(keep, keep)].copy(),
                    compute=nw.compute[keep].copy(), source_node=0)
    cold = T.solve_fin(red, plan.profile, plan.req, device=CPU)
    placement = ([keep[p] for p in cold.config.placement]
                 if cold.found else None)
    return cold, placement


@pytest.mark.parametrize("library", [False, True])
@pytest.mark.parametrize("app", ["h1", "h2", "h4", "h6"])
def test_fin_failover_twins(app, library):
    ref, got = _plans(app)
    ref_lib = lib = None
    if library:
        ref_lib, lib = RefLibrary(ref), ContingencyLibrary(got)
        assert ref_lib.refill() == lib.refill()
    hits = 0
    for node in range(1, got.network.n_nodes):
        a = RE.fin_failover(ref, node, library=ref_lib)
        b = fin_failover(got, node, library=lib)
        _same_failover(a, b, (app, node, "fail"))
        hits += b.library_hit
        cold, placement = _cold_reduced(got, node)
        assert b.solution.found == cold.found
        if cold.found:
            assert b.solution.energy == cold.energy
            assert b.solution.config.placement == placement
            assert node not in b.solution.config.placement
        a = RE.fin_failover(ref, node, recover=True, library=ref_lib)
        b = fin_failover(got, node, recover=True, library=lib)
        _same_failover(a, b, (app, node, "recover"))
        hits += b.library_hit
        if library:
            assert dataclasses.asdict(lib.stats) == \
                dataclasses.asdict(ref_lib.stats)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(ref.stats)
    assert (hits > 0) == library


def test_fin_failover_library_hit_is_solve_free_and_equals_warm():
    _, plan = _plans("h2")
    lib = ContingencyLibrary(plan)
    lib.refill()
    r0 = plan.stats.dp_relaxes
    out = fin_failover(plan, 1, library=lib)
    assert out.library_hit and plan.stats.dp_relaxes == r0
    _, twin = _plans("h2")
    warm = fin_failover(twin, 1)
    assert not warm.library_hit
    assert out.solution.energy == warm.solution.energy
    assert out.new_config == warm.new_config
    assert (out.blocks_moved, out.migration_bits) == \
        (warm.blocks_moved, warm.migration_bits)
    out2 = fin_failover(plan, 1, recover=True, library=lib)
    assert out2.library_hit and plan.stats.dp_relaxes == r0
