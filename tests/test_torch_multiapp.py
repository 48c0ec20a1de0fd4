"""The port's multi-application orchestration (Fig. 8) vs the JAX package's.

Counterparts of ``tests/test_multiapp.py``.  ``run_multiapp`` of both
packages on the same seeds must give identical ``MultiAppResult``s: every
``AppStats`` field of every app and solver (``solve_time`` left out; the
energies, tier blocks, failures and exit usage bit for bit), hence the
same ``energy_gain``; with bucketed uplinks the same cache hits, through
the MCP loop's per-bucket cache and through a persistent ``PlanCache``.
The port's results also carry the paper's Fig. 8 claims.  Everything runs
on the CPU.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.core.multiapp as RM

import repro_torch as T
import repro_torch.core.multiapp as TM

CPU = "cpu"
APPS = ("h1", "h2", "h3", "h4", "h5", "h6")


def _fields(st):
    d = dataclasses.asdict(st)
    d.pop("solve_time")
    d["exit_usage"] = d["exit_usage"].tobytes()
    return d


def assert_results(ref, got):
    assert list(ref.stats) == list(got.stats)
    for app in ref.stats:
        assert list(ref.stats[app]) == list(got.stats[app])
        for name in ref.stats[app]:
            assert _fields(ref.stats[app][name]) == \
                _fields(got.stats[app][name]), (app, name)
        a, b = ref.energy_gain(app), got.energy_gain(app)
        assert a == b or (np.isnan(a) and np.isnan(b)), app


CASES = {
    "fig8_20": dict(n_users=20, seed=1),
    "contention_40": dict(n_users=40, seed=1, divide_slice_by_users=True),
    "seed42_8": dict(n_users=8, seed=42),
    "buckets_24": dict(n_users=24, seed=3, uplink_buckets=4),
    "continuous_6": dict(n_users=6, seed=0),
}


@pytest.fixture(scope="module")
def results():
    """Both packages' results for every case, computed once."""
    out = {}
    for name, kw in CASES.items():
        kw = dict(kw)
        n = kw.pop("n_users")
        out[name] = (R.run_multiapp(n, **kw),
                     T.run_multiapp(n, device=CPU, **kw))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_run_multiapp_matches_reference(results, case):
    assert_results(*results[case])


def test_fig8_claims_hold_on_the_port(results):
    """Fig. 8: FIN below 0.70 of MCP's energy and failing at most as often
    (under 5%); MCP leans on the cloud, FIN on the mobile device; h2 takes
    its first exit and h1 reaches its deepest."""
    res = results["fig8_20"][1]
    fin_local = mcp_local = 0.0
    for app in APPS:
        g = res.energy_gain(app)
        assert np.isfinite(g) and g <= 0.70 + 1e-9, (app, g)
        fin, mcp = res.stats[app]["fin"], res.stats[app]["mcp"]
        assert fin.failure_prob <= mcp.failure_prob + 1e-9
        assert fin.failure_prob <= 0.05 + 1e-9
        fin_local += fin.tier_probs().get("mobile", 0.0)
        mcp_local += mcp.tier_probs().get("mobile", 0.0)
    assert fin_local > mcp_local
    assert res.stats["h2"]["fin"].exit_probs()[0] == pytest.approx(1.0)
    assert res.stats["h1"]["fin"].exit_probs()[-1] > 0.05
    res = results["contention_40"][1]
    for app in APPS:
        assert res.stats[app]["fin"].failure_prob <= \
            res.stats[app]["mcp"].failure_prob + 1e-9


def test_bucket_cache_hits(results):
    """24 users over 4 buckets: at least 20 MCP solves a app come from the
    per-bucket cache, the batched FIN path counts none; without buckets
    nothing is cached."""
    res = results["buckets_24"][1]
    assert sum(res.stats[a]["mcp"].solve_cache_hits for a in APPS) >= \
        len(APPS) * 20
    for app in APPS:
        assert res.stats[app]["fin"].solve_cache_hits == 0
        g = res.energy_gain(app)
        assert np.isfinite(g) and g <= 0.75
    res = results["continuous_6"][1]
    assert all(res.stats[a]["mcp"].solve_cache_hits == 0 for a in APPS)


def test_plan_cache_matches_reference_across_calls():
    """A persistent ``PlanCache`` through a growing-population sweep:
    identical results and hit / miss counts to the reference's, and equal
    to the batched path without the cache."""
    ref_cache = R.PlanCache()
    got_cache = T.PlanCache(device=CPU)
    for n in (6, 12):
        a = R.run_multiapp(n, seed=2, uplink_buckets=4, plan_cache=ref_cache)
        b = T.run_multiapp(n, seed=2, uplink_buckets=4, plan_cache=got_cache,
                           device=CPU)
        assert_results(a, b)
        assert (got_cache.hits, got_cache.misses, len(got_cache)) == \
            (ref_cache.hits, ref_cache.misses, len(ref_cache))
    plain = T.run_multiapp(12, seed=2, uplink_buckets=4, device=CPU)
    for app in APPS:
        x, y = _fields(plain.stats[app]["fin"]), _fields(b.stats[app]["fin"])
        x.pop("solve_cache_hits"), y.pop("solve_cache_hits")
        assert x == y, app
    assert got_cache.hits > 0


def test_user_networks_and_price_weights_match_reference():
    q = np.array([0.3, 0.55, 0.55, 1.0])
    ref = R.user_networks(q, 0.005)
    got = T.user_networks(q, 0.005)
    assert got[1] is got[2] and got[0] is not got[1]
    for a, b in zip(ref, got):
        assert a.bandwidth.tobytes() == b.bandwidth.tobytes()
        assert a.compute.tobytes() == b.compute.tobytes()
        assert [n.tier for n in a.nodes] == [n.tier for n in b.nodes]
    a = R.user_network(np.random.default_rng(4), 0.01)
    b = T.user_network(np.random.default_rng(4), 0.01)
    assert a.bandwidth.tobytes() == b.bandwidth.tobytes()
    assert TM.EDGE_CLOUD_SLICE == RM.EDGE_CLOUD_SLICE
    assert {k: (v.alpha, v.delta, v.sigma)
            for k, v in T.PAPER_MULTIAPP_REQS.items()} == \
        {k: (v.alpha, v.delta, v.sigma)
         for k, v in R.PAPER_MULTIAPP_REQS.items()}
    with pytest.raises(ValueError, match="mode"):
        T.app_price_weights(mode="fair")
