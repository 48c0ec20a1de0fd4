"""The port's public surface against the reference's.

* ``repro_torch.core.__all__`` holds every name of ``repro.core.__all__``:
  no module of the reference's core is still to be ported
  (``QUEUED_MODULES`` and ``QUEUED_NAMES`` are empty).
* The ported scenario helpers and tables equal the reference's:
  ``paper_apps`` (the six profiles, field for field), ``TPU_TIERS`` (data)
  and ``to_networkx`` (the same vertices, edges and ``energy`` /
  ``latency`` attributes on the paper scenario).  Everything runs on the
  CPU.
"""
import dataclasses
import inspect
import re

import numpy as np
import pytest

import repro.core as R
from repro.core.extended_graph import to_networkx as ref_to_networkx
from repro.core.scenarios import paper_apps as ref_paper_apps
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.core.system_model import TPU_TIERS as REF_TPU_TIERS

import repro_torch as T
import repro_torch.core as P
from repro_torch.convert import network_from, profile_from

QUEUED_MODULES = ()
QUEUED_NAMES = set()


def _home(name: str) -> str:
    """The reference module (short name) that defines ``name``: a class's or
    function's ``__module__``, or for data the module whose source assigns
    it at top level."""
    obj = getattr(R, name)
    mod = getattr(obj, "__module__", None)
    if inspect.isclass(obj) or inspect.isfunction(obj):
        return mod.rsplit(".", 1)[-1]
    for short in QUEUED_MODULES + ("scenarios", "system_model",
                                   "contingency"):
        src = inspect.getsource(getattr(R, short))
        if re.search(rf"^{re.escape(name)}\s*[:=]", src, re.M):
            return short
    raise AssertionError(f"no reference module defines {name}")


def test_core_surface_lacks_only_the_queued_modules():
    missing = set(R.__all__) - set(P.__all__)
    unexpected = {n for n in missing
                  if n not in QUEUED_NAMES and _home(n) not in QUEUED_MODULES}
    assert not unexpected, sorted(unexpected)
    assert not missing, sorted(missing)
    assert set(R.__all__) <= set(P.__all__)
    # every name the port exports resolves, at both levels
    for name in P.__all__:
        assert getattr(P, name) is getattr(T, name)


@pytest.mark.parametrize("name", ["ChurnEvent", "churn_trace",
                                  "NoFeasiblePlacement", "ContingencyStats",
                                  "ContingencyPolicy", "ContingencyEntry",
                                  "ContingencyLibrary", "candidate_masks",
                                  "tier_groups_of", "paper_apps",
                                  "to_networkx", "TPU_TIERS", "Population",
                                  "PopulationStats", "PopulationContingency",
                                  "SharedCapacity", "CongestionController",
                                  "CongestionReport", "accumulate_loads",
                                  "config_load_rows", "app_price_weights",
                                  "run_multiapp", "MultiAppResult",
                                  "AppStats", "PlanCache",
                                  "PAPER_MULTIAPP_REQS", "default_solvers",
                                  "user_network", "user_networks",
                                  "ChurnOrchestrator", "ChurnStats",
                                  "TickReport", "population_plans",
                                  "population_cohorts"])
def test_ported_names_are_exported(name):
    assert name in P.__all__
    obj = getattr(T, name)
    assert not getattr(obj, "__module__", "repro_torch").startswith("repro.")


def test_tpu_tiers_equal_the_reference():
    assert P.TPU_TIERS == REF_TPU_TIERS
    nw = P.make_network(("mobile", "edge-tpu", "pod"),
                        profiles={**P.PAPER_TIERS, **P.TPU_TIERS})
    ref = R.make_network(("mobile", "edge-tpu", "pod"),
                         profiles={**R.PAPER_TIERS, **R.TPU_TIERS})
    assert nw.compute.tobytes() == ref.compute.tobytes()
    assert nw.bandwidth.tobytes() == ref.bandwidth.tobytes()


def test_paper_apps_equal_the_reference():
    got, want = P.paper_apps(), ref_paper_apps()
    assert list(got) == list(want)
    for app in want:
        ref = profile_from(want[app])
        for f in ("name", "input_bits", "block_ops", "cut_bits", "exits"):
            assert getattr(got[app], f) == getattr(ref, f), (app, f)
        assert [dataclasses.asdict(e) for e in got[app].exits] == \
            [dataclasses.asdict(e) for e in ref.exits]


@pytest.mark.parametrize("n_extra_edge", [0, 2])
@pytest.mark.parametrize("app", ["h1", "h4", "h6"])
def test_to_networkx_equals_the_reference(app, n_extra_edge):
    ref_nw = ref_paper_scenario(n_extra_edge=n_extra_edge)
    ref_pf = ref_paper_apps()[app]
    req = R.AppRequirements(alpha=0.5, delta=8e-3)
    want = ref_to_networkx(R.build_extended_graph(ref_nw, ref_pf, req))
    got = P.to_networkx(P.build_extended_graph(
        network_from(ref_nw), profile_from(ref_pf),
        P.AppRequirements(alpha=0.5, delta=8e-3), device="cpu"))
    assert list(got.nodes) == list(want.nodes)
    assert list(got.edges) == list(want.edges)
    assert got.number_of_edges() > 0
    for u, v, attrs in want.edges(data=True):
        for key in ("energy", "latency"):
            assert np.float64(got.edges[u, v][key]).tobytes() == \
                np.float64(attrs[key]).tobytes(), (u, v, key)
