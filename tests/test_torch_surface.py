"""The port's public surface against the reference's.

* Package-wide: for every module of ``src/repro/``, each public top-level
  name (a function, class or constant it defines; a package's
  ``__all__``) exists in the port's twin module, the module of the same
  path under ``src/repro_torch/``.  The twins of the three Pallas modules
  are their wrappers' ``ops.py`` (with the CUDA sources in ``csrc/``).
  ``MAPPED`` lists the reference's backend-suffixed names, each against
  the port function that stands for it, and every target exists;
  ``QUEUED`` (the names still to come) is empty: the sharded-execution
  hooks it held, ``_sp_constraint`` and ``_head_constraint``, exist in
  the port.
* ``repro_torch.core.__all__`` holds every name of ``repro.core.__all__``:
  no module of the reference's core is still to be ported
  (``QUEUED_MODULES`` and ``QUEUED_NAMES`` are empty).
* The ported scenario helpers and tables equal the reference's:
  ``paper_apps`` (the six profiles, field for field), ``TPU_TIERS`` (data)
  and ``to_networkx`` (the same vertices, edges and ``energy`` /
  ``latency`` attributes on the paper scenario).  Everything runs on the
  CPU.
"""
import ast
import dataclasses
import importlib
import inspect
import pathlib
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

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF_MODULES = sorted(p.relative_to(SRC / "repro").as_posix()
                     for p in (SRC / "repro").rglob("*.py"))

#: reference modules whose twin has another path: a Pallas kernel's twin
#: is its wrapper module, which launches the CUDA kernel of ``csrc/``
TWIN_MODULES = {
    "kernels/minplus/minplus.py": "kernels/minplus/ops.py",
    "kernels/ee_gate/ee_gate.py": "kernels/ee_gate/ops.py",
    "kernels/decode_attn/decode_attn.py": "kernels/decode_attn/ops.py",
}

#: the reference's names for one function on several backends (numpy,
#: jnp, Pallas), each against the port's one function that dispatches on
#: the device (a CUDA tensor launches the kernel, a CPU tensor runs its
#: plain version); "module:name" in the port, or a CUDA source that
#: stands for the name
MAPPED = {
    # the reference's numpy / jnp / Pallas engines of the DP
    "core/bellman_ford.py:bellman_ford_np": "core.bellman_ford:bellman_ford",
    "core/bellman_ford.py:minplus_vecmat_np":
        "core.bellman_ford:minplus_vecmat",
    "core/bellman_ford.py:minplus_vecmat_jnp":
        "core.bellman_ford:minplus_vecmat",
    "core/bellman_ford.py:minplus_matmat_jnp":
        "kernels.minplus.ops:minplus_matmat",
    "core/bellman_ford.py:layered_relax_jnp": "core.bellman_ford:layered_relax",
    "core/bellman_ford.py:batched_banded_relax_kbest_pallas":
        "core.bellman_ford:batched_banded_relax_kbest",
    # the jitted ingest (B2)
    "kernels/ee_gate/population.py:quant_signature_jnp":
        "kernels.ee_gate.population:quant_signature",
    "kernels/minplus/ref.py:minplus_matmat_ref":
        "kernels.minplus.ops:minplus_matmat",
    # the Pallas kernels: B5, B4, B3, B1, B1u, B6, B7
    "kernels/minplus/minplus.py:minplus_pallas":
        "kernels.minplus.ops:minplus_vecmat",
    "kernels/minplus/minplus.py:minplus_argmin_pallas":
        "kernels.minplus.ops:minplus_vecmat_argmin",
    "kernels/minplus/minplus.py:banded_minplus_chain_kbest_pallas":
        "kernels.minplus.ops:banded_minplus_chain_kbest",
    "kernels/minplus/minplus.py:banded_minplus_chain_pallas":
        "kernels.minplus.ops:banded_minplus_chain",
    "kernels/minplus/minplus.py:banded_minplus_pallas":
        "kernels.minplus.ops:banded_minplus_argmin",
    "kernels/ee_gate/ee_gate.py:ee_gate_pallas": "kernels.ee_gate.ops:ee_gate",
    "kernels/decode_attn/decode_attn.py:decode_attn_pallas":
        "kernels.decode_attn.ops:decode_attn",
    # the Pallas kernels' sentinels: the plain versions' constants, and the
    # dense CUDA kernel, which takes +inf where the TPU kernel takes BIG
    "kernels/ee_gate/ee_gate.py:NEG": "kernels.ee_gate.ref:NEG",
    "kernels/decode_attn/decode_attn.py:NEG":
        "kernels.decode_attn.ref:KERNEL_NEG",
    "kernels/minplus/minplus.py:BIG":
        "kernels/minplus/csrc/minplus_dense.cu",
}

#: names still to come, with the reason: none since sharded execution
#: brought the model hooks below
QUEUED: dict = {}

#: the names queued until sharded execution: the reference's activation
#: sharding hooks, private names the public-name check does not see
SHARDED_HOOKS = ["models/ssm.py:_head_constraint",
                 "models/transformer.py:_sp_constraint"]


def _public_names(path: pathlib.Path) -> set:
    """A package's ``__all__``; a module's top-level functions, classes
    and assigned names that do not start with an underscore."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if t.id == "__all__" and path.name == "__init__.py":
                        return set(ast.literal_eval(node.value))
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    if path.name == "__init__.py":
        return set()
    return {n for n in names if not n.startswith("_")}


def _port_module(rel: str):
    twin = TWIN_MODULES.get(rel, rel)
    dotted = twin[:-len(".py")].replace("/", ".")
    if dotted.endswith("__init__"):
        dotted = dotted[:-len(".__init__")]
    return importlib.import_module(
        "repro_torch" + ("." + dotted if dotted else ""))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_its_twin(rel):
    names = _public_names(SRC / "repro" / rel)
    mod = _port_module(rel)
    missing = {n for n in names if not hasattr(mod, n)
               and f"{rel}:{n}" not in MAPPED}
    assert not missing, (rel, sorted(missing))


@pytest.mark.parametrize("key", sorted(MAPPED))
def test_mapped_names_have_their_targets(key):
    rel, name = key.split(":")
    assert name in _public_names(SRC / "repro" / rel), key
    assert not hasattr(_port_module(rel), name)
    target = MAPPED[key]
    if target.endswith(".cu"):
        src = (SRC / "repro_torch" / target).read_text()
        assert name in src, (key, target)
        return
    mod, attr = target.split(":")
    obj = getattr(importlib.import_module(f"repro_torch.{mod}"), attr)
    assert callable(obj) or isinstance(obj, float), key


@pytest.mark.parametrize("key", SHARDED_HOOKS)
def test_queued_names_are_the_sharded_execution_hooks(key):
    """The names once queued here, the sharded-execution hooks, now exist
    in the port beside the reference's, and nothing is queued."""
    rel, name = key.split(":")
    ref = importlib.import_module(
        "repro." + rel[:-len(".py")].replace("/", "."))
    assert callable(getattr(ref, name))
    assert callable(getattr(_port_module(rel), name)), key
    assert not QUEUED


def test_every_reference_module_has_a_twin_file():
    port = SRC / "repro_torch"
    for rel in REF_MODULES:
        assert (port / TWIN_MODULES.get(rel, rel)).exists(), rel
    for rel, twin in TWIN_MODULES.items():
        assert any((port / twin).parent.joinpath("csrc").glob("*.cu")), rel


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


@pytest.mark.parametrize("ref_mod,port_mod,names", [
    ("repro.core.faults", "repro_torch.core.faults",
     ("FaultPlan", "FaultSpec", "InjectedCrash", "CRASH_STAGES",
      "corrupt_specs")),
    ("repro.runtime.checkpoint", "repro_torch.runtime.checkpoint",
     ("save", "available_steps", "load_arrays", "restore", "restore_latest",
      "MANIFEST", "ARRAYS")),
    ("repro.runtime.elastic", "repro_torch.runtime.elastic",
     ("MeshPlan", "candidate_meshes", "ReshardPlan", "plan_rescale",
      "FinFailover", "fin_failover")),
    ("repro.sharding.population", "repro_torch.sharding.population",
     ("population_mesh", "MeshRelaxer"))])
def test_fault_tolerance_modules_mirror_the_reference(ref_mod, port_mod,
                                                      names):
    """The fault-tolerance layer keeps the reference's module paths and
    names (``repro.core.__all__`` does not export them); the constants are
    equal and the public functions take the reference's parameters."""
    import importlib
    ref, port = importlib.import_module(ref_mod), importlib.import_module(
        port_mod)
    assert set(getattr(ref, "__all__", ())) <= set(dir(port))
    for name in names:
        a, b = getattr(ref, name), getattr(port, name)
        if isinstance(a, (str, tuple)):
            assert a == b, name
        elif inspect.isfunction(a):
            pa = [p for p in inspect.signature(a).parameters]
            pb = [p for p in inspect.signature(b).parameters]
            assert pa == pb[:len(pa)], name
