"""The PyTorch port stands alone and never falls back to the CPU.

* No module of ``src/repro_torch``, no example of ``examples_torch/`` and
  not ``chip_smoke.py`` imports ``jax`` or the JAX package ``repro`` (an
  AST scan of every import).
* Importing ``repro_torch`` in a fresh interpreter leaves ``jax`` out of
  ``sys.modules``.
* ``device=None`` means ``cuda:0`` and raises where CUDA is absent, for
  the solvers, the population cohort, the cohort and plan builders of the
  churn orchestrator, the multi-app solvers, the serving engine and its
  launcher, the users mesh and its relaxer, and the plans that
  ``fin_failover`` re-solves, and the four examples of
  ``examples_torch/`` without ``--device``.
* No stub is left: no module of the port raises ``NotImplementedError``
  for a part of the reference still to be ported.
* ``chip_smoke.py`` exits non-zero, printing no result, without a card.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch as T
from repro_torch import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


EXAMPLES = ROOT / "examples_torch"
EXAMPLE_NAMES = ("quickstart", "multiapp_placement", "serve_split",
                 "train_lm")


def _port_files():
    files = (sorted(PORT.rglob("*.py")) + sorted(EXAMPLES.glob("*.py"))
             + [ROOT / "chip_smoke.py"])
    assert len(files) > 10
    for name in EXAMPLE_NAMES:
        assert EXAMPLES / f"{name}.py" in files, name
    for mod in ("core/capacity.py", "core/contingency.py",
                "core/multiapp.py", "core/online.py", "core/faults.py",
                "runtime/straggler.py", "runtime/checkpoint.py",
                "runtime/elastic.py", "sharding/population.py",
                "models/ssm.py", "models/moe.py", "runtime/steps.py",
                "models/cnn_layers.py", "models/branchy.py",
                "data/synthetic.py", "optim/adamw.py",
                "runtime/train_loop.py", "launch/train.py",
                "launch/flops.py", "launch/analytic.py", "launch/mesh.py",
                "launch/roofline.py", "launch/dryrun.py", "launch/report.py",
                "sharding/specs.py", "sharding/context.py"):
        assert PORT / mod in files, mod
    return files


def test_port_imports_neither_jax_nor_the_reference():
    offenders = []
    for path in _port_files():
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                offenders.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not offenders, offenders


def test_import_in_fresh_interpreter_loads_no_jax_and_builds_nothing():
    """No jax in sys.modules after importing the port, and the kernel
    library is built at first launch, never at import."""
    code = ("import sys, repro_torch, repro_torch.core.fin, "
            "repro_torch.kernels.minplus.ops, repro_torch.convert, "
            "repro_torch.kernels.ee_gate.ops, "
            "repro_torch.kernels.ee_gate.population, "
            "repro_torch.core.population, repro_torch.core.capacity, "
            "repro_torch.core.multiapp, repro_torch.core.online, "
            "repro_torch.runtime.straggler, repro_torch.core.faults, "
            "repro_torch.runtime.checkpoint, repro_torch.runtime.elastic, "
            "repro_torch.sharding.population, "
            "repro_torch.kernels.decode_attn.ops, "
            "repro_torch.runtime.serve_engine, repro_torch.launch.serve, "
            "repro_torch.models.ssm, repro_torch.models.moe, "
            "repro_torch.runtime.steps, repro_torch.models.cnn_layers, "
            "repro_torch.models.branchy, repro_torch.data.synthetic, "
            "repro_torch.optim.adamw, repro_torch.runtime.train_loop, "
            "repro_torch.launch.train, repro_torch.launch.flops, "
            "repro_torch.launch.analytic, repro_torch.launch.mesh, "
            "repro_torch.launch.roofline, repro_torch.launch.dryrun, "
            "repro_torch.launch.report, repro_torch.sharding.specs, "
            "repro_torch.sharding.context\n"
            "from repro_torch.kernels import _build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad, _build._LIBRARY)\n"
            "sys.exit(1 if bad or _build._LIBRARY is not None else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_device_none_means_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_do_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    nw = T.paper_scenario()
    pf = T.paper_profile("h6")
    req = T.AppRequirements(0.5, 5e-3)
    for call in (lambda: T.solve_fin(nw, pf, req),
                 lambda: T.solve_many(pf, nw, req),
                 lambda: T.solve_mcp(nw, pf, req),
                 lambda: T.build_extended_graph(nw, pf, req),
                 lambda: T.fin_all_exit_costs(nw, pf, req),
                 lambda: T.fin_all_exit_costs(nw, pf, req, backend="numpy"),
                 lambda: T.solve_fin(nw, pf, req, backend="python"),
                 lambda: T.Population(nw, pf, req, 4),
                 lambda: T.Population(nw, pf, req, 4, fused_ingest="numpy")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_orchestrator_entry_points_default_to_cuda_and_raise_without_it():
    """``population_cohorts``, ``population_plans``, ``default_solvers``,
    ``PlanCache`` and ``run_multiapp`` build on ``cuda:0`` unless told
    otherwise, and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    for call in (lambda: T.population_cohorts(6),
                 lambda: T.population_plans(6),
                 lambda: T.default_solvers(),
                 lambda: T.PlanCache(),
                 lambda: T.run_multiapp(2)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert all(p.device == torch.device("cpu")
               for p in T.population_cohorts(6, device="cpu"))
    assert all(p.device == torch.device("cpu")
               for p in T.population_plans(2, device="cpu"))


def test_serving_entry_points_default_to_cuda_and_raise_without_it():
    """``SplitServeEngine``, ``init_model``, ``init_caches`` and
    ``launch/serve.py`` run on ``cuda:0`` unless told otherwise, for every
    layer kind, and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT
    from repro_torch.runtime.serve_engine import SplitServeEngine
    cfg = get("qwen3-4b", reduced=True)
    params = TT.init_model(cfg, device="cpu")
    for call in (lambda: SplitServeEngine(cfg, params, batch_size=2,
                                          cache_len=8),
                 lambda: TT.init_model(cfg),
                 lambda: TT.init_caches(cfg, 2, 8),
                 lambda: TT.init_model(get("mamba2-1.3b", reduced=True)),
                 lambda: TT.init_caches(get("jamba-1.5-large-398b",
                                            reduced=True), 2, 8),
                 lambda: serve.main(["--arch", "qwen3-4b"]),
                 lambda: serve.main(["--arch", "mamba2-1.3b"]),
                 lambda: serve.main(["--arch", "mixtral-8x22b"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_transformer_params_from_defaults_to_cuda_and_raises_without_it():
    """``convert.transformer_params_from`` resolves ``device=None`` as every
    entry point does: ``cuda:0``, raising where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from repro_torch.configs import get
    from repro_torch.convert import transformer_params_from
    from repro_torch.models import transformer as TT
    cfg = get("qwen3-4b", reduced=True)
    params_np = _numpy_tree(TT.init_model(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        transformer_params_from(params_np, cfg)
    params = transformer_params_from(params_np, cfg, device="cpu")
    assert params["embed"]["table"].device == torch.device("cpu")


def test_branchy_and_training_entry_points_default_to_cuda():
    """The branchy models' ``init``, ``branchy_params_from``,
    ``init_train_state``, ``train`` and ``launch/train.py`` run on
    ``cuda:0`` unless told otherwise, and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from repro_torch.configs import get
    from repro_torch.convert import branchy_params_from
    from repro_torch.launch import train as launch_train
    from repro_torch.models.branchy import b_lenet
    from repro_torch.runtime.steps import init_train_state
    from repro_torch.runtime.train_loop import train
    cfg = get("qwen3-4b", reduced=True)
    net = b_lenet().init(device="cpu")

    def layer(l):       # the reference's layout: HWIO / [in, out]
        if getattr(l, "w", None) is None:
            return {}
        w = l.w.detach()
        w = w.permute(2, 3, 1, 0) if w.dim() == 4 else w.t()
        return {"w": w.numpy(), "b": l.b.detach().numpy()}

    tree = {"blocks": [[layer(l) for l in blk.layers] for blk in net.blocks],
            "exits": {k: [layer(l) for l in h.layers]
                      for k, h in net.exits.items()}}
    for call in (lambda: b_lenet().init(),
                 lambda: branchy_params_from(net, tree),
                 lambda: init_train_state(cfg),
                 lambda: train(cfg, n_steps=1, global_batch=2, seq_len=4),
                 lambda: launch_train.main(["--arch", "qwen3-4b",
                                            "--steps", "1"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    net.load_state_dict(branchy_params_from(net, tree, device="cpu"))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=where,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and proc.stdout.strip() == ""


def test_mesh_and_failover_default_to_cuda_and_raise_without_it():
    """``population_mesh()`` and ``MeshRelaxer()`` span the visible CUDA
    devices, a ``mesh`` cohort and the plans of ``fin_failover`` live on
    ``cuda:0``; all raise where there is no card, and none falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from repro_torch.runtime.elastic import fin_failover
    from repro_torch.sharding import MeshRelaxer, population_mesh
    nw = T.paper_scenario(n_extra_edge=1)
    pf = T.paper_profile("h2")
    req = T.AppRequirements(0.5, 8e-3)
    for call in (lambda: population_mesh(),
                 lambda: population_mesh(1),
                 lambda: MeshRelaxer(),
                 lambda: T.Population(nw, pf, req, 4, backend="mesh"),
                 lambda: T.population_cohorts(6, backend="mesh"),
                 lambda: fin_failover(T.Plan(nw, pf, req), 1)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    pop = T.Population(nw, pf, req, 4, backend="mesh", device="cpu")
    pop.solve()
    rx = pop._mesh_relaxer
    assert rx.mesh.devices == (torch.device("cpu"),) and not rx.multihost
    assert fin_failover(T.Plan(nw, pf, req, device="cpu"), 1).feasible


def test_no_unported_stubs_remain():
    """The port raises no ``NotImplementedError`` naming a queue item of the
    roadmap (A.2b checkpoints, A4 the mesh) any more."""
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        for tag in ("A.2b", "A4", "A.4"):
            if "NotImplementedError" in text and tag in text:
                offenders.append(f"{path.relative_to(ROOT)}: {tag}")
    assert not offenders, offenders


def test_examples_default_to_cuda_and_raise_without_it():
    """Each example of ``examples_torch/`` runs on ``cuda:0`` unless told
    ``--device``, raising where there is no card; none falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    import importlib.util
    for name in EXAMPLE_NAMES:
        spec = importlib.util.spec_from_file_location(
            f"iso_ex_{name}", EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = ["--small", "--steps", "1"] if name == "train_lm" else []
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main(argv)


def test_dry_run_touches_no_device_and_writes_under_build():
    """The dry run sizes on ``meta`` only; its default output is under
    ``build/`` (ignored by git), never the reference's directory."""
    from repro_torch.launch import dryrun, report
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    from repro_torch.runtime.steps import input_specs
    from repro_torch.configs import SHAPES, get
    assert dryrun.OUT_DIR == ROOT / "build" / "dryrun"
    assert report.DRYRUN_DIR == dryrun.OUT_DIR
    specs = input_specs(get("arctic-480b"), SHAPES["train_4k"])
    leaves = [specs["state"]["opt"].step, specs["batch"]["tokens"],
              specs["state"]["params"]["embed"]["table"]]
    assert all(x.device.type == "meta" for x in leaves)
    with pytest.raises(RuntimeError, match="process group"):
        device_mesh(make_test_mesh(), "cuda")
