"""What a run may load and what the benchmark's files may name.

A run of the harness (its CPU mode, in a fresh process) leaves no module
of the top-level names ``jax``, ``jaxlib``, ``flax`` or ``repro`` in
``sys.modules``, compared as whole names (``repro_torch`` is the program
and allowed).  The reference imports nothing of the program, and no file
of the benchmark names the JAX package's benchmarks folder.
"""
import ast
import json
import subprocess
import sys
import textwrap

from portbench import harness
from portbench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(tiny.REPO / 'src')!r}, {str(tiny.REPO)!r}]
        from portbench.tests import tiny
        root = tiny.make_root({str(tmp_path)!r})
        res = tiny.run(root, "tiny.moe.churn", seconds=3.0)
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_harness_refuses_forbidden_modules(monkeypatch):
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" in harness.forbidden_modules()
    assert "repro_torch_like" not in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((tiny.PORTBENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN | {"repro_torch"}, \
                (f, name)


def test_no_benchmark_file_imports_jax_or_names_the_jax_benchmarks():
    for f in tiny.PORTBENCH.rglob("*"):
        if f.suffix not in (".py", ".json", ".sh", ".txt", ".md") or \
                "__pycache__" in f.parts:
            continue
        text = f.read_text()
        assert "benchmarks" + "/" not in text, f
        if f.suffix == ".py":
            for name in _imports(f):
                assert name.split(".")[0] not in FORBIDDEN, (f, name)
