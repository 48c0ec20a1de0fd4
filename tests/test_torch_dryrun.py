"""The port's dry run and report against the reference's.

* ``run_cell`` on cells of every kind and both production meshes writes
  the reference's cell layout (every key of ``Roofline.to_json`` plus
  ``compile_s``, ``memory_analysis`` and ``tag``; the port adds
  ``memory_scope``), and its roofline fields are ``==`` to the reference's
  ``analyze(..., analytic=analytic_cost(...))`` with the same hardware
  table.
* The pure-DP fallback: a pure-DP cell whose batch the mesh does not
  divide runs as TP + sequence parallelism, as the reference's does.
* ``memory_per_chip_gb`` is the step's argument bytes on one card.
* ``main`` with ``--all`` / ``--skip-existing`` / ``--optimized``.
* ``report``: ``roofline_table`` renders the port's cells and cells of
  the reference's layout built from its ``Roofline.to_json`` exactly as
  the reference's ``roofline_table`` does, and each package's
  ``load_cells`` reads the other's directory.

Nothing is compiled or allocated: everything runs on the CPU in seconds.
"""
import dataclasses
import json
import math

import pytest

import repro.configs as RC
from repro.launch import analytic as RA
from repro.launch import report as RREP
from repro.launch import roofline as RR

from repro_torch.configs import get
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as REP
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.runtime.steps import input_specs

REF_KEYS = set(f.name for f in dataclasses.fields(RR.Roofline)) | {
    "compile_s", "memory_analysis", "tag"}
CELLS = [("qwen3-4b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
         ("jamba-1.5-large-398b", "long_500k"), ("hubert-xlarge",
                                                 "prefill_32k"),
         ("arctic-480b", "prefill_32k")]


def _ref_roofline(arch, shape, multi_pod, optimized):
    """The reference's roofline of the cell (the dry run's pure-DP
    fallback applied), with the port's hardware table and no compiled
    program."""
    cfg = RC.get(arch, optimized=optimized)
    mesh = make_production_mesh(multi_pod=multi_pod)
    sh = RC.SHAPES[shape]
    if cfg.parallelism_mode == "pure_dp" and sh.global_batch % mesh.size:
        cfg = dataclasses.replace(cfg, parallelism_mode="tp",
                                  seq_parallel=True)
    acost = RA.analytic_cost(cfg, sh, mesh.size,
                             dict(zip(mesh.axis_names, mesh.shape)))
    name = "pod2x16x16" if multi_pod else "pod16x16"
    return RR.analyze(arch, shape, name, mesh.size, {}, None, "",
                      RR.model_flops(cfg, sh), HW, analytic=acost).to_json()


@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_equals_the_reference(arch, shape, multi_pod, optimized,
                                       tmp_path):
    tag = "opt" if optimized else ""
    got = D.run_cell(arch, shape, multi_pod, optimized=optimized, tag=tag,
                     out_dir=tmp_path)
    assert set(got) == REF_KEYS | {"memory_scope"}
    assert set(got["memory_analysis"]) == {"argument_gb", "output_gb",
                                           "temp_gb", "alias_gb"}
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    suffix = "__opt" if optimized else ""
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__{mesh}{suffix}"
                          ".json").read_text())
    assert on_disk == json.loads(json.dumps(got))
    want = _ref_roofline(arch, shape, multi_pod, optimized)
    for k, v in want.items():
        if k != "memory_per_chip_gb":
            assert got[k] == v, k
    assert got["chips"] == (512 if multi_pod else 256)
    assert got["memory_per_chip_gb"] == \
        got["memory_analysis"]["argument_gb"] > 0
    assert got["tag"] == tag and "arguments only" in got["memory_scope"]


def test_pure_dp_fallback(tmp_path):
    """qwen3-4b's optimized prefill (B = 32 on 256 cards) falls back to TP
    with sequence parallelism; its train cell (B = 256) stays pure DP."""
    assert get("qwen3-4b", optimized=True).parallelism_mode == "pure_dp"
    for shape, fallback in (("prefill_32k", True), ("train_4k", False)):
        got = D.run_cell("qwen3-4b", shape, False, optimized=True,
                         out_dir=tmp_path)
        want = _ref_roofline("qwen3-4b", shape, False, True)
        assert got["wire_bytes_per_chip"] == want["wire_bytes_per_chip"]
        pure = RA.analytic_cost(RC.get("qwen3-4b", optimized=True),
                                RC.SHAPES[shape], 256,
                                {"data": 16, "model": 16})
        assert (got["wire_bytes_per_chip"] != pure.wire_bytes) == fallback


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for v in tree for x in _tensors(v)]
    return [tree]


def test_memory_is_the_arguments_split_by_their_specs(tmp_path):
    """On one mesh: every leaf's bytes over its spec's shard count; the
    sum over cards exceeds the arguments' bytes (a TP cell replicates its
    norms) and one card holds less than all of them."""
    mesh = make_production_mesh()
    cfg = get("phi3-medium-14b")
    shape = RC.SHAPES["decode_32k"]
    got = D.run_cell("phi3-medium-14b", "decode_32k", False,
                     out_dir=tmp_path)
    specs = input_specs(cfg, shape)
    total = sum(x.numel() * x.element_size() for x in _tensors(specs))
    per_card = got["memory_per_chip_gb"] * 1e9
    assert total < per_card * mesh.size
    assert per_card < total
    assert math.isclose(per_card, D.argument_bytes(
        specs, D.shardings_for(cfg, mesh, shape, specs), mesh))


def test_main_writes_every_cell_and_skips_existing(tmp_path, capsys):
    assert D.main(["--all", "--out", str(tmp_path)]) == 0
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == len(RC.all_cells())
    assert D.main(["--all", "--optimized", "--multi-pod", "--out",
                   str(tmp_path)]) == 0
    assert len(sorted(tmp_path.glob("*__opt.json"))) == len(RC.all_cells())
    capsys.readouterr()
    assert D.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                   "--skip-existing", "--out", str(tmp_path)]) == 0
    assert "skip qwen3-4b train_4k pod16x16" in capsys.readouterr().out
    assert D.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                   "--out", str(tmp_path)]) == 1


def test_report_renders_both_layouts_as_the_reference(tmp_path, capsys,
                                                      monkeypatch):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    ref_dir.mkdir()
    for arch, shape in CELLS:
        for mp in (False, True):
            D.run_cell(arch, shape, mp, out_dir=port_dir)
            d = _ref_roofline(arch, shape, mp, False)
            d.update(tag="", compile_s=0.0)
            (ref_dir / f"{arch}__{shape}__{d['mesh']}.json").write_text(
                json.dumps(d))
    for where in (port_dir, ref_dir):
        for mesh in ("pod16x16", "pod2x16x16", None):
            cells = REP.load_cells(mesh, directory=where)
            assert len(cells) == len(CELLS) * (2 if mesh is None else 1)
            monkeypatch.setattr(RREP, "DRYRUN_DIR", where)
            ref_cells = RREP.load_cells(mesh)
            assert [c["arch"] for c in cells] == \
                [c["arch"] for c in ref_cells]
            assert REP.roofline_table(cells) == \
                RREP.roofline_table(ref_cells)
    port_table = REP.roofline_table(REP.load_cells("pod16x16",
                                                   directory=port_dir))
    ref_table = REP.roofline_table(REP.load_cells("pod16x16",
                                                  directory=ref_dir))
    # the same roofline; only the memory column (arguments vs none) differs
    drop = lambda t: [r.rsplit("|", 3)[0] for r in t.splitlines()]
    assert drop(port_table) == drop(ref_table)
    REP.main(["--dir", str(port_dir), "--mesh", "pod2x16x16"])
    out = capsys.readouterr().out
    assert out.startswith("| arch | shape |")
    assert f"{len(CELLS)} cells; bottleneck mix" in out


@pytest.mark.parametrize("x", [0, 3e-7, 2.5e-4, 0.04, 1.0, 12.345])
def test_fmt_s_equals_the_reference(x):
    assert REP.fmt_s(x) == RREP.fmt_s(x)
    assert REP.SHAPE_ORDER == RREP.SHAPE_ORDER
