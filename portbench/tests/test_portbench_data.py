"""The benchmark is driven by data.

A new configuration, traffic mix and per-layer metric, each under a fresh
name, are dropped into a copy of the folders with their entries in
``BENCHMARK.json``: the harness runs the new cell and reports the new
metric, and no file that was there changes.  The real ``BENCHMARK.json``
keeps to the contract's shape, and every per-layer metric's ``moves``
names an end-to-end metric of every cell that reports it.
"""
import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import cell as CELL
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _digests(root / "portbench")
    conf = json.loads((root / "portbench/configs/tiny-ssm.json").read_text())
    conf.update(name="tiny-ssm-deep", n_layer=9)
    conf["model"] = dict(conf["model"], n_layers=9, exits=[3, 6])
    (root / "portbench/configs/tiny-ssm-deep.json").write_text(
        json.dumps(conf))
    mix = json.loads((root / "portbench/traffic/tiny_chat.json").read_text())
    mix.update(clients=3)
    (root / "portbench/traffic/tiny_three.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/steps_in_window.py").write_text(
        '"""Decode steps in the window."""\n'
        'LAYER = "serve engine"\nUNIT = "count"\nBETTER = "higher"\n'
        'SOURCE = "program_counter"\nMOVES = "out_tokens_per_s"\n\n\n'
        'def read(run):\n    return len(run.window_steps())\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": "tiny-ssm-deep", "source": "CPU test", "reduced": [],
         "file": "portbench/configs/tiny-ssm-deep.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.deep.three",
                               "config": "tiny-ssm-deep",
                               "traffic": "tiny_three", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny.ssm.chat" in m["workloads"]:
            m["workloads"].append("tiny.deep.three")
    bench["per_layer"].append(
        {"name": "steps_in_window", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "serve engine",
         "moves": "out_tokens_per_s", "workloads": ["tiny.deep.three"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = tiny.run(root, "tiny.deep.three", trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["steps_in_window"]["value"] > 0
    assert res["attempted"] >= 3
    after = _digests(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def _bench():
    return tiny.real_bench()


def test_benchmark_json_keeps_the_contracts_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"][1].startswith("portbench/")
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    for n in names:
        assert NAME.match(n), n
    assert len({x["name"] for x in b["workloads"]}) == len(b["workloads"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        assert (tiny.REPO / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in b["workloads"])
        conf = json.loads((tiny.REPO / c["file"]).read_text())
        assert set(c["reduced"]) == set(conf["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (tiny.PORTBENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])


@pytest.mark.parametrize("kind", ["e2e", "metrics"])
def test_every_metric_has_a_reader_that_agrees(kind):
    b = _bench()
    entries = b["end_to_end"] if kind == "e2e" else b["per_layer"]
    for m in entries:
        r = CELL.reader(tiny.REPO, kind, m["name"])
        assert (r.UNIT, r.BETTER, r.SOURCE) == (m["unit"], m["better"],
                                                m["source"]), m["name"]
        if kind == "metrics":
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"]), m["name"]


def test_every_moves_is_reported_where_the_metric_is():
    b = _bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m
        assert "workloads" in m, m
        assert set(m["workloads"]) <= e2e[m["moves"]], m
    for w in cells:
        reported = [m for m in b["end_to_end"] if w in m.get("workloads",
                                                             cells)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])


def test_a_copy_without_the_program_refuses_to_run(tmp_path):
    shutil.copytree(tiny.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mixtral8p.chat.b128", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
