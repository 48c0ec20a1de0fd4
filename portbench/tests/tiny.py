"""A benchmark root at CPU-test sizes, for the folder's tests.

``make_root(tmp)`` copies the benchmark's folder into ``tmp`` and writes a
``BENCHMARK.json`` whose cells run the tiny configurations and mixes of
``data/`` (float32 on the CPU) with the real cells' metrics.
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
REPO = PORTBENCH.parent

CELLS = {
    "tiny.moe.chat": ("tiny-moe", "tiny_chat", "mixtral8p.chat.b128"),
    "tiny.ssm.chat": ("tiny-ssm", "tiny_chat", "mamba2.chat.b256"),
    "tiny.moe.churn": ("tiny-moe", "tiny_churn", "mixtral8p.churn.b128"),
}


def real_bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def make_root(tmp: Path) -> Path:
    """A root in ``tmp`` whose cells are the tiny ones of ``CELLS``, each
    reporting the metrics of the real cell it stands for."""
    root = Path(tmp)
    shutil.copytree(PORTBENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("tiny-moe", "tiny-ssm"):
        shutil.copy(HERE / "data" / f"{name}.json",
                    root / "portbench" / "configs" / f"{name}.json")
    for name in ("tiny_chat", "tiny_churn"):
        shutil.copy(HERE / "data" / f"{name}.json",
                    root / "portbench" / "traffic" / f"{name}.json")
    bench = real_bench()
    stands = {real: tiny for tiny, (_, _, real) in CELLS.items()}
    bench["configs"] = [
        {"name": n, "source": "CPU test", "file": f"portbench/configs/{n}.json",
         "reduced": [], "why": "CPU test size"} for n in ("tiny-moe", "tiny-ssm")]
    bench["workloads"] = [
        {"name": t, "config": c, "traffic": m, "chips": 1, "why": "CPU test"}
        for t, (c, m, _) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [stands[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: Path, workload: str, *, seed: int = 7, seconds: float = 3.0,
        trace: bool = False, **kw) -> dict:
    from portbench import harness
    return harness.run_cell(root, workload, seed, seconds, trace,
                            device="cpu", t_start=time.perf_counter(), **kw)
