"""A benchmark cell as data: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix and the readers of its metrics, all
found by name under the directory that holds ``BENCHMARK.json``."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

from . import traffic as TR
from .reference.lm import ModelSpec


@dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config_name: str
    config: dict
    mix: dict
    end_to_end: List[dict]          # BENCHMARK.json entries this cell reports
    per_layer: List[dict]

    @property
    def spec(self) -> ModelSpec:
        m = dict(self.config["model"])
        m["exits"] = tuple(m["exits"])
        return ModelSpec(**m)

    @property
    def churn(self):
        return self.mix.get("churn")


def _reported(entries: List[dict], cell: str) -> List[dict]:
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def load(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}"
                       f"; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = TR.load(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    return Cell(root=root, name=workload, chips=int(w["chips"]),
                config_name=w["config"], config=config, mix=mix,
                end_to_end=_reported(bench["end_to_end"], workload),
                per_layer=_reported(bench["per_layer"], workload))


def reader(root: Path, kind: str, name: str) -> ModuleType:
    """The reader module of a metric: ``portbench/<kind>/<name>.py``, where
    ``kind`` is ``e2e`` or ``metrics``."""
    folder = Path(root) / "portbench" / kind
    path = folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader in {folder}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readers(cell: Cell, kind: str) -> Dict[str, ModuleType]:
    entries = cell.end_to_end if kind == "e2e" else cell.per_layer
    return {m["name"]: reader(cell.root, kind, m["name"]) for m in entries}
