"""Render roofline tables from a directory of dry-run cells.

Port of ``repro/launch/report.py``.  It reads the reference's cell layout,
so the cells of either package's dry run render alike.

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [--mesh pod16x16]
            [--tag opt] [--dir build/dryrun]
Emits a GitHub-markdown table sorted by (arch, shape); baseline rows are the
untagged cells, variants carry their tag.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional, Sequence

from .dryrun import OUT_DIR

DRYRUN_DIR = OUT_DIR
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(mesh: str = None, tag_filter=None,
               directory: Optional[pathlib.Path] = None) -> List[dict]:
    """The cells in ``directory`` (default ``DRYRUN_DIR``) on ``mesh`` with
    tag ``tag_filter`` (any, when None)."""
    cells = []
    root = pathlib.Path(directory) if directory is not None else DRYRUN_DIR
    for p in sorted(root.glob("*.json")):
        d = json.loads(p.read_text())
        if mesh and d["mesh"] != mesh:
            continue
        tag = d.get("tag", "")
        if tag_filter is not None and tag != tag_filter:
            continue
        cells.append(d)
    cells.sort(key=lambda d: (d["arch"],
                              SHAPE_ORDER.index(d["shape"])
                              if d["shape"] in SHAPE_ORDER else 9,
                              d.get("tag", "")))
    return cells


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(cells: List[dict]) -> str:
    hdr = ("| arch | shape | tag | t_comp | t_mem | t_coll | bottleneck | "
           "MODEL/impl FLOPs | mem/chip | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for d in cells:
        dom = max(d["t_compute"], d["t_memory"], d["t_collective"])
        frac = d["t_compute"] / dom if dom > 0 else 0.0
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d.get('tag','') or 'base'} | "
            f"{fmt_s(d['t_compute'])} | {fmt_s(d['t_memory'])} | "
            f"{fmt_s(d['t_collective'])} | {d['bottleneck']} | "
            f"{d['useful_flops_ratio']:.2f} | "
            f"{d['memory_per_chip_gb']:.1f}GB | {frac:.2f} |")
    return "\n".join(rows)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--dir", default=str(DRYRUN_DIR),
                    help=f"directory of cells (default {DRYRUN_DIR})")
    args = ap.parse_args(argv)
    cells = load_cells(args.mesh, args.tag, directory=args.dir)
    print(roofline_table(cells))
    n_bottleneck: Dict[str, int] = {}
    for d in cells:
        n_bottleneck[d["bottleneck"]] = n_bottleneck.get(d["bottleneck"], 0) + 1
    print(f"\n{len(cells)} cells; bottleneck mix: {n_bottleneck}")


if __name__ == "__main__":
    main()
