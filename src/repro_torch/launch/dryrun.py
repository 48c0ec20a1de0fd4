"""Multi-pod dry run: every (arch x shape x mesh) cell, sized without
allocation and costed by the analytic model.

Port of ``repro/launch/dryrun.py``.  For each cell this:
  1. takes the production mesh description ((16,16) single-pod or
     (2,16,16) multi-pod, ``launch/mesh.py``),
  2. builds the step function and its inputs as ``meta`` tensors
     (``runtime.steps.input_specs``: nothing is drawn or allocated, so the
     480B-parameter models size on any host),
  3. gives every input its sharding spec (``sharding/specs.py``),
  4. costs the step with ``launch/analytic.py`` and derives the roofline
     terms (``launch/roofline.analyze`` with the H100 table ``mesh.HW``),
  5. writes the reference's cell layout to
     ``<out_dir>/<arch>__<shape>__<mesh>[__<tag>].json`` (default
     ``build/dryrun/`` under the repository root).

Nothing is compiled.  ``memory_per_chip_gb`` is the bytes of the step's
inputs on one card: each input's bytes divided by its spec's shard count on
the mesh.  It counts arguments only (``memory_scope`` says so), where the
reference's compiled figure adds the compiler's temporaries and outputs.
``compile_s`` keeps the reference's key and holds the seconds the cell
took.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--optimized]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import NamedTuple, Optional, Sequence

from ..configs import SHAPES, all_cells, get
from ..runtime.steps import input_specs, step_for
from ..sharding.specs import (_dp_if_divisible, _spec, batch_shardings,
                              caches_shardings, distribute_tree,
                              params_shardings, scalar_sharding, shard_count)
from .analytic import analytic_cost
from .mesh import HW, make_production_mesh
from .roofline import analyze, model_flops

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

MEMORY_SCOPE = ("arguments only: the step's inputs (parameters, optimizer "
                "state, caches, batch), each split by its spec's shard "
                "count; no outputs, activations or temporaries")


class MemoryStats(NamedTuple):
    """Per-card bytes in the fields ``roofline.analyze`` reads from a
    compiled program's memory analysis; the port fills the arguments."""
    argument_size_in_bytes: float
    output_size_in_bytes: float = 0.0
    temp_size_in_bytes: float = 0.0
    alias_size_in_bytes: float = 0.0


def shardings_for(cfg, mesh, shape, specs):
    """A tree of specs matching ``input_specs(cfg, shape)``."""
    out = {}
    if "state" in specs:
        opt = specs["state"]["opt"]
        out["state"] = {
            "params": params_shardings(cfg, mesh, specs["state"]["params"]),
            "opt": type(opt)(step=scalar_sharding(mesh),
                             mu=params_shardings(cfg, mesh, opt.mu),
                             nu=params_shardings(cfg, mesh, opt.nu)),
        }
    if "params" in specs:
        out["params"] = params_shardings(cfg, mesh, specs["params"])
    if "batch" in specs:
        out["batch"] = batch_shardings(cfg, mesh, specs["batch"])
    if "caches" in specs:
        out["caches"] = caches_shardings(cfg, mesh, specs["caches"])
    if "tokens" in specs:
        out["tokens"] = _spec(
            _dp_if_divisible(mesh, specs["tokens"].shape[0]), None)
    if "pos" in specs:
        out["pos"] = scalar_sharding(mesh)
    return out


def place_inputs(cfg, shape, args: dict, device_mesh) -> dict:
    """A step's arguments (``args``, keyed by argument name as
    ``input_specs(cfg, shape)``) placed on ``device_mesh`` by their specs
    (``shardings_for``): every tensor becomes a DTensor, and the decode
    position ``pos`` stays a Python int.  The port's ``jit(step,
    in_shardings=...)``: call the step on the result under
    ``activation_sharding(device_mesh)``."""
    tensors = {k: v for k, v in args.items() if k != "pos"}
    out = distribute_tree(tensors, shardings_for(cfg, device_mesh, shape,
                                                 tensors), device_mesh)
    if "pos" in args:
        out["pos"] = args["pos"]
    return out


def _leaves(tree, specs):
    """(tensor, spec) pairs of a tree of meta tensors and its specs."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs[k])
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), getattr(specs, k))
    else:
        yield tree, specs


def argument_bytes(args, shards, mesh) -> float:
    """Bytes of ``args`` on one card of ``mesh``, each leaf split by its
    spec's shard count."""
    return sum(x.numel() * x.element_size() / shard_count(spec, mesh)
               for x, spec in _leaves(args, shards))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             *, cfg_overrides: dict = None, tag: str = "",
             optimized: bool = False,
             out_dir: Optional[pathlib.Path] = None) -> dict:
    t0 = time.time()
    cfg = get(arch, optimized=optimized)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    if (cfg.parallelism_mode == "pure_dp"
            and shape.global_batch % mesh.size):
        # pure DP requires batch >= cards; fall back to TP + sequence
        # parallelism for small-batch cells (prefill/decode of small models)
        cfg = dataclasses.replace(cfg, parallelism_mode="tp",
                                  seq_parallel=True)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = mesh.size

    _, argnames = step_for(cfg, shape)
    specs = input_specs(cfg, shape)
    in_shards = shardings_for(cfg, mesh, shape, specs)
    args = {a: specs[a] for a in argnames}
    mem = MemoryStats(argument_bytes(args, {a: in_shards[a]
                                            for a in argnames}, mesh))

    acost = analytic_cost(cfg, shape, chips,
                          dict(zip(mesh.axis_names, mesh.shape)))
    rl = analyze(arch, shape_name, mesh_name, chips, {}, mem, "",
                 model_flops(cfg, shape), HW, analytic=acost)
    result = rl.to_json()
    result.update(
        compile_s=time.time() - t0,
        memory_analysis=dict(
            argument_gb=mem.argument_size_in_bytes / 1e9,
            output_gb=mem.output_size_in_bytes / 1e9,
            temp_gb=mem.temp_size_in_bytes / 1e9,
            alias_gb=mem.alias_size_in_bytes / 1e9,
        ),
        memory_scope=MEMORY_SCOPE,
        tag=tag,
    )
    out_dir = pathlib.Path(out_dir) if out_dir is not None else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(result, indent=1))
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell sequentially")
    ap.add_argument("--optimized", action="store_true",
                    help="apply configs.registry.OPTIMIZED_OVERRIDES "
                         "(results tagged 'opt')")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help=f"output directory (default {OUT_DIR})")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, args.multi_pod) for a, s in all_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    out_dir = pathlib.Path(args.out)
    failed = []
    tag = "opt" if args.optimized else ""
    for arch, shape, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        suffix = f"__{tag}" if tag else ""
        out = out_dir / f"{arch}__{shape}__{mesh_name}{suffix}.json"
        if args.skip_existing and out.exists():
            print(f"skip {arch} {shape} {mesh_name}")
            continue
        try:
            r = run_cell(arch, shape, mp, optimized=args.optimized, tag=tag,
                         out_dir=out_dir)
            print(f"OK {arch} {shape} {mesh_name}: "
                  f"flops/card={r['flops_per_chip']:.3e} "
                  f"bytes/card={r['bytes_per_chip']:.3e} "
                  f"wire/card={r['wire_bytes_per_chip']:.3e} "
                  f"bottleneck={r['bottleneck']} "
                  f"args={r['memory_per_chip_gb']:.2f}GB "
                  f"({r['compile_s']:.2f}s)")
        except Exception as e:
            failed.append((arch, shape, mesh_name))
            print(f"FAIL {arch} {shape} {mesh_name}: {e}")
            traceback.print_exc()
        sys.stdout.flush()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
