"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the directory that holds ``BENCHMARK.json``.  Needs a CUDA card
(and as many as the cell asks for); without one it exits with code 2 and
prints no result.  The last line of standard output is the result, one
JSON object; the last lines of standard error give each number compared
beside its limit.

Two options serve the limits' readings, not the benchmark's runs:
``--control 1`` judges the fp8 control in the program's place on the same
streams (the program's own numbers are then readings), and ``--fault
<name>`` plants one of ``portbench/faults.py``'s faults under the timed
path.  With either, ``--seed`` may list several seeds, run one after
another in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches inside the checkout, and no JAX behind a library's back."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seed.split(",")]
    if len(seeds) > 1 and not (args.control or args.fault):
        ap.error("several seeds are for --control and --fault readings only")
    _environment()

    import repro_torch  # noqa: F401  (the program under test)
    import torch
    from portbench import cell as CELL
    from portbench import faults as FAULTS
    from portbench import harness as H

    if args.fault and args.fault not in FAULTS.FAULTS:
        ap.error(f"--fault takes one of {sorted(FAULTS.FAULTS)}")
    fault = FAULTS.FAULTS.get(args.fault)

    chips = CELL.load(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 2
    t_start = T_START
    for seed in seeds:
        try:
            res = H.run_cell(ROOT, args.workload, seed, args.seconds,
                             bool(args.trace), device="cuda",
                             t_start=t_start, control=bool(args.control),
                             fault=fault)
        except H.ForbiddenImport as exc:
            print(f"portbench: forbidden modules loaded in the run: "
                  f"{exc.found}", file=sys.stderr)
            return 3
        res["device"]["power"] = _power_limit()
        for name, c in res["checks"].items():
            print(f"check {name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(res), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
