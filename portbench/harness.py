"""One run of one cell: set-up, the measured window, the traced sub-window,
the comparison, and the result line.

``run_cell`` returns the result as a dict (``run.py`` prints it).  With
``trace`` off the metrics are the cell's end-to-end ones; with it on, the
per-layer ones, read after a sub-window of ``TRACE_SECONDS`` under
torch.profiler that follows the window.  The window and the sub-window run
the same closed loop; the comparison judges what they served.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import cell as CELL
from . import judge as J
from . import serve as S
from . import trace as TRACE

#: seconds the traced sub-window runs for
TRACE_SECONDS = 2.0
#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What the metric readers read (``e2e/*.py`` and ``metrics/*.py``)."""
    cell: CELL.Cell
    setup_s: float
    window: tuple                       # host clock, start and end
    loop: S.ServeLoop
    batch: int
    trace: Optional[TRACE.Trace] = None
    counters: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, t: float) -> bool:
        return self.window[0] < t <= self.window[1]

    def window_steps(self) -> List[int]:
        """Positions of the steps that ran in the window."""
        lp = self.loop
        return [p for p, t in zip(lp.step_pos, lp.step_t)
                if self.in_window(t)]

    def window_ticks(self):
        return [k for k in self.loop.ticks if self.in_window(k.t1)]

    @staticmethod
    def percentile(values: List[float], q: float) -> float:
        return percentile(values, q)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _counters(eng) -> Dict[str, float]:
    st = eng.stats
    out = {"contingency_hits": st.contingency_hits,
           "contingency_misses": st.contingency_misses}
    if eng.plan is not None:
        out["dp_relaxes"] = eng.plan.stats.dp_relaxes
    return out


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    k = (len(xs) - 1) * q / 100.0
    lo = math.floor(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", t_start: float,
             control: bool = False, fault=None) -> dict:
    """Run ``workload`` once; ``t_start`` is the process's start on the
    host clock (``time.perf_counter``).  With ``control`` the fp8 control
    is judged in the program's place (the run reads not correct where the
    limits part the two).  ``fault`` (``faults.py``) is called with the
    set-up before the warm-up steps to break the path the window times."""
    cell = CELL.load(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    e2e_readers = CELL.readers(cell, "e2e")
    layer_readers = CELL.readers(cell, "metrics") if trace else {}

    setup = S.build(cell, seed, dev, annotate=trace)
    if fault is not None:
        fault(setup)
    loop = setup.loop
    for _ in range(int(cell.mix["warmup_steps"])):     # a tick, too, under churn
        loop.step()
    _sync(dev)
    c0 = _counters(setup.eng)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds:
        loop.step()
    t1 = loop.step_t[-1] if loop.step_t and loop.step_t[-1] > t0 \
        else time.perf_counter()
    c1 = _counters(setup.eng)
    run = Run(cell, setup_s, (t0, t1), loop, int(cell.mix["clients"]))
    run.counters = {k: c1[k] - c0.get(k, 0) for k in c1}
    run.counters["ticks"] = len(run.window_ticks())

    if trace:
        n0 = len(loop.step_pos)
        with torch.profiler.profile(activities=_activities(dev)) as prof:
            ts = time.perf_counter()
            while time.perf_counter() - ts < TRACE_SECONDS:
                loop.step()
            _sync(dev)
        run.trace = TRACE.from_profiler(prof, loop.step_pos[n0:], run.batch)
        del prof

    _check_positions(cell, loop)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    # the program's state goes before the reference runs
    thresholds, params, spec = setup.thresholds, setup.params, cell.spec
    serving = cell.config["serving"]
    smp = J.sample(loop, seed, int(serving["check_tokens"]),
                   int(serving["check_rows"]))
    setup.eng.caches = None
    del setup
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tj = time.perf_counter()
    numbers = J.judge_tokens(spec, params, smp, thresholds, dev,
                             control=control)
    numbers["judge_s"] = time.perf_counter() - tj
    numbers["positions"] = float(loop.step_pos[-1] + 1)
    if cell.churn is not None:
        pl = cell.config["placement"]
        numbers.update(J.judge_placements(
            pl, loop.ticks, float(cell.churn["uplink_bps"]),
            float(pl["hysteresis"]), loop.initial_placement))
    checks = _checks(cell, numbers, control)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    if trace:
        metrics = _read(layer_readers, run, cell.per_layer)
    else:
        metrics = _read(e2e_readers, run, cell.end_to_end)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    result = {"correct": bool(correct),
              "attempted": len(loop.infos),
              "failed": 0,
              "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = run.trace.breakdown()
    extra = {k: v for k, v in numbers.items() if k not in checks}
    if extra:
        result["readings"] = extra
    result["checks"] = checks
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__(f"modules loaded in the run: {found}")
        self.found = found


def _check_positions(cell: CELL.Cell, loop) -> None:
    """Attention without a window needs every position of a row in its
    cache: a ring that wrapped would serve another model than the one the
    reference runs."""
    spec = cell.spec
    cache_len = int(cell.config["serving"]["cache_len"])
    if spec.kind == "moe_attn" and spec.window == 0 and loop.step_pos and \
            loop.step_pos[-1] >= cache_len:
        raise RuntimeError(f"{cell.name}: position {loop.step_pos[-1]} "
                           f"reached the cache's {cache_len} slots")


def _checks(cell: CELL.Cell, numbers: Dict[str, float],
            control: bool = False) -> Dict[str, dict]:
    """Each number compared, beside its limit.  With ``control`` the fp8
    control stands in the program's place: its token and exit numbers are
    the ones compared, under ``control_<name>``."""
    limits = dict(cell.config["limits"])
    served = ["token_gap_mean", "exit_gap_mean"]
    if control:
        out = {f"control_{k}": {"value": numbers[f"control_{k}"],
                                "limit": limits[k]} for k in served}
    else:
        out = {k: {"value": numbers[k], "limit": limits[k]} for k in served}
    if cell.churn is not None:
        out.update({k: {"value": numbers[k], "limit": limits[k]}
                    for k in ("placement_faults", "placement_excess")})
    return out


def _read(readers: dict, run: Run, entries: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in entries:
        v = readers[m["name"]].read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _activities(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
