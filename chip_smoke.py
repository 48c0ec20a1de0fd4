"""Drive the PyTorch port of the FIN placement solver on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written banded (min,+) kernel from ``src/repro_torch``,
holds it bit-equal to its plain PyTorch version on the card, checks graph
construction and the solver on CUDA against the port's CPU path, drives
``solve_many`` over the full-width 15,360-scenario grid (the main path,
with the kernels' launch counters reset just before it), relaxes 2^20
scenario rows at population size, and prints the kernels JSON line
followed by the final status line.  Every failing phase raises; without a
CUDA card, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): device memory
#: rate and the non-tensor-core float64 / float32 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}

KERNEL_SOURCE = "src/repro_torch/kernels/minplus/csrc/banded_minplus.cu"
CARD_SHAPES = [(1, 1, 4, 4), (64, 4, 5, 26), (8, 2, 23, 26), (4, 4, 8, 131)]
APPS = ("h1", "h2", "h3", "h4", "h5", "h6")
GAMMA = 25
POP_ROWS = 1 << 20
POP_CHECK_ROWS = 65536


class PhaseFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _preflight():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA card only", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        sys.exit(3)
    sys.path.insert(0, str(ROOT / "src"))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def chain_bound(dist, Ek, st, lo):
    """(bound_ms, bound_by, bytes, ops) of one chain relaxation: each input
    byte read once, each output byte written once, and one add plus one
    compare per admissible candidate of this data."""
    import torch
    B, N, Gp1 = dist.shape
    L = Ek.shape[1]
    item = dist.element_size()
    nbytes = (dist.numel() * item + Ek.numel() * item + st.numel() * 4
              + B * L * N * Gp1 * (item + 4))
    g = torch.arange(Gp1, device=st.device)
    ok = (g >= st[..., None]) & torch.isfinite(Ek)[..., None]
    if lo is not None:
        ok &= (g >= lo) | (st[..., None] == 0)
    ops = 2 * int(ok.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[str(dist.dtype).replace("torch.", "")]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def max_abs_err(a, b) -> float:
    """Largest |a - b| over finite entries; inf where finiteness differs."""
    import torch
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return math.inf
    if not bool(fa.any()):
        return 0.0
    return float((a[fa].double() - b[fb].double()).abs().max())


def random_problem(B, L, N, Gp1, seed, dtype, device):
    import numpy as np
    import torch
    from repro_torch.core.bellman_ford import kernel_inputs
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, N, Gp1))
    dist[rng.uniform(size=dist.shape) < 0.5] = np.inf
    E = rng.uniform(0, 5, (B, L, N, N))
    steep = rng.integers(0, Gp1, (B, L, N, N)).astype(np.float64)
    steep[rng.uniform(size=steep.shape) < 0.3] = np.inf
    if N > 1:                        # a duplicated source node: ties
        E[:, :, 1], steep[:, :, 1], dist[:, 1] = E[:, :, 0], steep[:, :, 0], \
            dist[:, 0]
    Ek, st = kernel_inputs(torch.as_tensor(E, device=device),
                           torch.as_tensor(steep, device=device), dtype)
    return torch.as_tensor(dist, device=device).to(dtype), Ek, st


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_profile(grid, dev, wall_s):
    """Where solve_many's time goes: host functions by cumulative time
    (cProfile), then the device's busy time (torch.profiler).  The profiler
    slows the host, so the busy share is given against both the profiled
    wall and ``wall_s``, the same call's wall without a profiler."""
    import cProfile
    import io
    import pstats
    import torch
    from torch.autograd import DeviceType
    import repro_torch as T
    ps, ns, rs = grid
    prof = cProfile.Profile()
    prof.enable()
    T.solve_many(ps, ns, rs, gamma=GAMMA, device=dev)
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(14)
    for line in out.getvalue().splitlines():
        if line.strip():
            log("profile", line.rstrip())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as tp:
        T.solve_many(ps, ns, rs, gamma=GAMMA, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device-side events only: a host op's device time repeats its kernels'
    events = [e for e in tp.key_averages() if e.device_type != DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        log("profile", "device busy share: not measured (the profiler saw no "
            "device time)")
        return
    log("profile", f"solve_many minplus: device busy {busy:.4f} s; wall "
        f"{wall:.3f} s under torch.profiler ({busy / wall:.2%} busy), "
        f"{wall_s:.3f} s without it ({busy / wall_s:.2%} busy)")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        log("profile", f"device {e.key[:90]}: "
            f"{e.self_device_time_total / 1e3:.3f} ms over {e.count} calls")


def phase_environment():
    import torch
    from repro_torch.kernels.minplus._build import load_library
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = load_library()
    log("env", f"kernel library {lib.path.name}: nvcc {lib.build_seconds:.3f} s"
        f" (load {time.perf_counter() - t0:.3f} s)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("env", line.strip())


def phase_kernels(dev):
    """B1 and B1u vs their plain versions on the card, both dtypes."""
    import torch
    from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                                 banded_minplus_chain)
    from repro_torch.kernels.minplus.ref import (banded_minplus_chain_ref,
                                                 banded_minplus_ref)
    err = {"chain": 0.0, "layer": 0.0}
    banded_minplus_chain.launches = banded_minplus_argmin.launches = 0
    for B, L, N, Gp1 in CARD_SHAPES:
        for dtype in (torch.float64, torch.float32):
            for lo in (None, 2):
                d, Ek, st = random_problem(B, L, N, Gp1, B + L + N + Gp1,
                                           dtype, dev)
                hist, par = banded_minplus_chain(d, Ek, st, lo=lo)
                hist_p, par_p = banded_minplus_chain_ref(d, Ek, st, lo=lo)
                out, arg = banded_minplus_argmin(d[0], Ek[0, 0], st[0, 0],
                                                 lo=lo)
                out_p, arg_p = banded_minplus_ref(d[0], Ek[0, 0], st[0, 0],
                                                  lo=lo)
                torch.cuda.synchronize()
                tag = f"B1 {(B, L, N, Gp1)} {dtype} lo={lo}"
                check(torch.equal(hist, hist_p) and torch.equal(par, par_p),
                      f"{tag}: kernel differs from the plain version")
                check(torch.equal(out, out_p) and torch.equal(arg, arg_p),
                      f"B1u {tag[3:]}: kernel differs from the plain version")
                check(torch.equal(out, hist[0, 0]),
                      f"B1u {tag[3:]}: differs from one layer of B1")
                err["chain"] = max(err["chain"], max_abs_err(hist, hist_p))
                err["layer"] = max(err["layer"], max_abs_err(out, out_p))
                log("kernels", f"{tag}: bit-equal (reached "
                    f"{int((par >= 0).sum())} of {par.numel()} states)")
    log("kernels", f"B1 banded_minplus_chain: {banded_minplus_chain.launches} "
        f"launches, bit-equal, max_abs_err {err['chain']} | B1u "
        f"banded_minplus_argmin: {banded_minplus_argmin.launches} launches, "
        f"bit-equal, max_abs_err {err['layer']}")
    return err


def full_grid():
    import numpy as np
    from repro_torch.core.scenarios import sweep_scenarios
    return sweep_scenarios(apps=APPS, deltas_ms=tuple(np.linspace(1, 20, 40)),
                           uplinks_bps=tuple(np.linspace(0.2e9, 2e9, 64)),
                           n_extra_edge=2)


def grid_tensors(grid, device, quantize="floor"):
    """Per shape group (E, steep, init) of the grid's feasible graphs."""
    from repro_torch.core.extended_graph import build_extended_graphs
    from repro_torch.core.feasible_graph import (batch_banded_tensors,
                                                 build_feasible_graphs)
    ps, ns, rs = grid
    fgs = build_feasible_graphs(build_extended_graphs(ns, ps, rs,
                                                      device=device),
                                GAMMA, quantize=quantize)
    groups = {}
    for fg in fgs:
        groups.setdefault(fg.ext.n_blocks, []).append(fg)
    return {L: batch_banded_tensors(g) for L, g in sorted(groups.items())}


def phase_graphs(grid, dev):
    for q in ("floor", "ceil", "round"):
        gpu = grid_tensors(grid, dev, q)
        cpu = grid_tensors(grid, "cpu", q)
        for L in gpu:
            for name, a, b in zip(("E", "steep", "init"), gpu[L], cpu[L]):
                a = a.cpu().numpy()
                b = b.numpy()
                check(a.dtype == b.dtype and a.shape == b.shape
                      and a.tobytes() == b.tobytes(),
                      f"graph {q} L={L} {name}: CUDA bytes differ from CPU")
            log("graphs", f"quantize={q} blocks={L}: E {tuple(gpu[L][0].shape)}"
                f", steep, init {tuple(gpu[L][2].shape)} byte-equal CUDA vs CPU")


EVAL_FIELDS = ("energy", "energy_comp", "energy_comm", "latency", "accuracy",
               "feasible", "violations")
META_KEYS = ("tighten_rounds", "used_ceil_pass", "delta_eff")


def same_solution(a, b) -> bool:
    if a.found != b.found:
        return False
    if any(a.meta.get(k) != b.meta.get(k) for k in META_KEYS):
        return False
    if not a.found:
        return a.meta.get("reason") == b.meta.get("reason")
    return (a.config.placement == b.config.placement
            and a.config.final_exit == b.config.final_exit
            and all(getattr(a.eval, f) == getattr(b.eval, f)
                    for f in EVAL_FIELDS))


def phase_solve_fin(dev):
    import repro_torch as T
    n = n_opt = 0
    for extra in (0, 2):
        nw = T.paper_scenario(n_extra_edge=extra)
        for app in APPS:
            pf = T.paper_profile(app)
            alpha = min(e.accuracy for e in pf.exits)
            for gamma in (3, 10, 25):
                for delta in (2e-3, 5e-3, 12e-3):
                    req = T.AppRequirements(alpha, delta)
                    got = T.solve_fin(nw, pf, req, gamma=gamma, device=dev)
                    want = T.solve_fin(nw, pf, req, gamma=gamma, device="cpu")
                    check(same_solution(got, want),
                          f"solve_fin {app} extra={extra} gamma={gamma} "
                          f"delta={delta}: CUDA differs from CPU")
                    n += 1
                    if extra == 0 and gamma == 25 and got.found:
                        opt = T.solve_opt(nw, pf, req)
                        check(got.feasible and got.energy >=
                              opt.energy * (1 - 1e-12),
                              f"solve_fin {app} delta={delta}: infeasible or "
                              f"below the exhaustive optimum")
                        n_opt += got.energy == opt.energy
    log("solve_fin", f"{n} solves on CUDA equal the CPU path (config, every "
        f"ConfigEval field, tighten_rounds/used_ceil_pass/delta_eff); at "
        f"gamma=25 FIN equals exhaustive Opt in {n_opt} of 18 cases")


def phase_solve_many(grid, dev, counters):
    """The main path: solve_many over the full-width grid on the card."""
    import torch
    import repro_torch as T
    from repro_torch.core.tolerances import DIST_RTOL_F32
    ps, ns, rs = grid
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols = T.solve_many(ps, ns, rs, gamma=GAMMA, device=dev)
    torch.cuda.synchronize()
    wall_f64 = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    log("solve_many", f"{len(ps)} scenarios gamma={GAMMA} minplus on CUDA: "
        f"{wall_f64:.3f} s, kernel launches {launches}")
    check(launches["banded_minplus_chain"] > 0,
          "solve_many did not launch the chain kernel")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sols32 = T.solve_many(ps, ns, rs, gamma=GAMMA, backend="f32", device=dev)
    torch.cuda.synchronize()
    wall_f32 = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu = T.solve_many(ps, ns, rs, gamma=GAMMA, device="cpu")
    wall_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu32 = T.solve_many(ps, ns, rs, gamma=GAMMA, backend="f32", device="cpu")
    wall_cpu32 = time.perf_counter() - t0

    check(all(same_solution(a, b) for a, b in zip(sols, cpu)),
          "solve_many minplus: CUDA differs from the CPU path")
    check(all(same_solution(a, b) for a, b in zip(sols32, cpu32)),
          "solve_many f32: CUDA differs from the CPU path")
    found = sum(s.found for s in sols)
    check(found > 0 and all(math.isfinite(s.energy) and s.feasible
                            for s in sols if s.found),
          "solve_many: a found solution is not finite and feasible")
    check([s.found for s in sols32] == [s.found for s in sols],
          "f32 finds a different set of scenarios than minplus")
    worst = max((abs(a.energy - b.energy) / b.energy
                 for a, b in zip(sols32, sols) if b.found), default=0.0)
    check(worst <= DIST_RTOL_F32,
          f"f32 energy off by {worst:.3g} relative (> {DIST_RTOL_F32})")
    diff = sum(a.found and (a.config.placement != b.config.placement
                            or a.config.final_exit != b.config.final_exit)
               for a, b in zip(sols32, sols))
    log("solve_many", f"minplus CUDA == CPU on all {len(ps)} ({found} found); "
        f"f32 energies within {worst:.3g} relative of minplus, {diff} "
        f"placements differ")
    log("solve_many", f"wall s (host clock, ending in synchronize): "
        f"minplus cuda {wall_f64:.3f} cpu {wall_cpu:.3f} | f32 cuda "
        f"{wall_f32:.3f} cpu {wall_cpu32:.3f}")
    return launches, wall_f64


def phase_kernel_times(grid, dev, err):
    """Kernel, plain and bound at the main path's largest launch: round 0's
    five-block group (floor and ceil graphs of h1-h4) in float64.  Returns
    the kernels-line rows of the path's kernels."""
    import torch
    from repro_torch.core.bellman_ford import kernel_inputs
    from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                                 banded_minplus_chain)
    from repro_torch.kernels.minplus.ref import (banded_minplus_chain_ref,
                                                 banded_minplus_ref)
    parts = [grid_tensors(grid, dev, q)[5] for q in ("floor", "ceil")]
    E = torch.cat([p[0] for p in parts])
    steep = torch.cat([p[1] for p in parts])
    init = torch.cat([p[2] for p in parts]).contiguous()
    Ek, st = kernel_inputs(E, steep, torch.float64)
    rows = []
    ms = cuda_ms(lambda: banded_minplus_chain(init, Ek, st), 20)
    plain = cuda_ms(lambda: banded_minplus_chain_ref(init, Ek, st), 3, 1)
    bound, by, nbytes, ops = chain_bound(init, Ek, st, None)
    log("times", f"B1 f64 {tuple(init.shape)} L={Ek.shape[1]}: kernel {ms:.4f}"
        f" ms, plain {plain:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes} B, {ops} ops)")
    rows.append(dict(name="banded_minplus_chain", route="cuda",
                     source=KERNEL_SOURCE,
                     replaces="src/repro/kernels/minplus/minplus.py:329",
                     launches=None, max_abs_err=err["chain"], ms=ms,
                     plain_ms=plain, bound_ms=bound, bound_by=by,
                     library_ms=None))
    d1, E1, s1 = init[0].contiguous(), Ek[0, 0].contiguous(), \
        st[0, 0].contiguous()
    ms1 = cuda_ms(lambda: banded_minplus_argmin(d1, E1, s1), 200, 5)
    plain1 = cuda_ms(lambda: banded_minplus_ref(d1, E1, s1), 50, 2)
    bound1, by1, _, _ = chain_bound(d1[None], E1[None, None],
                                    s1[None, None], None)
    # B1u is off the solver's path, so it has no row in the kernels line
    log("times", f"B1u f64 {tuple(d1.shape)}: kernel {ms1:.4f} ms, plain "
        f"{plain1:.4f} ms, bound {bound1:.9f} ms by {by1}")
    # the f32 instantiation at the same shape, for the record
    Ek32, init32 = Ek.float(), init.float()
    ms32 = cuda_ms(lambda: banded_minplus_chain(init32, Ek32, st), 20)
    bound32, by32, _, _ = chain_bound(init32, Ek32, st, None)
    log("times", f"B1 f32 {tuple(init.shape)}: kernel {ms32:.4f} ms, bound "
        f"{bound32:.4f} ms by {by32}")
    return rows


def phase_population(grid, dev):
    """h1-h4 banded tensors tiled to 2^20 rows, relaxed in one launch."""
    import torch
    from repro_torch.core.bellman_ford import kernel_inputs
    from repro_torch.kernels.minplus.ops import banded_minplus_chain
    from repro_torch.kernels.minplus.ref import banded_minplus_chain_ref
    E, steep, init = grid_tensors(grid, dev)[5]
    reps = -(-POP_ROWS // E.shape[0])
    for dtype in (torch.float64, torch.float32):
        torch.cuda.reset_peak_memory_stats()
        Ek, st = kernel_inputs(E, steep, dtype)
        Ek = Ek.repeat(reps, 1, 1, 1)[:POP_ROWS].contiguous()
        st = st.repeat(reps, 1, 1, 1)[:POP_ROWS].contiguous()
        d = init.to(dtype).repeat(reps, 1, 1)[:POP_ROWS].contiguous()
        ms = cuda_ms(lambda: banded_minplus_chain(d, Ek, st), 10, 3)
        hist, par = banded_minplus_chain(d, Ek, st)
        bound, by, nbytes, ops = chain_bound(d, Ek, st, None)
        n = POP_CHECK_ROWS
        hist_p, par_p = banded_minplus_chain_ref(d[:n], Ek[:n], st[:n])
        check(torch.equal(hist[:n], hist_p) and torch.equal(par[:n], par_p),
              f"population relax {dtype}: kernel differs from the plain "
              f"version on the first {n} rows")
        check(bool(torch.isfinite(hist).any()), "population relax: no "
              "reachable state")
        log("population", f"B1 {dtype} B={POP_ROWS} L={Ek.shape[1]} N="
            f"{Ek.shape[2]} G+1={d.shape[2]}: {ms:.4f} ms/launch (CUDA events,"
            f" mean of 10), {nbytes} B moved = {nbytes / POP_ROWS:.0f} B/row, "
            f"bound {bound:.4f} ms by {by} ({nbytes / (ms * 1e-3) / 1e9:.1f} "
            f"GB/s achieved), {ops} ops; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B; first {n} rows bit-equal"
            f" to the plain version")
        del hist, par, hist_p, par_p, Ek, st, d


def main() -> int:
    _preflight()
    import torch
    from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                                 banded_minplus_chain)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_environment()
    err = phase_kernels(dev)
    grid = full_grid()
    phase_graphs(grid, dev)
    phase_solve_fin(dev)
    launches, wall = phase_solve_many(
        grid, dev, (banded_minplus_chain, banded_minplus_argmin))
    phase_profile(grid, dev, wall)
    rows = phase_kernel_times(grid, dev, err)
    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"{row['name']}: no launch on the main path")
    phase_population(grid, dev)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
