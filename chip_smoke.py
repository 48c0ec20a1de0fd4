"""Drive the PyTorch port of the FIN placement solver on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written banded (min,+) kernels from ``src/repro_torch``
(the argmin chain B1 and the k-slot chain B3, one ``nvcc`` per source, in
parallel), holds them bit-equal to their plain PyTorch versions on the
card, checks graph construction and the solver on CUDA against the port's
CPU path, and drives each path of the port with the kernels' launch
counters reset just before it and read just after:

  [solve_many]        ``solve_many`` over the full-width 15,360-scenario grid;
  [solve_many_kbest]  the same grid with ``n_best=4`` (the k-slot chain);
  [plan]              768 ``Plan``s through 8 ticks of AR(1) uplink fading
                      and one tick of mask / slice / backhaul deltas;
  [frontier]          96 ``Plan(n_best=4).frontier()`` calls.

It then times the kernels at the main path's largest launch, relaxes 2^20
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
KBEST_SOURCE = "src/repro_torch/kernels/minplus/csrc/banded_minplus_kbest.cu"
CARD_SHAPES = [(1, 1, 4, 4), (64, 4, 5, 26), (8, 2, 23, 26), (4, 4, 8, 131)]
# (B, L, N, G+1, K) of the k-slot kernel checks
KBEST_SHAPES = [(1, 1, 4, 4, 1), (64, 4, 5, 26, 4), (8, 2, 8, 11, 32),
                (4, 4, 5, 26, 32)]
APPS = ("h1", "h2", "h3", "h4", "h5", "h6")
GAMMA = 25
N_BEST = 4
POP_ROWS = 1 << 20
POP_CHECK_ROWS = 65536
#: Sec. V requirements per app, (alpha, delta s, sigma): the values of
#: src/repro/core/multiapp.py:30-37 (PAPER_MULTIAPP_REQS), not yet ported.
MULTIAPP_REQS = {"h1": (0.55, 5e-3, 1.0), "h2": (0.55, 5e-3, 1.0),
                 "h3": (0.55, 5e-3, 1.0), "h4": (0.55, 5e-3, 1.0),
                 "h5": (0.93, 0.1e-3, 1.0), "h6": (0.93, 0.1e-3, 1.0)}
PLAN_USERS = 128
PLAN_TICKS = 8
FRONTIER_USERS = 16


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


def kbest_bound(dist, Ek, st, K, lo, hist):
    """(bound_ms, bound_by, bytes, ops) of one k-slot chain relaxation:
    each input byte read once, each output byte (hist, par_n, par_k)
    written once, and one add plus one compare per admissible candidate
    whose source slot is finite in this run's data (``hist``, the kernel's
    output, gives the finite slots of every layer's source grid)."""
    import torch
    from repro_torch.kernels.minplus.ref import banded_gather_idx
    B, N, Gp1 = dist.shape
    L = Ek.shape[1]
    item = dist.element_size()
    nbytes = (dist.numel() * item + Ek.numel() * item + st.numel() * 4
              + B * L * N * Gp1 * K * (item + 8))
    ops = 0
    finite = torch.isfinite(dist).long()          # init: slot 0 only
    for l in range(L):
        idx = banded_gather_idx(st[:, l], Gp1, lo).long()
        pad = torch.cat([finite, finite.new_zeros((B, N, 1))], dim=2)
        cnt = torch.gather(pad[:, :, None].expand(B, N, N, Gp1 + 1), 3, idx)
        ops += 2 * int((cnt * torch.isfinite(Ek[:, l])[..., None]).sum())
        finite = torch.isfinite(hist[:, l]).sum(-1)
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

def phase_profile(grid, dev, wall_s, n_best=1):
    """Where solve_many's time goes: host functions by cumulative time
    (cProfile) with the exact post-pass's share, then the device's busy time
    (torch.profiler).  The profiler slows the host, so the busy share is
    given against both the profiled wall and ``wall_s``, the same call's
    wall without a profiler."""
    import cProfile
    import io
    import pstats
    import torch
    from torch.autograd import DeviceType
    import repro_torch as T
    ps, ns, rs = grid
    tag = f"solve_many minplus n_best={n_best}"
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    T.solve_many(ps, ns, rs, gamma=GAMMA, n_best=n_best, device=dev)
    torch.cuda.synchronize()
    prof.disable()
    wall_prof = time.perf_counter() - t0
    out = io.StringIO()
    stats = pstats.Stats(prof, stream=out)
    stats.sort_stats("cumulative").print_stats(14)
    for line in out.getvalue().splitlines():
        if line.strip():
            log("profile", line.rstrip())
    post = sum(v[3] for k, v in stats.stats.items()
               if k[2] == "_best_feasible")
    log("profile", f"{tag}: exact post-pass (_best_feasible) {post:.3f} s of "
        f"{wall_prof:.3f} s under cProfile ({post / wall_prof:.1%})")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as tp:
        T.solve_many(ps, ns, rs, gamma=GAMMA, n_best=n_best, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device-side events only: a host op's device time repeats its kernels'
    events = [e for e in tp.key_averages() if e.device_type != DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        log("profile", "device busy share: not measured (the profiler saw no "
            "device time)")
        return
    log("profile", f"{tag}: device busy {busy:.4f} s; wall "
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
    log("env", f"kernel libraries {[p.name for p in lib.paths]}: parallel "
        f"nvcc {lib.build_seconds:.3f} s (load {time.perf_counter() - t0:.3f} "
        f"s)")
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
    err["kbest"] = phase_kernels_kbest(dev)
    return err


def phase_kernels_kbest(dev) -> float:
    """B3 vs its plain version on the card, both dtypes; at K = 1 vs B1."""
    import torch
    from repro_torch.kernels.minplus.ops import (banded_minplus_chain,
                                                 banded_minplus_chain_kbest)
    from repro_torch.kernels.minplus.ref import banded_minplus_chain_kbest_ref
    err = 0.0
    banded_minplus_chain_kbest.launches = 0
    for B, L, N, Gp1, K in KBEST_SHAPES:
        for dtype in (torch.float64, torch.float32):
            for lo in (None, 2):
                d, Ek, st = random_problem(B, L, N, Gp1, B + L + N + Gp1 + K,
                                           dtype, dev)
                got = banded_minplus_chain_kbest(d, Ek, st, K, lo=lo)
                want = banded_minplus_chain_kbest_ref(d, Ek, st, K, lo=lo)
                torch.cuda.synchronize()
                tag = f"B3 {(B, L, N, Gp1, K)} {dtype} lo={lo}"
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"{tag}: kernel differs from the plain version")
                err = max(err, max_abs_err(got[0], want[0]))
                log("kernels", f"{tag}: bit-equal (hist, par_n, par_k; "
                    f"{int((got[1] >= 0).sum())} of {got[1].numel()} slots "
                    f"filled)")
    for dtype in (torch.float64, torch.float32):
        d, Ek, st = random_problem(64, 4, 5, 26, 3, dtype, dev)
        hist, pn, pk = banded_minplus_chain_kbest(d, Ek, st, 1)
        h1, p1 = banded_minplus_chain(d, Ek, st)
        torch.cuda.synchronize()
        check(torch.equal(hist[..., 0], h1) and torch.equal(pn[..., 0], p1)
              and torch.equal(pk[..., 0], torch.where(p1 >= 0, 0, -1).int()),
              f"B3 at K=1 {dtype} differs from B1")
    log("kernels", f"B3 banded_minplus_chain_kbest: "
        f"{banded_minplus_chain_kbest.launches} launches, bit-equal, "
        f"max_abs_err {err}; at K=1 equal to B1 (hist, par_n; par_k 0 where "
        f"reached, -1 elsewhere)")
    return err


def full_grid():
    import numpy as np
    from repro_torch.core.scenarios import sweep_scenarios
    return sweep_scenarios(apps=APPS, deltas_ms=tuple(np.linspace(1, 20, 40)),
                           uplinks_bps=tuple(np.linspace(0.2e9, 2e9, 64)),
                           n_extra_edge=2)


def grid_tensors(grid, device, quantize="floor", gamma=GAMMA):
    """Per shape group (E, steep, init) of the grid's feasible graphs."""
    from repro_torch.core.extended_graph import build_extended_graphs
    from repro_torch.core.feasible_graph import (batch_banded_tensors,
                                                 build_feasible_graphs)
    ps, ns, rs = grid
    fgs = build_feasible_graphs(build_extended_graphs(ns, ps, rs,
                                                      device=device),
                                gamma, quantize=quantize)
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


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_solve_many_kbest(grid, dev, counters, wall_k1):
    """The k-best path: solve_many(n_best=4) over the full-width grid, both
    backends, CUDA against the CPU path."""
    import repro_torch as T
    ps, ns, rs = grid
    launches, wall_k = {}, None
    for backend in ("minplus", "f32"):
        for c in counters:
            c.launches = 0
        sols, wall = _timed(lambda: T.solve_many(
            ps, ns, rs, gamma=GAMMA, n_best=N_BEST, backend=backend,
            device=dev))
        got = {c.__name__: c.launches for c in counters}
        if backend == "minplus":
            launches, wall_k = got, wall
        check(got["banded_minplus_chain_kbest"] > 0,
              f"solve_many n_best={N_BEST} {backend} did not launch B3")
        t0 = time.perf_counter()
        cpu = T.solve_many(ps, ns, rs, gamma=GAMMA, n_best=N_BEST,
                           backend=backend, device="cpu")
        wall_cpu = time.perf_counter() - t0
        check(all(same_solution(a, b) for a, b in zip(sols, cpu)),
              f"solve_many n_best={N_BEST} {backend}: CUDA differs from the "
              f"CPU path")
        found = sum(s.found for s in sols)
        check(found > 0 and all(math.isfinite(s.energy) and s.feasible
                                for s in sols if s.found),
              "solve_many k-best: a found solution is not finite and feasible")
        log("solve_many_kbest", f"{len(ps)} scenarios gamma={GAMMA} n_best="
            f"{N_BEST} {backend}: CUDA == CPU path on all ({found} found); "
            f"kernel launches {got}; wall s (host clock, ending in "
            f"synchronize) cuda {wall:.3f} cpu {wall_cpu:.3f}"
            + (f"; n_best=1 minplus cuda {wall_k1:.3f}"
               if backend == "minplus" else ""))
    return launches, wall_k


def _plan_population(dev, users, n_best=1):
    import repro_torch as T
    nw = T.paper_scenario(n_extra_edge=2)
    plans = []
    for app in APPS:
        pf = T.paper_profile(app)
        req = T.AppRequirements(*MULTIAPP_REQS[app])
        plans += [T.Plan(nw, pf, req, gamma=GAMMA, n_best=n_best, device=dev)
                  for _ in range(users)]
    return plans


def _same_plan_state(a, b) -> bool:
    import dataclasses
    return (same_solution(a.solution, b.solution)
            and dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats))


def _mixed_tick(plans, rng) -> None:
    """mask / unmask, slice and backhaul deltas on four subsets."""
    N = plans[0].n_nodes
    scale = rng.uniform(0.6, 1.4, (N, N))
    for j, p in enumerate(plans):
        if j % 8 == 0:
            p.mask_node(N - 2)
        elif j % 8 == 1:
            p.mask_node(1).unmask_node(1)
        elif j % 8 == 2:
            p.update_slice(0.7, [2])
        elif j % 8 == 3:
            p.update_backhaul(scale)


def phase_plan(dev, counters):
    """The plan IR at population size: 6 apps x 128 users at gamma = 25
    through AR(1) uplink ticks (rho 0.95, sigma 0.05, on [0.3, 1] Gb/s, as
    benchmarks/bench_online.py draws them) and one mixed delta tick, on CUDA
    and on the CPU path with identical solutions and PlanStats; then a
    cold solve_many over the plans' networks equals the warm solutions."""
    import numpy as np
    import torch
    import repro_torch as T
    walls = {}
    final = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        plans = _plan_population(where, PLAN_USERS)
        t_build = time.perf_counter() - t0
        rng = np.random.default_rng(11)
        q = np.full(len(plans), 0.65)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols = []
        for t in range(PLAN_TICKS):
            if t == PLAN_TICKS // 2 + 1:
                for p in plans:
                    for n in p.masked_nodes:
                        p.unmask_node(n)
            q = np.clip(0.65 + 0.95 * (q - 0.65)
                        + rng.normal(0, 0.05, len(plans)), 0.3, 1.0)
            T.update_uplinks(plans, q * 1e9)
            sols.append(T.solve_plans(plans))
            if t == PLAN_TICKS // 2:
                _mixed_tick(plans, rng)
                sols.append(T.solve_plans(plans))
        torch.cuda.synchronize()
        walls[str(where)] = (t_build, time.perf_counter() - t0)
        final[str(where)] = (plans, sols,
                             {c.__name__: c.launches for c in counters})
    (gpu, gsols, launches), (cpu, csols, _) = final[str(dev)], final["cpu"]
    for tick, (a, b) in enumerate(zip(gsols, csols)):
        check(all(same_solution(x, y) for x, y in zip(a, b)),
              f"plan tick {tick}: CUDA solutions differ from the CPU path")
    check(all(_same_plan_state(a, b) for a, b in zip(gpu, cpu)),
          "plan: CUDA PlanStats or incumbents differ from the CPU path")
    check(launches["banded_minplus_chain"] > 0, "plan ticks did not launch B1")
    cold = T.solve_many([p.profile for p in gpu], [p.network for p in gpu],
                        [p.req for p in gpu], gamma=GAMMA, device=dev)
    check(all(same_solution(w, c) for w, c in zip(gsols[-1], cold)),
          "plan: warm solutions differ from a cold solve_many")
    found = sum(s.found for s in gsols[-1])
    stat = {f: sum(getattr(p.stats, f) for p in gpu)
            for f in ("dp_relaxes", "dp_cache_hits", "bounded_relaxes",
                      "layers_skipped", "tighten_rebuilds")}
    log("plan", f"{len(gpu)} plans x {len(gsols)} ticks ({PLAN_TICKS} AR(1) "
        f"+ 1 mask/slice/backhaul): CUDA == CPU path (solutions and "
        f"PlanStats every tick); cold solve_many == warm ({found} found); "
        f"kernel launches {launches}; stats {stat}")
    log("plan", f"wall s (host clock, ending in synchronize): build "
        f"cuda {walls[str(dev)][0]:.3f} cpu {walls['cpu'][0]:.3f} | ticks "
        f"cuda {walls[str(dev)][1]:.3f} cpu {walls['cpu'][1]:.3f}")


def phase_frontier(dev, counters):
    """Plan(n_best=4).frontier(k_per_exit=4) on 6 apps x 16 users, CUDA
    against the CPU path; frontier.argmin equals the warm solve."""
    import numpy as np
    import torch
    import repro_torch as T
    rows = {}
    for where in (dev, "cpu"):
        plans = _plan_population(where, FRONTIER_USERS, n_best=N_BEST)
        rng = np.random.default_rng(5)
        T.update_uplinks(plans, rng.uniform(0.3, 1.0, len(plans)) * 1e9)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frs = [p.frontier(k_per_exit=4) for p in plans]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for p, fr in zip(plans, frs):
            sol = p.solve()
            check((fr.argmin is not None) == sol.feasible,
                  "frontier: argmin present iff the solve is feasible")
            if sol.feasible:
                check(fr.argmin.config == sol.config
                      and fr.argmin.energy == sol.energy,
                      "frontier: argmin differs from solve()")
        rows[str(where)] = ([[(r.energy, r.latency, r.accuracy, r.final_exit,
                               tuple(r.config.placement)) for r in fr]
                             for fr in frs], wall,
                            {c.__name__: c.launches for c in counters})
    (g, wall, launches), (c, wall_cpu, _) = rows[str(dev)], rows["cpu"]
    check(g == c, "frontier: CUDA rows differ from the CPU path")
    check(launches["banded_minplus_chain_kbest"] > 0,
          "frontier did not launch B3")
    log("frontier", f"{len(g)} Plan(n_best={N_BEST}).frontier(k_per_exit=4):"
        f" rows CUDA == CPU path ({sum(map(len, g))} rows), argmin == solve()"
        f"; kernel launches {launches}; wall s cuda {wall:.3f} cpu "
        f"{wall_cpu:.3f}")


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
    rows.append(kbest_times(grid, dev, err, init, Ek, st))
    return rows


def kbest_times(grid, dev, err, init, Ek, st):
    """B3 at the k-best path's largest launch (the same five-block group,
    K = 4) in float64 against its plain version and bound; float32 at the
    same shape and K = 32 at gamma = 10 for the record."""
    import torch
    from repro_torch.core.bellman_ford import kernel_inputs
    from repro_torch.kernels.minplus.ops import banded_minplus_chain_kbest
    from repro_torch.kernels.minplus.ref import banded_minplus_chain_kbest_ref
    K = N_BEST
    ms = cuda_ms(lambda: banded_minplus_chain_kbest(init, Ek, st, K), 20)
    plain = cuda_ms(lambda: banded_minplus_chain_kbest_ref(init, Ek, st, K),
                    3, 1)
    hist = banded_minplus_chain_kbest(init, Ek, st, K)[0]
    bound, by, nbytes, ops = kbest_bound(init, Ek, st, K, None, hist)
    log("times", f"B3 f64 {tuple(init.shape)} L={Ek.shape[1]} K={K}: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms by {by} "
        f"({nbytes} B, {ops} ops, {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
        f"achieved)")
    row = dict(name="banded_minplus_chain_kbest", route="cuda",
               source=KBEST_SOURCE,
               replaces="src/repro/kernels/minplus/minplus.py:263",
               launches=None, max_abs_err=err["kbest"], ms=ms, plain_ms=plain,
               bound_ms=bound, bound_by=by, library_ms=None)
    Ek32, init32 = Ek.float(), init.float()
    ms32 = cuda_ms(lambda: banded_minplus_chain_kbest(init32, Ek32, st, K), 20)
    hist32 = banded_minplus_chain_kbest(init32, Ek32, st, K)[0]
    bound32, by32, _, _ = kbest_bound(init32, Ek32, st, K, None, hist32)
    log("times", f"B3 f32 {tuple(init.shape)} K={K}: kernel {ms32:.4f} ms, "
        f"bound {bound32:.4f} ms by {by32}")
    del hist, hist32
    parts = [grid_tensors(grid, dev, q, gamma=10)[5]
             for q in ("floor", "ceil")]
    Ek10, st10 = kernel_inputs(torch.cat([p[0] for p in parts]),
                               torch.cat([p[1] for p in parts]),
                               torch.float64)
    init10 = torch.cat([p[2] for p in parts]).contiguous()
    ms10 = cuda_ms(lambda: banded_minplus_chain_kbest(init10, Ek10, st10, 32),
                   5)
    got = banded_minplus_chain_kbest(init10, Ek10, st10, 32)
    bound10, by10, _, _ = kbest_bound(init10, Ek10, st10, 32, None, got[0])
    n = 512
    want = banded_minplus_chain_kbest_ref(init10[:n], Ek10[:n], st10[:n], 32)
    check(all(torch.equal(g[:n], w) for g, w in zip(got, want)),
          "B3 K=32 gamma=10: kernel differs from the plain version")
    log("times", f"B3 f64 {tuple(init10.shape)} L={Ek10.shape[1]} K=32: "
        f"kernel {ms10:.4f} ms, bound {bound10:.4f} ms by {by10}; first {n} rows "
        f"bit-equal to the plain version")
    return row


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
                                                 banded_minplus_chain,
                                                 banded_minplus_chain_kbest)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (banded_minplus_chain, banded_minplus_argmin,
                banded_minplus_chain_kbest)

    phase_environment()
    err = phase_kernels(dev)
    grid = full_grid()
    phase_graphs(grid, dev)
    phase_solve_fin(dev)
    launches, wall = phase_solve_many(grid, dev, counters)
    launches_k, wall_k = phase_solve_many_kbest(grid, dev, counters, wall)
    phase_plan(dev, counters)
    phase_frontier(dev, counters)
    phase_profile(grid, dev, wall)
    phase_profile(grid, dev, wall_k, n_best=N_BEST)
    rows = phase_kernel_times(grid, dev, err)
    # each kernel's launches on its own path: B1 on solve_many, B3 on
    # solve_many(n_best=4)
    for row, path in zip(rows, (launches, launches_k)):
        row["launches"] = path[row["name"]]
        check(row["launches"] > 0, f"{row['name']}: no launch on its path")
    phase_population(grid, dev)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
