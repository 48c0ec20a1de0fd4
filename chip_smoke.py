"""Drive the PyTorch port of the FIN placement system on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It builds every hand-written kernel of ``src/repro_torch`` (the banded
(min,+) argmin chain B1 and k-slot chain B3, the dense (min,+) products B5
and B4, the exit gate B6, the flash-decode attention B7 and the population
tick's fused ingest B2; one ``nvcc`` per source, all in parallel), holds
each against its plain PyTorch version on the card, checks graph
construction and the solver on CUDA against the port's CPU path, and
drives each path of the port with the kernels' launch counters reset just
before it and read just after:

  [solve_many]        ``solve_many`` over the full-width 15,360-scenario grid;
  [solve_many_dense]  the same grid with ``backend="dense"`` (B4 on the
                      (S, S) layer matrices), identical to [solve_many];
                      then the 48-scenario Fig. 5-7 sweep against the CPU
                      path, k-best and the ``python`` oracle;
  [table7_dense]      ``fin_all_exit_costs`` on the paper's Table VII large
                      instance (15 nodes, 12 blocks; B5), dense == banded;
  [solve_many_kbest]  the same grid with ``n_best=4`` (the k-slot chain);
  [plan]              768 ``Plan``s through 8 ticks of AR(1) uplink fading
                      and one tick of mask / slice / backhaul deltas;
  [frontier]          96 ``Plan(n_best=4).frontier()`` calls;
  [pop_tick]          one ``Population`` of 1,000,000 h4 users (B2 over
                      every user each tick, B1 on the newborn states): a
                      cold attach, 8 AR(1) ticks of ingest, dense gate and
                      solve, a mixed tick of failure / slice / backhaul
                      deltas and a checkpoint round trip, against the CPU
                      path (incumbents, counters, state_dict bytes);
  [churn]             the churn orchestrator over 1,000,000 users
                      (``population_cohorts(n_extra_edge=2)``, six cohorts):
                      3 AR(1) ``step_arrays`` ticks, a twin through
                      ``run_arrays(stream=True)`` and the CPU path, all
                      identical (reports, incumbents, counters);
  [congestion]        10,000 users with the busiest shared node capped
                      (``shared_capacity=``, 4 ticks), against the CPU path;
  [failover]          64 h2 users through 20 ticks of tier outages with
                      ``contingency=True`` (hits, no misses, solve-free
                      failure ticks), against the CPU path;
  [multiapp]          ``run_multiapp(200)`` (Fig. 8), continuous and
                      bucketed draws, against the CPU path;
  [resume]            [churn]'s orchestrator through 4 ticks of
                      ``run_arrays(checkpoint_dir=, checkpoint_every=2)``
                      with a crash injected after tick 3, synchronous and
                      streamed: ``resume`` in a fresh orchestrator replays
                      the tail of the uninterrupted run (reports,
                      incumbents, state_dict bytes), on CUDA and from the
                      same checkpoint on the CPU path;
  [mesh]              [pop_tick]'s cohort with ``backend="mesh"`` (the
                      users mesh over the visible cards, one f32 B1 launch
                      a shard) against the CPU path and an ``f32`` cohort,
                      then the relaxer's retry ladder under injected stalls;
  [multihost]         this script again as two gloo ranks on the one card
                      (``--multihost-rank``): ragged shards through the
                      two-rank mesh equal a local relaxer, and a symmetric
                      stall schedule demotes each rank once, exactly;
  [elastic]           ``fin_failover`` over 64 h2 ``Plan``s, failing and
                      recovering each node, with and without the
                      contingency library, against cold ``solve_fin`` and
                      the CPU path; the mesh planner for qwen3-4b;
  [serve]             ``SplitServeEngine`` on qwen3-4b at full width in bf16
                      (random weights from a seed): 16 requests, then a
                      ``serve_with_churn`` trace with a node failure and its
                      recovery (B1 through the engine's Plan, B6, B7);
  [serve_parity]      qwen3-4b widths at 3 layers in float32: the engine and
                      ``decode_step`` on CUDA against the port's CPU path;
  [serve_ssm]         [serve]'s engine run on mamba2-1.3b at full width and
                      depth in bf16 (48 SSM layers: B6 and B1, no B7);
  [serve_moe]         the same on mixtral-8x22b at full width cut to 4 of
                      its 56 periods (B7 at G = 6, D = 128), then a
                      4,608-token ``prefill`` into its 4,096-slot window
                      (the ring slots wrap) and 8 decode steps at B = 1;
  [prefill]           teacher forcing on the card in float32 (prefill of
                      S - 1 tokens plus a decode step equals
                      ``forward_train``): qwen3-4b at 3 layers, mamba2-1.3b
                      whole, mixtral at 4 periods past its window; and
                      hubert-xlarge's ``encode`` at full width in bf16;
  [serve_parity]      again for mamba2 (2 periods) and mixtral (1 period)
                      widths in float32: ``forward_train``, ``prefill`` and
                      ``decode_step`` on CUDA against the CPU path;
  [branchy]           the paper's DNNs at Table III widths in float32
                      (B-LeNet, B-AlexNet at 227x227x3, B-ResNet-110):
                      forward and ``infer`` at B = 256 against the CPU path
                      (B6 once an exit), ``extract_profile`` through
                      ``solve_fin`` on the paper scenario, B6 at the exits'
                      [256, 10] and [4096, 10];
  [branchy_train]     B-ResNet-110, 20 AdamW steps on synthetic images (the
                      loss falls); B-LeNet 5 steps against the CPU path;
  [train]             qwen3-4b at full width and depth (bf16, float32
                      moments, ``remat="full"``) through ``train()``, 8
                      steps at B = 4, S = 512;
  [train_parity]      ``loss_fn``, its gradients and 3 train steps in
                      float32 on CUDA against the CPU path (qwen3-4b widths
                      at 2 layers, mamba2 and mixtral at 1 period), and a
                      checkpoint / resume through ``train()``.

It then times the kernels at their paths' shapes (B7 also at mixtral's
heads over 4,096 slots), the plain PyTorch programs ``_ssd_scan``,
``chunked_attention``, ``_moe_gather`` and ``chunked_cross_entropy``
(forward plus backward) at their paths' shapes ([programs]), relaxes 2^20 scenario rows at population size, and prints
the kernels JSON line followed by the final status line.  Every failing phase raises; without a CUDA card, or
without the repository beside it, it exits non-zero and prints no result.

  python3 chip_smoke.py --times [chain] [dense] [kbest] [gate] [attn] [plan]
                                [ingest]

builds the kernels and runs only the timings (no checks, no result line):
B1 at the main path's largest launch (20,480 rows) in float64 and float32
with a sweep of its scenarios a group, B1u, B1 at 2^20 rows in both dtypes
and ``batched_banded_relax_argmin`` whole at the 20,480-row launch,
B4 / B5 at the dense path's largest launch and at both Table VII layers,
B3 at the k-best path's largest launch in float64 and float32, at K = 32
and gamma = 10, and at the largest [frontier] launch, B6 at [4, 153,600] in float32 and bf16 on seeded logits, B7, and the
[plan] wall (768 plans, 9 ticks, CUDA and the CPU path), B2 at 1e6 rows
for h4 and h6 (and on the [pop_tick] rows with the packs before and after
the reprices, by graph replays, single launches and torch.profiler); all
of them
without a name, else the named ones.  The kernels are timed as CUDA-graph
replays beside CUDA-event means.  The timings use only the kernels' public
wrappers, so a copy of this script run from an older checkout times that
checkout's kernels: run two in turns in one call to compare two designs on
one card.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

#: H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): device memory
#: rate and the non-tensor-core float64 / float32 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}

KERNEL_SOURCE = "src/repro_torch/kernels/minplus/csrc/banded_minplus.cu"
KBEST_SOURCE = "src/repro_torch/kernels/minplus/csrc/banded_minplus_kbest.cu"
DENSE_SOURCE = "src/repro_torch/kernels/minplus/csrc/minplus_dense.cu"
GATE_SOURCE = "src/repro_torch/kernels/ee_gate/csrc/ee_gate.cu"
ATTN_SOURCE = "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu"
INGEST_SOURCE = "src/repro_torch/kernels/ee_gate/csrc/quant_signature.cu"
# (B, V) of the exit-gate checks; the qwen3-4b padded vocab has a -inf tail
# of 153,600 - 151,936 = 1,664 columns
GATE_SHAPES = [(1, 128), (5, 5000), (4, 153600), (16, 50304),
               (4, 32768), (4, 51200)]
VOCAB_TAIL = 1664
# the gate's other serving shapes: mixtral-8x22b's padded vocab (no tail)
# and mamba2-1.3b's (51,200 - 50,280 = 920 -inf columns)
GATE_MORE_SHAPES = [(4, 32768, 0), (4, 51200, 920)]
# (B, V) of the split-gate checks (gate_rows): V below, at and above one
# block's 2,048 elements, V = 4097 (rows not 16-byte aligned), B above the
# SM count (one block a row)
GATE_SPLIT_SHAPES = [(4, 153600), (3, 4097), (1, 4097), (3, 2047), (3, 2048),
                     (3, 2049), (4, 5000), (200, 4097), (3, 9)]
# (B, H, KV, D, T) of the attention checks: tests/test_kernels.py's four,
# qwen3-4b's decode shape and two long caches at its widths (T = 4097 is
# ragged against every split and tile)
ATTN_SHAPES = [(1, 4, 4, 32, 128), (2, 8, 2, 64, 256), (1, 8, 1, 64, 300),
               (3, 4, 2, 16, 64), (4, 32, 8, 80, 256), (4, 32, 8, 80, 8192),
               (4, 32, 8, 80, 4097)]
# (shape, mask) of the attention checks beyond the ring-slot mask: "range"
# empties the second block's range of the cache (split_ranges); "dead"
# leaves no slot live (the uniform average)
ATTN_MASK_CASES = [((1, 32, 8, 80, 2048), "range"),
                   ((4, 32, 8, 80, 4097), "range"),
                   ((4, 32, 8, 80, 256), "dead"), ((1, 8, 1, 64, 300), "dead"),
                   ((4, 48, 8, 128, 4096), "range")]
# mixtral-8x22b's heads (H = 48, KV = 8, G = 6, D = 128) at its 4,096-slot
# window: (shape, window, mask); "full" has every slot live up to
# pos = T - 1, so T = 4,097 drops slot 0 by the window alone
ATTN_MOE_CASES = [((4, 48, 8, 128, 4096), 0, "tail"),
                  ((4, 48, 8, 128, 4096), 4096, "full"),
                  ((1, 48, 8, 128, 4097), 4096, "full"),
                  ((4, 48, 8, 128, 4097), 4096, "full")]
# cache lengths of the B7 timings: the serving shape and two long caches
ATTN_TIME_T = (256, 8192, 32768)
SERVE_ARCH = "qwen3-4b"
SERVE_BATCH = 4
SERVE_CACHE = 256
SERVE_REQUESTS = 16
SERVE_NEW = 8
SERVE_PROMPT = 3
# the rest of model serving: mamba2-1.3b at full width and depth, and
# mixtral-8x22b at full width cut to MOE_PERIODS of its 56 periods
SSM_ARCH = "mamba2-1.3b"
MOE_ARCH = "mixtral-8x22b"
MOE_PERIODS = 4
MOE_PROMPT = 4608                 # past mixtral's 4,096-token window
MOE_DECODE = 8
SSM_PROBE = 16                    # threshold probe batch (48 f32 states)
SSM_PROMPT = 4096                 # [serve_ssm]'s prefill, as [serve_moe]'s
# [prefill] teacher forcing in float32: (arch, periods or None for all,
# B, S); mixtral's S - 1 = 4,199 prompt tokens run past its window
PREFILL_CASES = [("qwen3-4b", 3, 2, 64), ("mamba2-1.3b", None, 2, 300),
                 ("mixtral-8x22b", MOE_PERIODS, 1, 4200)]
ENCODE_FRAMES = (2, 1024)         # hubert-xlarge encode batch, frames
# [branchy]: the paper's DNNs at Table III widths, B-ResNet at ResNet-110
BRANCHY_MODELS = (("b-lenet", {}), ("b-alexnet", {}),
                  ("b-resnet", {"blocks_per_stage": 18}))
BRANCHY_BATCH = 256
BRANCHY_THRESHOLD = 0.9
BRANCHY_GATE_SHAPES = ((256, 10), (4096, 10))   # B6 at the exits' [B, 10]
BRANCHY_TRAIN_STEPS = 20
LENET_PARITY_STEPS = 5
# [train]: qwen3-4b full width and depth; [train_parity] in float32
TRAIN_ARCH = "qwen3-4b"
TRAIN_STEPS = 8
TRAIN_BATCH = 4
TRAIN_SEQ = 512
TRAIN_PARITY = (("qwen3-4b", 2), ("mamba2-1.3b", 1), ("mixtral-8x22b", 1))
TRAIN_PARITY_BATCH = 2
TRAIN_PARITY_SEQ = 32
CARD_SHAPES = [(1, 1, 4, 4), (64, 4, 5, 26), (8, 2, 23, 26), (4, 4, 8, 131)]
# (case, B, L, N, G+1) of B1's launch plans, each checked to reach what it
# names: a batch that is no multiple of the group, B = 1, more groups than
# the persistent grid holds at once (its blocks loop), odd G+1 (runs that
# are not 16-byte aligned), a chain too long for a group in shared memory
# (the per-layer ring), and the widest shape, N = 32 and G+1 = 256 (more
# nodes and depths than a block has threads: each thread loops)
CHAIN_CASES = [("ragged", 1000, 3, 5, 26), ("b1", 1, 4, 5, 26),
               ("loop", 4096, 2, 5, 26), ("unaligned", 9, 3, 5, 11),
               ("layered", 2, 64, 16, 64), ("widest", 2, 3, 32, 256)]
# (B, S, T) of the dense kernel checks: tests/test_kernels.py's shapes, then
# S = 130 (N = 5, G+1 = 26) and S = 390 (N = 15, G+1 = 26)
DENSE_SHAPES = [(1, 16, 16), (8, 128, 128), (3, 37, 65), (16, 300, 129),
                (2, 1, 257), (64, 130, 130), (4, 390, 390)]
# (B, S, T) of the sparse-dist checks (dense_sparse_problem)
SPARSE_SHAPES = [(5, 37, 65), (64, 130, 130), (16, 300, 129), (8, 390, 390)]
# S = T of the one-scenario checks (B = 1: the Table VII layers, and 397,
# not a multiple of a source slice) and their dists (one_scenario_dist)
ONE_SCENARIO_S = (165, 390, 397)
ONE_SCENARIO_CASES = ("layer", "first_slice_dead", "last_only", "nonfinite")
# the paper's Table VII large instance (benchmarks/bench_table7.py:59-73)
TABLE7_NODES = 15
TABLE7_BLOCKS = 12
# (B, L, N, G+1, K) of the k-slot kernel checks
KBEST_SHAPES = [(1, 1, 4, 4, 1), (64, 4, 5, 26, 4), (8, 2, 8, 11, 32),
                (4, 4, 5, 26, 32)]
# (case, B, L, N, G+1, K) of the checks of the k-slot merge's tie order
# (kbest_problem): every candidate equal; integer energies (equal values
# inside one source's slots, beside the duplicated source node) at the
# solver's width, with K above the admissible pool, at N = 32, at B = 1,
# at a batch that is no multiple of the scenarios a block (1,000 at 3), and
# at odd G+1 and K, whose layer chunks are not 16-byte aligned (the scalar
# copy-out)
KBEST_TIE_CASES = [("equal", 6, 3, 5, 26, 8), ("runs", 16, 4, 5, 26, 4),
                   ("pool_below_k", 8, 2, 3, 7, 16), ("n32", 2, 2, 32, 9, 4),
                   ("b1", 1, 4, 5, 26, 4), ("ragged", 1000, 3, 3, 7, 4),
                   ("unaligned", 9, 3, 5, 11, 3)]
APPS = ("h1", "h2", "h3", "h4", "h5", "h6")
GAMMA = 25
N_BEST = 4
POP_ROWS = 1 << 20
POP_CHECK_ROWS = 65536
#: the [pop_tick] cohort: benchmarks/bench_online.py's pop_scale_1e6 scale
#: (1e6 users) at one app, h4 (L = 5, floor + ceil: 90 int16 a signature),
#: gamma 10 (online.population_cohorts' default), rates
#: scenarios.MOBILE_UPLINK_BPS * q; POP_FAIL_NODE is an edge node (edge2)
POP_USERS = 1_000_000
POP_TICKS = 8
POP_APP = "h4"
POP_GAMMA = 10
POP_FAIL_NODE = 2
#: batch sizes of B2's [kernels] checks, and the apps of its timings (h6:
#: L = 3, 50 int16 a signature)
INGEST_CHECK_ROWS = (1, 4097, 100_003)
INGEST_TIME_APPS = ("h4", "h6")
#: B2's fast path takes divide operands of +0 or in [2^-200, 2^200]: rates
#: at and across those ends, subnormal, tiny and huge rates (bits / rate
#: underflows) and the largest double, for the [kernels] checks
INGEST_EDGE_RATES = (5e-324, 1e-310, 2.2250738585072014e-308, 2.0 ** -200,
                     2.0 ** -200 * (1 - 2.0 ** -53), 2.0 ** 200,
                     2.0 ** 200 * (1 + 2.0 ** -52), 1e300,
                     1.7976931348623157e308)
#: deltas of the [kernels] checks beside the app's: subnormal and tiny
#: (outside the fast domain), inside it at both ends, and huge
INGEST_EDGE_DELTAS = (5e-324, 1e-200, 1e-55, 1e50, 1e300)
#: [churn]: benchmarks/bench_online.py's pop_scale_1e6 row (1e6 users over
#: population_cohorts(n_extra_edge=2), hysteresis 0.05, 3 AR(1) ticks of
#: _ar1_draws: seed 5, mean 0.65, sigma 0.05, clipped to [0.3, 1])
CHURN_USERS = 1_000_000
CHURN_TICKS = 3
#: [congestion]: benchmarks/bench_congestion.py's full-mode row (10,000
#: users, 4 ticks, the busiest shared node capped at 0.6 of its uncoupled
#: load)
CONGESTION_USERS = 10_000
CONGESTION_TICKS = 4
CONGESTION_CAP_FRAC = 0.6
#: [failover]: benchmarks/bench_failover.py's _tier_trace_row at full mode
#: (64 h2 users on paper_scenario(n_extra_edge=1), 20 ticks, tier outages
#: of nodes 1 and 2, contingency=True)
FAILOVER_USERS = 64
FAILOVER_TICKS = 20
#: [multiapp]: benchmarks/bench_fig8.py's population variant (200 users a
#: app, continuous draws and 16 uplink buckets), seed 1
MULTIAPP_USERS = 200
MULTIAPP_BUCKETS = 16
#: [resume]: [churn]'s configuration through 4 ticks, checkpoints every 2
#: (at most 2 kept), a crash injected after tick 3 (stage "post")
RESUME_TICKS = 4
RESUME_CRASH = 3
#: [multihost]: rank r relaxes MULTIHOST_ROWS + 7 r chains at the [mesh]
#: cohort's widths; [elastic]: [failover]'s 64 h2 users as Plans
MULTIHOST_ROWS = 20_000
ELASTIC_PLANS = 64
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


def graph_ms(fn, reps: int, replays: int = 5):
    """Device time of ``fn`` a call: ``reps`` calls captured into one CUDA
    graph, replayed ``replays`` times between CUDA events.  A replay has no
    Python or launch cost between the kernels, which a CUDA-event mean of
    back-to-back calls of a short kernel measures instead.  None if the
    calls cannot be captured."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        log("times", f"CUDA graph capture failed ({str(e)[:120]}); "
            f"graph time not measured")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * reps)


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


def kbest_problem(case, B, L, N, Gp1, seed, dtype, device):
    """Seeded B3 inputs whose pools tie: case ``"equal"`` makes every
    candidate of a layer equal (init 2 everywhere, every edge 1 at
    steepness 0); every other case is :func:`random_problem` with integer
    energies, so equal values fill the runs of one source's slots."""
    import numpy as np
    import torch
    from repro_torch.core.bellman_ford import kernel_inputs
    if case == "equal":
        dist = np.full((B, N, Gp1), 2.0)
        E = np.ones((B, L, N, N))
        steep = np.zeros((B, L, N, N))
    else:
        rng = np.random.default_rng(seed)
        dist = np.floor(rng.uniform(0, 4, (B, N, Gp1)))
        dist[rng.uniform(size=dist.shape) < 0.5] = np.inf
        E = np.floor(rng.uniform(0, 3, (B, L, N, N)))
        steep = rng.integers(0, Gp1, (B, L, N, N)).astype(np.float64)
        steep[rng.uniform(size=steep.shape) < 0.3] = np.inf
        if N > 1:
            E[:, :, 1], steep[:, :, 1], dist[:, 1] = E[:, :, 0], \
                steep[:, :, 0], dist[:, 0]
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
    from repro_torch.kernels._build import load_library
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from repro_torch.models import layers
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}; float32-output half products "
        f"(mm, bmm out_dtype): {layers._MM_OUT_DTYPE}, "
        f"{getattr(layers, '_BMM_OUT_DTYPE', 'none')}")
    t0 = time.perf_counter()
    lib = load_library()
    log("env", f"kernel libraries {[p.name for p in lib.paths]}: parallel "
        f"nvcc {lib.build_seconds:.3f} s (load {time.perf_counter() - t0:.3f} "
        f"s)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("env", line.strip())


def chain_case_reached(case, B, L, N, Gp1, dtype, dev) -> bool:
    """Whether B1's launch plan for a :data:`CHAIN_CASES` shape reaches
    what the case names."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.minplus import ops
    spb, threads, blocks = ops.chain_plan(B, L, N, Gp1, dtype, sm_count(dev))
    whole = ops.chain_whole(L, N, Gp1, dtype)
    return {"ragged": B % spb > 0, "b1": B == 1,
            "loop": -(-B // spb) > blocks,
            "unaligned": N * Gp1 * dtype.itemsize % 16 > 0,
            "layered": not whole,
            "widest": ops.chain_threads(N, Gp1) > threads}[case]


def phase_kernels(dev):
    """B1 and B1u vs their plain versions on the card, both dtypes; B1 on
    its launch-plan cases and in its init-row mode."""
    import torch
    from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                                 banded_minplus_chain,
                                                 banded_minplus_chain_history)
    from repro_torch.kernels.minplus.ref import (banded_minplus_chain_ref,
                                                 banded_minplus_ref)
    err = {"chain": 0.0, "layer": 0.0}
    banded_minplus_chain.launches = banded_minplus_argmin.launches = 0
    cases = [("shape",) + shape for shape in CARD_SHAPES] + CHAIN_CASES
    for case, B, L, N, Gp1 in cases:
        for dtype in (torch.float64, torch.float32):
            check(case == "shape" or chain_case_reached(case, B, L, N, Gp1,
                                                        dtype, dev),
                  f"B1 {case} {(B, L, N, Gp1)} {dtype}: the launch plan "
                  f"does not reach what the case names")
            for lo in (None, 2):
                d, Ek, st = random_problem(B, L, N, Gp1, B + L + N + Gp1,
                                           dtype, dev)
                hist, par = banded_minplus_chain(d, Ek, st, lo=lo)
                hist_p, par_p = banded_minplus_chain_ref(d, Ek, st, lo=lo)
                full, par_h = banded_minplus_chain_history(d, Ek, st, lo=lo)
                torch.cuda.synchronize()
                tag = f"B1 {case} {(B, L, N, Gp1)} {dtype} lo={lo}"
                check(torch.equal(hist, hist_p) and torch.equal(par, par_p),
                      f"{tag}: kernel differs from the plain version")
                check(torch.equal(full, torch.cat([d[:, None], hist_p], 1))
                      and torch.equal(par_h, par_p),
                      f"{tag} init-row mode: differs from the init row and "
                      f"the plain version")
                err["chain"] = max(err["chain"], max_abs_err(hist, hist_p))
                if case == "shape":
                    out, arg = banded_minplus_argmin(d[0], Ek[0, 0],
                                                     st[0, 0], lo=lo)
                    out_p, arg_p = banded_minplus_ref(d[0], Ek[0, 0],
                                                      st[0, 0], lo=lo)
                    torch.cuda.synchronize()
                    check(torch.equal(out, out_p) and torch.equal(arg, arg_p),
                          f"B1u {tag[3:]}: kernel differs from the plain "
                          f"version")
                    check(torch.equal(out, hist[0, 0]),
                          f"B1u {tag[3:]}: differs from one layer of B1")
                    err["layer"] = max(err["layer"], max_abs_err(out, out_p))
                log("kernels", f"{tag}: bit-equal, init-row mode too "
                    f"(reached {int((par >= 0).sum())} of {par.numel()} "
                    f"states)")
    log("kernels", f"B1 banded_minplus_chain: {banded_minplus_chain.launches} "
        f"launches (both modes), bit-equal, max_abs_err {err['chain']} | B1u "
        f"banded_minplus_argmin: {banded_minplus_argmin.launches} launches, "
        f"bit-equal, max_abs_err {err['layer']}")
    err["kbest"] = phase_kernels_kbest(dev)
    return err


def phase_kernels_kbest(dev) -> float:
    """B3 vs its plain version on the card, both dtypes, on random inputs
    and on the tie-order cases; at K = 1 vs B1."""
    import torch
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.minplus.ops import (banded_minplus_chain,
                                                 banded_minplus_chain_kbest,
                                                 kbest_plan)
    from repro_torch.kernels.minplus.ref import banded_minplus_chain_kbest_ref
    err = 0.0
    banded_minplus_chain_kbest.launches = 0
    cases = [("random",) + shape for shape in KBEST_SHAPES] + KBEST_TIE_CASES
    for case, B, L, N, Gp1, K in cases:
        for dtype in (torch.float64, torch.float32):
            spb, threads = kbest_plan(B, N, Gp1, K, dtype, sm_count(dev))
            for lo in (None, 2):
                seed = B + L + N + Gp1 + K
                d, Ek, st = (random_problem(B, L, N, Gp1, seed, dtype, dev)
                             if case == "random" else
                             kbest_problem(case, B, L, N, Gp1, seed, dtype,
                                           dev))
                got = banded_minplus_chain_kbest(d, Ek, st, K, lo=lo)
                want = banded_minplus_chain_kbest_ref(d, Ek, st, K, lo=lo)
                torch.cuda.synchronize()
                tag = f"B3 {case} {(B, L, N, Gp1, K)} {dtype} lo={lo}"
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"{tag}: kernel differs from the plain version")
                h = got[0]
                ties = int((torch.isfinite(h[..., 1:])
                            & (h[..., 1:] == h[..., :-1])).sum())
                check(case == "random" or K == 1 or ties > 0,
                      f"{tag}: no equal values inside a row to order")
                check({"ragged": B % spb > 0, "unaligned": N * Gp1 * K % 4 > 0,
                       "pool_below_k": N < K}.get(case, True),
                      f"{tag}: the case does not reach what it names")
                err = max(err, max_abs_err(got[0], want[0]))
                log("kernels", f"{tag}: bit-equal (hist, par_n, par_k; "
                    f"{int((got[1] >= 0).sum())} of {got[1].numel()} slots "
                    f"filled, {ties} equal neighbours; {spb} scenarios a "
                    f"block, {threads} threads, B % {spb} = {B % spb}, "
                    f"layer chunk {'scalar' if N * Gp1 * K % 4 else '16 B'} "
                    f"copy-out)")
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


def dense_problem(B, S, T, seed, dtype, device, per_row):
    """Seeded dense inputs with missing edges, a -inf and a NaN entry (both
    missing) and a duplicated source state (ties)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, S))
    dist[rng.uniform(size=dist.shape) > 0.9] = np.inf
    W = rng.uniform(0, 5, (B, S, T) if per_row else (S, T))
    W[rng.uniform(size=W.shape) > 0.6] = np.inf
    W.reshape(-1)[0] = -np.inf
    W.reshape(-1)[-1] = np.nan
    if S > 1:
        dist[:, 1] = dist[:, 0]
        W[..., 1, :] = W[..., 0, :]
    return (torch.as_tensor(dist, device=device).to(dtype),
            torch.as_tensor(W, device=device).to(dtype))


def dense_sparse_problem(B, S, T, seed, dtype, device, per_row):
    """Seeded dense inputs whose dist is 90% +inf, as a layer of the solver
    sees it, with a row of no finite entry (row 0), a row whose only finite
    source is the last (row 1), -inf and NaN entries (row 2), and on every
    row a skipped source (dist -inf) that ties a kept one (same W row) and
    two kept sources that tie each other."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, S))
    dist[rng.uniform(size=dist.shape) < 0.9] = np.inf
    W = rng.uniform(0, 5, (B, S, T) if per_row else (S, T))
    W[rng.uniform(size=W.shape) > 0.6] = np.inf
    if S >= 6:
        W[..., 3, :] = W[..., 4, :]          # 3 skipped, 4 kept: a tie
        dist[:, 3], dist[:, 4] = -np.inf, 1.0
        W[..., 5, :] = W[..., 4, :]          # 4 and 5 kept: first wins
        dist[:, 5] = 1.0
    dist[0] = np.inf
    if B > 1:
        dist[1] = np.inf
        dist[1, -1] = 2.0
    if B > 2:
        dist[2, ::3] = -np.inf
        dist[2, 1::3] = np.nan
    return (torch.as_tensor(dist, device=device).to(dtype),
            torch.as_tensor(W, device=device).to(dtype))


def one_scenario_dist(S, seed, case):
    """A B = 1 dist as a Table VII layer gives it (about 10% reached), or:
    "first_slice_dead" (no live source in the first source slice of the
    kernel's plan at 132 SMs), "last_only" (only the last source live),
    "nonfinite" (-inf and NaN entries beside the finite ones)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (1, S))
    dist[rng.uniform(size=dist.shape) < 0.9] = np.inf
    if case == "first_slice_dead":
        from repro_torch.kernels.minplus.ops import dense_plan
        _, Q = dense_plan(1, S, S, False, 132)
        dist[0, :-(-S // Q)] = np.inf
    elif case == "last_only":
        dist[:] = np.inf
        dist[0, -1] = 1.0
    elif case == "nonfinite":
        dist[0, ::5] = -np.inf
        dist[0, 1::7] = np.nan
    return dist


def phase_kernels_dense(dev):
    """B5 and B4 vs their plain versions on the card, float64 and float32,
    with a shared W and a W per row: bit-equal values and argmins, on the
    dense inputs, on sparse dists and at one scenario (B = 1, the sources
    split over a cluster), where a repeat call gives the same bits."""
    import torch
    from repro_torch.kernels.minplus.ops import (minplus_vecmat,
                                                 minplus_vecmat_argmin)
    from repro_torch.kernels.minplus.ref import minplus_argmin_ref, minplus_ref
    minplus_vecmat.launches = minplus_vecmat_argmin.launches = 0
    err = {"minplus_vecmat": 0.0, "minplus_vecmat_argmin": 0.0}
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.minplus.ops import dense_plan

    def one_scenario(case):
        def make(B, S, T, seed, dtype, device, per_row):
            W = dense_problem(1, S, S, S + 1, torch.float64, "cpu",
                              per_row)[1]
            return (torch.as_tensor(one_scenario_dist(S, S, case),
                                    device=device).to(dtype),
                    W.to(device=device, dtype=dtype))
        return make
    cases = [(s, dense_problem, "dense") for s in DENSE_SHAPES] + \
        [(s, dense_sparse_problem, "sparse") for s in SPARSE_SHAPES] + \
        [((1, S, S), one_scenario(c), f"one-scenario {c}")
         for S in ONE_SCENARIO_S for c in ONE_SCENARIO_CASES]
    for (B, S, T), make, kind in cases:
        for dtype in (torch.float64, torch.float32):
            for per_row in (False, True):
                d, W = make(B, S, T, B + S + T, dtype, dev, per_row)
                out = minplus_vecmat(d, W)
                got, arg = minplus_vecmat_argmin(d, W)
                again = minplus_vecmat(d, W)
                want_out = minplus_ref(d, W)
                want, arg_p = minplus_argmin_ref(d, W)
                torch.cuda.synchronize()
                per, Q = dense_plan(B, S, T, not per_row and B > 1,
                                    sm_count(dev))
                tag = (f"{kind} {(B, S, T)} {dtype} "
                       f"{'per-row W' if per_row else 'shared W'} (per "
                       f"{per}, Q {Q})")
                check(torch.equal(out, want_out),
                      f"B5 {tag}: kernel differs from the plain version")
                check(torch.equal(out, again),
                      f"B5 {tag}: a repeat call gave other bits")
                check(torch.equal(got, want) and torch.equal(arg, arg_p),
                      f"B4 {tag}: kernel differs from the plain version")
                err["minplus_vecmat"] = max(err["minplus_vecmat"],
                                            max_abs_err(out, want_out))
                err["minplus_vecmat_argmin"] = max(
                    err["minplus_vecmat_argmin"], max_abs_err(got, want))
                log("kernels_dense", f"B5, B4 {tag}: bit-equal (reached "
                    f"{int((arg >= 0).sum())} of {arg.numel()} targets)")
    log("kernels_dense", f"B5 minplus_vecmat: {minplus_vecmat.launches} "
        f"launches, max_abs_err {err['minplus_vecmat']} | B4 "
        f"minplus_vecmat_argmin: {minplus_vecmat_argmin.launches} launches, "
        f"max_abs_err {err['minplus_vecmat_argmin']} over {len(cases)} cases"
        f" (sparse dists and one-scenario splits included); -inf and NaN "
        f"entries counted as missing")
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
    return launches, wall_f64, sols


def same_all(a, b) -> bool:
    """Same configuration, every ConfigEval field and every meta entry
    other than the backend's name and the batch's wall time."""
    skip = ("backend", "batch_time")
    return (same_solution(a, b)
            and {k: v for k, v in a.meta.items() if k not in skip}
            == {k: v for k, v in b.meta.items() if k not in skip})


def phase_solve_many_dense(grid, dev, counters, sols_minplus, wall_minplus):
    """The dense path: solve_many(backend="dense") over the full-width grid
    on the card (the (S, S) layer matrices built on the device, B4 per
    layer), identical to the minplus solve; then the 48-scenario Fig. 5-7
    sweep at gamma = 10 against the CPU path, at n_best = 4 against minplus,
    and against the python oracle (as benchmarks/bench_table7.py:81-97)."""
    import torch
    import repro_torch as T
    from repro_torch.core import fin
    ps, ns, rs = grid
    built = []
    build = fin.batch_layer_tensors

    def counted(fgs):          # the W bytes each dense chunk builds
        Ws, init = build(fgs)
        built.append(Ws.numel() * Ws.element_size())
        return Ws, init

    fin.batch_layer_tensors = counted
    try:
        for c in counters:
            c.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sols, wall = _timed(lambda: T.solve_many(ps, ns, rs, gamma=GAMMA,
                                                 backend="dense", device=dev))
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated()
    finally:
        fin.batch_layer_tensors = build
    check(launches["minplus_vecmat_argmin"] > 0,
          "solve_many dense did not launch B4")
    check(all(same_all(a, b) for a, b in zip(sols, sols_minplus)),
          "solve_many dense differs from minplus on CUDA")
    b4_ms = profile_dense_path(grid, dev)
    log("solve_many_dense", f"{len(ps)} scenarios gamma={GAMMA} dense on "
        f"CUDA: {wall:.3f} s wall (host clock, ending in synchronize; "
        f"minplus {wall_minplus:.3f} s); Solutions identical to minplus "
        f"(config, every ConfigEval field, meta); kernel launches "
        f"{launches}; (S, S) matrices built {sum(built)} B in {len(built)} "
        f"chunks (largest {max(built)} B); max_memory_allocated {peak} B")

    sw = T.sweep_scenarios(deltas_ms=(2.0, 5.0, 8.0, 12.0),
                           uplinks_bps=(1e9, 0.5e9))
    cuda, w_cuda = _timed(lambda: T.solve_many(*sw, gamma=10,
                                               backend="dense", device=dev))
    t0 = time.perf_counter()
    cpu = T.solve_many(*sw, gamma=10, backend="dense", device="cpu")
    w_cpu = time.perf_counter() - t0
    check(all(same_all(a, b) for a, b in zip(cuda, cpu)),
          "sweep dense: CUDA differs from the CPU path")
    k_dense, w_kd = _timed(lambda: T.solve_many(
        *sw, gamma=10, n_best=N_BEST, backend="dense", device=dev))
    k_minplus = T.solve_many(*sw, gamma=10, n_best=N_BEST, device=dev)
    check(all(same_all(a, b) for a, b in zip(k_dense, k_minplus)),
          f"sweep dense n_best={N_BEST} differs from minplus on CUDA")
    t0 = time.perf_counter()
    oracle = [T.solve_fin(n_, p_, r_, gamma=10, backend="python", device=dev)
              for p_, n_, r_ in zip(*sw)]
    w_py = time.perf_counter() - t0
    agree = sum(a.found == b.found and (not a.found or (
        a.config.placement == b.config.placement and a.energy == b.energy))
        for a, b in zip(oracle, cuda))
    check(agree == len(cuda), f"sweep dense: agree {agree}/{len(cuda)} "
          f"with the python oracle")
    log("solve_many_dense", f"Fig. 5-7 sweep, {len(cuda)} scenarios gamma=10:"
        f" dense CUDA == CPU path; dense n_best={N_BEST} == minplus "
        f"n_best={N_BEST} on CUDA; agree = {agree}/{len(cuda)} against "
        f"backend='python'; wall s dense cuda {w_cuda:.3f} cpu {w_cpu:.3f}, "
        f"n_best={N_BEST} cuda {w_kd:.3f}, python oracle (per-scenario "
        f"solve_fin) {w_py:.3f}")
    del sols
    torch.cuda.empty_cache()
    return launches, wall, b4_ms


def profile_dense_path(grid, dev):
    """B4's whole device time on the dense path: torch.profiler over one
    more solve_many(backend="dense") call over the grid, the device time of
    the (min,+) kernels summed.  Returns it in ms (None if the profiler saw
    no device time)."""
    import torch
    from torch.autograd import DeviceType
    import repro_torch as T
    ps, ns, rs = grid
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tp:
        T.solve_many(ps, ns, rs, gamma=GAMMA, backend="dense", device=dev)
        torch.cuda.synchronize()
    events = [e for e in tp.key_averages()
              if e.device_type != DeviceType.CPU and "minplus" in e.key]
    if not events:
        log("solve_many_dense", "B4 device time on the path: not measured "
            "(the profiler saw no (min,+) kernel)")
        return None
    total = sum(e.self_device_time_total for e in events) / 1e3
    for e in events:
        log("solve_many_dense", f"profiled call: device {e.key[:90]}: "
            f"{e.self_device_time_total / 1e3:.4f} ms over {e.count} calls")
    log("solve_many_dense", f"B4 device time on the path (torch.profiler, "
        f"one solve_many dense call): {total:.4f} ms over "
        f"{sum(e.count for e in events)} launches")
    return total


def table7_instance():
    import repro_torch as T
    tiers = ("mobile",) + ("edge",) * (TABLE7_NODES - 2) + ("cloud",)
    return (T.make_network(tiers, compute_frac=[1e-3] * TABLE7_NODES),
            T.synthetic_profile(TABLE7_BLOCKS, 4, seed=0, ops_scale=5e7),
            T.AppRequirements(alpha=0.0, delta=20e-3))


def phase_table7_dense(dev, counters):
    """The paper's Table VII large instance through fin_all_exit_costs: the
    dense float64 relaxation (B5 per layer) bit-equal to the banded one (B1)
    on the card and to the CPU path; f32 (B5 in float32) within
    RELAX_RTOL_F32.  Returns the phase's launch counts."""
    import numpy as np
    import torch
    import repro_torch as T
    from repro_torch.core.tolerances import RELAX_RTOL_F32
    from repro_torch.kernels.minplus.ops import minplus_vecmat
    nw, pf, req = table7_instance()
    for c in counters:
        c.launches = 0
    reps = 5
    for gamma in (10, 25):
        S = TABLE7_NODES * (gamma + 1)
        call = {}
        for backend in ("numpy", "banded", "f32"):
            T.fin_all_exit_costs(nw, pf, req, gamma=gamma, backend=backend,
                                 device=dev)           # warm-up
            n5 = minplus_vecmat.launches
            t0 = time.perf_counter()
            for _ in range(reps):
                out = T.fin_all_exit_costs(nw, pf, req, gamma=gamma,
                                           backend=backend, device=dev)
            torch.cuda.synchronize()
            call[backend] = (out, (time.perf_counter() - t0) / reps,
                             (minplus_vecmat.launches - n5) // reps)
        t0 = time.perf_counter()
        cpu = T.fin_all_exit_costs(nw, pf, req, gamma=gamma, backend="numpy",
                                   device="cpu")
        w_cpu = time.perf_counter() - t0
        dense, banded, f32 = (call[b][0] for b in ("numpy", "banded", "f32"))
        check(dense.tobytes() == banded.tobytes(),
              f"table7 gamma={gamma}: dense differs from banded on CUDA")
        check(dense.tobytes() == cpu.tobytes(),
              f"table7 gamma={gamma}: dense CUDA differs from the CPU path")
        check(bool(np.isfinite(dense).all()),
              f"table7 gamma={gamma}: an exit is unreachable")
        rel = float(np.max(np.abs(f32 - dense) / dense))
        check(rel <= RELAX_RTOL_F32, f"table7 gamma={gamma}: f32 off by "
              f"{rel:.3g} relative (> {RELAX_RTOL_F32})")
        check(call["numpy"][2] == TABLE7_BLOCKS - 1,
              f"table7: B5 launched {call['numpy'][2]} times a dense call, "
              f"not {TABLE7_BLOCKS - 1}")
        log("table7_dense", f"N={TABLE7_NODES} blocks={TABLE7_BLOCKS} gamma="
            f"{gamma} (S = {S}, W {(TABLE7_BLOCKS - 1) * S * S * 8} B f64): "
            f"dense == banded == CPU path bit for bit {dense.tolist()}; f32 "
            f"within {rel:.3g} relative; B5 launches a call: numpy "
            f"{call['numpy'][2]}, f32 {call['f32'][2]}; wall ms a call "
            f"(host clock, mean of {reps}, ending in synchronize) numpy "
            f"{call['numpy'][1] * 1e3:.3f} banded "
            f"{call['banded'][1] * 1e3:.3f} f32 {call['f32'][1] * 1e3:.3f} | "
            f"CPU numpy {w_cpu * 1e3:.3f}")
    launches = {c.__name__: c.launches for c in counters}
    log("table7_dense", f"kernel launches over the phase {launches}")
    return launches

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
        req = T.PAPER_MULTIAPP_REQS[app]
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


def _plan_ticks(where, counters):
    """768 plans through the [plan] ticks on ``where``: (plans, solutions
    a tick, build s, ticks s, the kernels' launches over the ticks)."""
    import numpy as np
    import torch
    import repro_torch as T
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
    return (plans, sols, t_build, time.perf_counter() - t0,
            {c.__name__: c.launches for c in counters})


def phase_plan(dev, counters):
    """The plan IR at population size: 6 apps x 128 users at gamma = 25
    through AR(1) uplink ticks (rho 0.95, sigma 0.05, on [0.3, 1] Gb/s, as
    benchmarks/bench_online.py draws them) and one mixed delta tick, on CUDA
    and on the CPU path with identical solutions and PlanStats; then a
    cold solve_many over the plans' networks equals the warm solutions."""
    import repro_torch as T
    gpu, gsols, b_gpu, w_gpu, launches = _plan_ticks(dev, counters)
    cpu, csols, b_cpu, w_cpu, _ = _plan_ticks("cpu", counters)
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
        f"cuda {b_gpu:.3f} cpu {b_cpu:.3f} | ticks cuda {w_gpu:.3f} cpu "
        f"{w_cpu:.3f}")


def plan_times(dev, counters, reps=2):
    """The [plan] walls alone (no checks), ``reps`` times each on CUDA and
    on the CPU path, in turns."""
    for rep in range(reps):
        for where in (dev, "cpu"):
            plans, sols, t_build, t_ticks, launches = _plan_ticks(where,
                                                                  counters)
            log("times", f"[plan] {len(plans)} plans x {len(sols)} ticks on "
                f"{where} (run {rep + 1} of {reps}): wall s (host clock, "
                f"ending in synchronize) build {t_build:.3f}, ticks "
                f"{t_ticks:.3f}; B1 launches "
                f"{launches['banded_minplus_chain']}")
            del plans, sols


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


def dense_bound(dist, W, argmin):
    """(bound_ms, bound_by, bytes, ops) of one dense product on this data:
    dist read once, each W row whose dist entry is finite read once (the
    others cannot reach a target), out (and arg) written once, and one add
    plus one compare per candidate with both operands finite."""
    import torch
    B, S = dist.shape
    T_ = W.shape[-1]
    item = dist.element_size()
    live = torch.isfinite(dist)                              # (B, S)
    w_rows = int(live.sum()) if W.dim() == 3 else int(live.any(0).sum())
    nbytes = (dist.numel() * item + w_rows * T_ * item
              + B * T_ * (item + (4 if argmin else 0)))
    fin_w = torch.isfinite(W).to(dist.dtype)
    per = (live.to(dist.dtype)[:, :, None] * fin_w).sum() if W.dim() == 3 \
        else live.to(dist.dtype) @ fin_w.sum(1)[:, None]
    ops = 2 * int(per.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[str(dist.dtype).replace("torch.", "")]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def _plan_note(kind, *args) -> str:
    """The split a redesigned kernel takes at these sizes, or a note that
    this checkout's kernel has no plan (its first design)."""
    import torch
    dev = torch.device("cuda", 0)
    try:
        from repro_torch.kernels._build import sm_count
        if kind == "dense":
            from repro_torch.kernels.minplus.ops import dense_plan
            per, Q = dense_plan(*args, sm_count(dev))
            B, S, T, shared = args
            blocks = -(-B // (8 if shared else 1)) * -(-T // per) * Q
            return f"per {per}, Q {Q}, {blocks} blocks"
        from repro_torch.kernels.ee_gate.ops import gate_plan
        P = gate_plan(*args, sm_count(dev))
        return f"P {P}, {args[0] * P} blocks"
    except ImportError:
        return "first design"


def dense_times(grid, dev, err):
    """B4 and B5 at the dense path's largest launch: one layer of round 0's
    h1-h4 group (floor and ceil graphs, 20,480 rows, S = 130) in float64
    with a W per row, the layer whose input has the most reached states;
    against the plain versions and the data's bound.  Float32 at the same
    shape, and B5 at the last layer of the Table VII instance at gamma 10
    and 25 (B = 1, S = T = 165 and 390; B5's launches on its path) in
    float64 and float32.  Device ms a call from CUDA-graph replays beside
    CUDA-event means of back-to-back calls.  Returns the kernels-line rows
    and B5's (graph ms, bound ms) at the gamma-25 Table VII layer."""
    import torch
    from repro_torch.core import bellman_ford as bf
    from repro_torch.core.extended_graph import build_extended_graphs
    from repro_torch.core.feasible_graph import (batch_layer_tensors,
                                                 build_feasible_graphs)
    from repro_torch.kernels.minplus.ops import (minplus_vecmat,
                                                 minplus_vecmat_argmin)
    from repro_torch.kernels.minplus.ref import minplus_argmin_ref, minplus_ref
    for kern, (regs, smem, spill) in ptxas_usage("minplus").items():
        if "banded" not in kern:
            log("times", f"B4/B5 ptxas {kern[:90]}: {regs} registers, {smem} "
                f"B static shared memory, {spill} B spilled")
    ps, ns, rs = grid
    idx = [j for j, p in enumerate(ps) if p.n_blocks == 5]
    exts = build_extended_graphs([ns[j] for j in idx], [ps[j] for j in idx],
                                 [rs[j] for j in idx], device=dev)
    fgs = [fg for q in ("floor", "ceil")
           for fg in build_feasible_graphs(exts, GAMMA, quantize=q)]
    Ws, init = batch_layer_tensors(fgs)
    hist, _ = bf.batched_layered_relax_argmin(init, Ws)
    reached = [int(torch.isfinite(hist[:, l]).sum())
               for l in range(Ws.shape[1])]
    layer = max(range(len(reached)), key=reached.__getitem__)
    d = hist[:, layer].contiguous()
    W = Ws[:, layer].contiguous()
    del Ws, hist
    torch.cuda.empty_cache()
    rows = []
    B, S = d.shape
    T_ = W.shape[-1]
    for name, kern, plain, argmin, replaces in (
            ("minplus_vecmat_argmin", minplus_vecmat_argmin,
             minplus_argmin_ref, True,
             "src/repro/kernels/minplus/minplus.py:107"),
            ("minplus_vecmat", minplus_vecmat, minplus_ref, False,
             "src/repro/kernels/minplus/minplus.py:43")):
        ev = cuda_ms(lambda: kern(d, W), 20)
        ms = graph_ms(lambda: kern(d, W), 10) or ev
        plain_ms = cuda_ms(lambda: plain(d, W), 3, 1)
        bound, by, nbytes, ops = dense_bound(d, W, argmin)
        full = (d.numel() + W.numel() + B * T_) * 8 + (
            B * T_ * 4 if argmin else 0)
        log("times", f"{'B4' if argmin else 'B5'} {name} f64 dist "
            f"{tuple(d.shape)} W {tuple(W.shape)} per row (layer {layer}, "
            f"{reached[layer]} of {d.numel()} states reached; "
            f"{_plan_note('dense', B, S, T_, False)}): device ms a call "
            f"(CUDA graph of 10 calls) {ms:.4f}, CUDA-event mean {ev:.4f}, "
            f"plain {plain_ms:.4f}, bound {bound:.4f} ms by {by} ({nbytes} B,"
            f" {ops} ops, this data; {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s of"
            f" them achieved, {bound / ms:.1%} of the bound); all of W read "
            f"once: {full} B, {full / HBM_BYTES_PER_S * 1e3:.4f} ms")
        rows.append(dict(name=name, route="cuda", source=DENSE_SOURCE,
                         replaces=replaces, launches=None,
                         max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=None))
    d32, W32 = d.float(), W.float()
    for argmin, kern in ((True, minplus_vecmat_argmin),
                         (False, minplus_vecmat)):
        ev = cuda_ms(lambda: kern(d32, W32), 20)
        ms = graph_ms(lambda: kern(d32, W32), 10) or ev
        b32, by32, _, _ = dense_bound(d32, W32, argmin)
        log("times", f"{'B4' if argmin else 'B5'} f32 at the same shape: "
            f"device ms a call (CUDA graph) {ms:.4f}, CUDA-event mean "
            f"{ev:.4f}, bound {b32:.4f} ms by {by32} ({b32 / ms:.1%})")
    del d, W, d32, W32
    torch.cuda.empty_cache()
    nw, pf, req = table7_instance()
    at_path = None
    for gamma in (10, 25):
        fg = build_feasible_graphs(build_extended_graphs(
            [nw], [pf], [req], device=dev), gamma)[0]
        Wt = fg.layer_matrices()
        dt = bf.layered_relax(fg.init_vector(), Wt)[-2][None].contiguous()
        Wl = Wt[-1].contiguous()
        S = Wl.shape[0]
        for dtype in (torch.float64, torch.float32):
            dx, Wx = dt.to(dtype), Wl.to(dtype)
            ev = cuda_ms(lambda: minplus_vecmat(dx, Wx), 200, 10)
            ms = graph_ms(lambda: minplus_vecmat(dx, Wx), 50) or ev
            plain = graph_ms(lambda: minplus_ref(dx, Wx), 20) or \
                cuda_ms(lambda: minplus_ref(dx, Wx), 50, 5)
            bt, byt, nbt, _ = dense_bound(dx, Wx, False)
            log("times", f"B5 {str(dtype)[6:]} Table VII gamma={gamma} last "
                f"layer dist {tuple(dx.shape)} W {tuple(Wx.shape)} shared "
                f"({int(torch.isfinite(dx).sum())} of {S} states reached; "
                f"{_plan_note('dense', 1, S, S, False)}): device ms a call "
                f"(CUDA graph of 50 calls) {ms:.4f}, CUDA-event mean "
                f"{ev:.4f}, plain {plain:.4f}, bound {bt:.6f} ms by {byt} "
                f"({nbt} B)")
            if gamma == GAMMA and dtype == torch.float64:
                at_path = (ms, bt)
    return rows, at_path


def times_raw(grid, dev, gamma=GAMMA):
    """(E, steep, init) in float64 of the main path's largest launch: round
    0's five-block group (floor and ceil graphs of h1-h4), 20,480 rows."""
    import torch
    parts = [grid_tensors(grid, dev, q, gamma=gamma)[5]
             for q in ("floor", "ceil")]
    return tuple(torch.cat([p[i] for p in parts]).contiguous()
                 for i in range(3))


def times_inputs(grid, dev, gamma=GAMMA, raw=None):
    """(init, Ek, st) of the main path's largest launch (:func:`times_raw`,
    or ``raw`` where given) in float64."""
    import torch
    from repro_torch.core.bellman_ford import kernel_inputs
    E, steep, init = raw if raw is not None else times_raw(grid, dev, gamma)
    Ek, st = kernel_inputs(E, steep, torch.float64)
    return init, Ek, st


def population_inputs(grid, dev, dtype):
    """(init, Ek, st): the h1-h4 five-block tensors tiled to 2^20 rows."""
    from repro_torch.core.bellman_ford import kernel_inputs
    E, steep, init = grid_tensors(grid, dev)[5]
    reps = -(-POP_ROWS // E.shape[0])
    Ek, st = kernel_inputs(E, steep, dtype)
    return (init.to(dtype).repeat(reps, 1, 1)[:POP_ROWS].contiguous(),
            Ek.repeat(reps, 1, 1, 1)[:POP_ROWS].contiguous(),
            st.repeat(reps, 1, 1, 1)[:POP_ROWS].contiguous())


def chain_plan_sweep(init, Ek, st):
    """B1 at one shape by scenarios a group (each with its persistent grid,
    and the plan's group with one block a group as well: no ring), the
    launch plan's choice marked: device ms a call from CUDA-graph replays
    of the entry point.  Skipped for a checkout without ``chain_plan``."""
    import torch
    from repro_torch.kernels._build import launch, sm_count
    from repro_torch.kernels.minplus import ops
    if not hasattr(ops, "chain_plan"):
        return
    B, N, Gp1 = init.shape
    L = Ek.shape[1]
    n_sm = sm_count(init.device)
    plan = ops.chain_plan(B, L, N, Gp1, init.dtype, n_sm)
    hist = torch.empty((B, L, N, Gp1), dtype=init.dtype, device=init.device)
    arg = torch.empty((B, L, N, Gp1), dtype=torch.int32, device=init.device)
    name = ("banded_chain_f64" if init.dtype == torch.float64
            else "banded_chain_f32")
    runs = [(spb, *ops.chain_blocks(B, spb, L, N, Gp1, init.dtype, n_sm))
            for spb in (1, 2, 3, 4, 6, 7)
            if ops.chain_smem_bytes(spb, L, N, Gp1, init.dtype, True)
            <= ops.MAX_SMEM_BYTES]
    runs.append((plan[0], plan[1], -(-B // plan[0])))
    cols = []
    for spb, threads, blocks in runs:
        ms = graph_ms(lambda: launch(
            name, init.device, init.data_ptr(), Ek.data_ptr(), st.data_ptr(),
            hist.data_ptr(), arg.data_ptr(), B, L, N, Gp1, -1, 0, spb,
            threads, blocks), 10)
        cols.append(f"{spb} ({threads} threads, {blocks} blocks"
                    + (", the plan's" if (spb, threads, blocks) == plan
                       else "") + ") "
                    + ("not measured" if ms is None else f"{ms:.4f}"))
    fill = graph_ms(lambda: [t.fill_(0) for t in (hist, arg)], 10)
    log("times", f"B1 {str(init.dtype)[6:]} {tuple(init.shape)} L={L} by "
        f"scenarios a group, device ms a call (CUDA graph of 10 calls): "
        + ", ".join(cols) + "; filling hist and arg (two torch fill_ "
        f"calls, the card's rate of writing these bytes): "
        + ("not measured" if fill is None else f"{fill:.4f}"))


def chain_times(grid, dev, err, raw):
    """B1 at the main path's largest launch (:func:`times_inputs`) in
    float64 against its plain version and bound, and in float32; B1u at
    one scenario of it; B1 at 2^20 rows ([population]) in both dtypes; and
    ``batched_banded_relax_argmin`` whole at the 20,480-row launch (float64
    E / steep in, the solver's call).  Device ms a call from CUDA-graph
    replays beside CUDA-event means of back-to-back calls; only the public
    wrappers, so an older checkout's kernel times the same way.  Returns
    the kernels-line row.  ``raw``: :func:`times_raw`."""
    import re
    import torch
    from repro_torch.core import bellman_ford as bf
    from repro_torch.kernels.minplus import ops
    from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                                 banded_minplus_chain)
    from repro_torch.kernels.minplus.ref import (banded_minplus_chain_ref,
                                                 banded_minplus_ref)

    def timed(tag, fn, d, E, s, reps, events=20):
        ev = cuda_ms(fn, events)
        ms = graph_ms(fn, reps)
        shown = ms if ms is not None else ev
        bound, by, nbytes, ops_ = chain_bound(d, E, s, None)
        log("times", f"B1 {tag} {str(d.dtype)[6:]} {tuple(d.shape)} "
            f"L={E.shape[1]}: device ms a call (CUDA graph of {reps} calls) "
            f"{'not measured' if ms is None else f'{ms:.4f}'}, CUDA-event "
            f"mean {ev:.4f}, bound {bound:.6f} ms by {by} ({nbytes} B, "
            f"{ops_} ops; {nbytes / (shown * 1e-3) / 1e9:.1f} GB/s achieved, "
            f"{bound / shown:.1%} of the bound)")
        return shown, bound, by

    budget = getattr(ops, "CHAIN_REGISTERS", None)
    for kern, (regs, smem, spill) in ptxas_usage("banded_chain_kernel").items():
        inst = re.search(r"banded_chain_kernelI([df])(?:Li(\d+)E)?", kern)
        name = (f"{'f64' if inst[1] == 'd' else 'f32'}"
                + (f" up to {inst[2]} nodes" if inst[2] else "")
                if inst else kern[:90])
        log("times", f"B1 ptxas {name}: {regs} registers, {smem} B static "
            f"shared memory, {spill} B spilled"
            + ("" if budget is None or regs <= budget else
               f" (above the plan's budget of {budget})"))
    init, Ek, st = times_inputs(grid, dev, raw=raw)
    ms, bound, by = timed("[times]", lambda: banded_minplus_chain(init, Ek, st),
                          init, Ek, st, 20)
    chain_plan_sweep(init, Ek, st)
    plain = cuda_ms(lambda: banded_minplus_chain_ref(init, Ek, st), 3, 1)
    log("times", f"B1 [times] f64 plain {plain:.4f} ms (CUDA-event mean)")
    row = dict(name="banded_minplus_chain", route="cuda", source=KERNEL_SOURCE,
               replaces="src/repro/kernels/minplus/minplus.py:329",
               launches=None, max_abs_err=err["chain"], ms=ms,
               plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None)
    init32, Ek32 = init.float(), Ek.float()
    timed("[times]", lambda: banded_minplus_chain(init32, Ek32, st), init32,
          Ek32, st, 20)
    chain_plan_sweep(init32, Ek32, st)
    del init32, Ek32
    d1, E1, s1 = init[0].contiguous(), Ek[0, 0].contiguous(), \
        st[0, 0].contiguous()
    ev1 = cuda_ms(lambda: banded_minplus_argmin(d1, E1, s1), 200, 5)
    ms1 = graph_ms(lambda: banded_minplus_argmin(d1, E1, s1), 50)
    plain1 = graph_ms(lambda: banded_minplus_ref(d1, E1, s1), 20) or \
        cuda_ms(lambda: banded_minplus_ref(d1, E1, s1), 50, 2)
    bound1, by1, _, _ = chain_bound(d1[None], E1[None, None],
                                    s1[None, None], None)
    # B1u is off the solver's path, so it has no row in the kernels line
    log("times", f"B1u f64 {tuple(d1.shape)}: device ms a call (CUDA graph "
        f"of 50 calls) {'not measured' if ms1 is None else f'{ms1:.4f}'}, "
        f"CUDA-event mean {ev1:.4f}, plain {plain1:.4f}, bound "
        f"{bound1:.9f} ms by {by1}")
    E, steep, init64 = raw
    for tag, fn in (("batched_banded_relax_argmin", lambda:
                     bf.batched_banded_relax_argmin(init64, E, steep, None)),
                    ("kernel_inputs alone", lambda:
                     bf.kernel_inputs(E, steep, torch.float64))):
        ev = cuda_ms(fn, 20)
        ms_w = graph_ms(fn, 20)
        log("times", f"B1 path f64 {tag} at {tuple(init64.shape)} "
            f"L={E.shape[1]}: device ms a call (CUDA graph of 20 calls) "
            f"{'not measured' if ms_w is None else f'{ms_w:.4f}'}, "
            f"CUDA-event mean {ev:.4f}")
    del E, steep, init64, init, Ek, st
    torch.cuda.empty_cache()
    for dtype in (torch.float64, torch.float32):
        d, Ek, st = population_inputs(grid, dev, dtype)
        timed("[population]", lambda: banded_minplus_chain(d, Ek, st), d, Ek,
              st, 2, events=5)
        del d, Ek, st
        torch.cuda.empty_cache()
    return row


def phase_kernel_times(grid, dev, err):
    """Kernel, plain and bound at the main path's largest launch
    (:func:`times_inputs`).  Returns the kernels-line rows of the path's
    kernels."""
    raw = times_raw(grid, dev)
    rows = [chain_times(grid, dev, err, raw)]
    rows.append(kbest_times(grid, dev, err, *times_inputs(grid, dev,
                                                          raw=raw)))
    return rows


def frontier_launch(dev):
    """The inputs of the largest B3 launch of the [frontier] population on
    ``dev`` (the solver's reference to the public wrapper, wrapped for one
    pass): (init, Ek, st, K, lo, the number of launches)."""
    import numpy as np
    import repro_torch as T
    from repro_torch.core import bellman_ford as bf
    wrapped = bf.banded_minplus_chain_kbest
    largest, calls = [], [0]

    def record(dist, E, st, K, *, lo=None):
        calls[0] += 1
        if not largest or dist.numel() * E.shape[1] * K > \
                largest[0].numel() * largest[1].shape[1] * largest[3]:
            largest[:] = [dist.clone(), E.clone(), st.clone(), K, lo]
        return wrapped(dist, E, st, K, lo=lo)

    bf.banded_minplus_chain_kbest = record
    try:
        plans = _plan_population(dev, FRONTIER_USERS, n_best=N_BEST)
        rng = np.random.default_rng(5)
        T.update_uplinks(plans, rng.uniform(0.3, 1.0, len(plans)) * 1e9)
        for p in plans:
            p.frontier(k_per_exit=4)
    finally:
        bf.banded_minplus_chain_kbest = wrapped
    return (*largest, calls[0])


def kbest_plan_sweep(init, Ek, st, K):
    """B3 at one shape by scenarios a block, the launch plan's choice
    marked: device ms a call from CUDA-graph replays of the entry point.
    Skipped for a checkout without ``kbest_plan``."""
    import torch
    from repro_torch.kernels._build import launch, sm_count
    from repro_torch.kernels.minplus import ops
    if not hasattr(ops, "kbest_plan"):
        return
    B, N, Gp1 = init.shape
    L = Ek.shape[1]
    plan = ops.kbest_plan(B, N, Gp1, K, init.dtype, sm_count(init.device))
    out = [torch.empty((B, L, N, Gp1, K), dtype=dt, device=init.device)
           for dt in (init.dtype, torch.int32, torch.int32)]
    name = ("banded_chain_kbest_f64" if init.dtype == torch.float64
            else "banded_chain_kbest_f32")
    per = ops.kbest_smem_bytes(N, Gp1, K, init.dtype)
    cols = []
    for spb in (1, 2, 3, 4, 6, 8):
        threads = min(ops.KBEST_THREADS, -(-spb * N * Gp1 // 32) * 32)
        if spb * per > ops.MAX_SMEM_BYTES:
            continue
        ms = graph_ms(lambda: launch(
            name, init.device, init.data_ptr(), Ek.data_ptr(), st.data_ptr(),
            *(t.data_ptr() for t in out), B, L, N, Gp1, K, -1, spb,
            threads), 10)
        cols.append(f"{spb} ({threads} threads"
                    + (", the plan's" if (spb, threads) == plan else "")
                    + ") " + ("not measured" if ms is None else f"{ms:.4f}"))
    fill = graph_ms(lambda: [t.fill_(0) for t in out], 10)
    log("times", f"B3 {str(init.dtype)[6:]} {tuple(init.shape)} K={K} by "
        f"scenarios a block, device ms a call (CUDA graph of 10 calls): "
        + ", ".join(cols) + "; filling the three outputs (three "
        f"torch fill_ calls, the card's rate of writing these bytes): "
        + ("not measured" if fill is None else f"{fill:.4f}"))


def kbest_times(grid, dev, err, init, Ek, st):
    """B3 at the k-best path's largest launch (the [times] shape, K = 4) in
    float64 against its plain version and bound; float32 at the same
    shape, K = 32 at gamma = 10, and the largest [frontier] launch.  Device
    ms a call from CUDA-graph replays beside CUDA-event means of
    back-to-back calls; only the public wrapper, so an older checkout's
    kernel times the same way.  Returns the kernels-line row."""
    import re
    import torch
    from repro_torch.kernels.minplus.ops import banded_minplus_chain_kbest
    from repro_torch.kernels.minplus.ref import banded_minplus_chain_kbest_ref

    def timed(tag, d, E, s, K, lo=None, reps=10):
        def fn():
            return banded_minplus_chain_kbest(d, E, s, K, lo=lo)
        ev = cuda_ms(fn, 20)
        ms = graph_ms(fn, reps)
        got = fn()
        bound, by, nbytes, ops = kbest_bound(d, E, s, K, lo, got[0])
        shown = ms if ms is not None else ev
        log("times", f"B3 {tag} {str(d.dtype)[6:]} {tuple(d.shape)} "
            f"L={E.shape[1]} K={K} lo={lo}: device ms a call (CUDA graph of "
            f"{reps} calls) {'not measured' if ms is None else f'{ms:.4f}'}"
            f", CUDA-event mean {ev:.4f}, bound {bound:.6f} ms by {by} "
            f"({nbytes} B, {ops} ops, this data; "
            f"{nbytes / (shown * 1e-3) / 1e9:.1f} GB/s achieved, "
            f"{bound / shown:.1%} of the bound)")
        return shown, bound, by, got

    for kern, (regs, smem, spill) in ptxas_usage("kbest").items():
        inst = re.search(r"kernelI([df])Li(\d+)E", kern)
        name = (f"{'f64' if inst[1] == 'd' else 'f32'} up to {inst[2]} nodes"
                if inst else kern[:90])
        log("times", f"B3 ptxas {name}: {regs} registers, {smem} B static "
            f"shared memory, {spill} B spilled")
    K = N_BEST
    ms, bound, by, _ = timed("[times]", init, Ek, st, K)
    kbest_plan_sweep(init, Ek, st, K)
    plain = cuda_ms(lambda: banded_minplus_chain_kbest_ref(init, Ek, st, K),
                    3, 1)
    log("times", f"B3 [times] f64 plain {plain:.4f} ms (CUDA-event mean)")
    row = dict(name="banded_minplus_chain_kbest", route="cuda",
               source=KBEST_SOURCE,
               replaces="src/repro/kernels/minplus/minplus.py:263",
               launches=None, max_abs_err=err["kbest"], ms=ms, plain_ms=plain,
               bound_ms=bound, bound_by=by, library_ms=None)
    timed("[times]", init.float(), Ek.float(), st, K)
    init10, Ek10, st10 = times_inputs(grid, dev, gamma=10)
    got = timed("gamma=10", init10, Ek10, st10, 32, reps=5)[3]
    kbest_plan_sweep(init10, Ek10, st10, 32)
    n = 512
    want = banded_minplus_chain_kbest_ref(init10[:n], Ek10[:n], st10[:n], 32)
    check(all(torch.equal(g[:n], w) for g, w in zip(got, want)),
          "B3 K=32 gamma=10: kernel differs from the plain version")
    log("times", f"B3 gamma=10 K=32: first {n} rows bit-equal to the plain "
        f"version")
    del got, want, init10, Ek10, st10
    torch.cuda.empty_cache()
    d, E, s, Kf, lo, count = frontier_launch(dev)
    log("times", f"B3 [frontier]: the largest of {count} launches is "
        f"init {tuple(d.shape)} E {tuple(E.shape)} K={Kf} lo={lo}")
    timed("[frontier]", d, E, s, Kf, lo, reps=20)
    return row


def phase_population(grid, dev):
    """h1-h4 banded tensors tiled to 2^20 rows, relaxed in one launch."""
    import torch
    from repro_torch.kernels.minplus.ops import banded_minplus_chain
    from repro_torch.kernels.minplus.ref import banded_minplus_chain_ref
    for dtype in (torch.float64, torch.float32):
        torch.cuda.reset_peak_memory_stats()
        d, Ek, st = population_inputs(grid, dev, dtype)
        ms = cuda_ms(lambda: banded_minplus_chain(d, Ek, st), 10, 3)
        gms = graph_ms(lambda: banded_minplus_chain(d, Ek, st), 2)
        hist, par = banded_minplus_chain(d, Ek, st)
        bound, by, nbytes, ops = chain_bound(d, Ek, st, None)
        n = POP_CHECK_ROWS
        hist_p, par_p = banded_minplus_chain_ref(d[:n], Ek[:n], st[:n])
        check(torch.equal(hist[:n], hist_p) and torch.equal(par[:n], par_p),
              f"population relax {dtype}: kernel differs from the plain "
              f"version on the first {n} rows")
        check(bool(torch.isfinite(hist).any()), "population relax: no "
              "reachable state")
        shown = gms if gms is not None else ms
        log("population", f"B1 {dtype} B={POP_ROWS} L={Ek.shape[1]} N="
            f"{Ek.shape[2]} G+1={d.shape[2]}: "
            f"{'not measured' if gms is None else f'{gms:.4f}'} ms/launch "
            f"(CUDA graph of 2 calls), {ms:.4f} (CUDA-event mean of 10), "
            f"{nbytes} B moved = {nbytes / POP_ROWS:.0f} B/row, bound "
            f"{bound:.4f} ms by {by} ({nbytes / (shown * 1e-3) / 1e9:.1f} "
            f"GB/s achieved), {ops} ops; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B; first {n} rows bit-equal"
            f" to the plain version")
        del hist, par, hist_p, par_p, Ek, st, d
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the population tick: the fused ingest B2 and the Population cohort
# ---------------------------------------------------------------------------

def ingest_consts(app, dev, modes=None, delta=None, reprice=False):
    """The fused ingest's constants bundle of one app's plan on the paper
    scenario with two extra edge nodes (N = 5) at gamma = POP_GAMMA, on
    ``dev``; and the source node.  ``reprice`` takes the packs after the
    [pop_tick] mixed tick's slice (0.8) and backhaul (0.9) reprices."""
    import repro_torch as T
    from repro_torch.kernels.ee_gate.population import QuantConsts
    nw = T.paper_scenario(n_extra_edge=2)
    req = T.PAPER_MULTIAPP_REQS[app]
    p = T.Plan(nw, T.paper_profile(app), req, gamma=POP_GAMMA, device=dev)
    if reprice:
        p.update_slice(0.8)
        p.update_backhaul(0.9)
    return QuantConsts(p._bits_pack, p._C_pack, p._mask_pack, p._load_pack,
                       tuple(p._modes if modes is None else modes), POP_GAMMA,
                       req.delta if delta is None else delta), \
        nw.source_node


def ingest_rows(c, Us, seed, src):
    """Seeded (Us, N) rates that reach every edge of the quantizer and of
    B2's divide: rates aimed at integers and .5 ties of the scaled value
    (and one ulp either side), rates whose significand is all ones and
    powers of two, INGEST_EDGE_RATES, zeros, NaN, +-inf, negatives and
    rates below the loads."""
    import numpy as np
    rng = np.random.default_rng(seed)
    C = c.C_pack.cpu().numpy()
    bits = c.bits_pack.cpu().numpy()[:, 0]
    K2, N = C.shape
    vec = rng.uniform(0.05, 2.0, (Us, N)) * 1e9
    k = rng.integers(0, K2, (Us, N))
    target = rng.integers(0, c.gamma + 2, (Us, N)) \
        + rng.choice([0.0, 0.5], (Us, N))
    denom = target * c.delta / c.gamma - C[k, np.arange(N)]
    aimed = bits[k] / np.where(denom > 0, denom, np.nan)
    step = rng.integers(-1, 2, (Us, N))
    aimed = np.where(step < 0, np.nextafter(aimed, 0.0),
                     np.where(step > 0, np.nextafter(aimed, np.inf), aimed))
    vec = np.where(np.isfinite(aimed) & (rng.random((Us, N)) < 0.5), aimed,
                   vec)
    erng = np.random.default_rng(seed + 1)
    pick = erng.random((Us, N))
    two_k = 2.0 ** erng.integers(10, 40, (Us, N))
    edge = np.array(INGEST_EDGE_RATES)[erng.integers(0, len(
        INGEST_EDGE_RATES), (Us, N))]
    vec = np.where(pick < 0.06, np.nextafter(two_k, 0.0), vec)
    vec = np.where((pick >= 0.06) & (pick < 0.08), two_k, vec)
    vec = np.where((pick >= 0.08) & (pick < 0.11), edge, vec)
    special = rng.random((Us, N))
    for lo, hi, v in ((0.0, 0.04, 0.0), (0.04, 0.07, np.nan),
                      (0.07, 0.09, -1e9), (0.09, 0.11, -np.inf),
                      (0.11, 0.13, np.inf), (0.13, 0.18, 1e3)):
        vec[(special >= lo) & (special < hi)] = v
    vec[:, src] = np.inf
    return vec


def ingest_bundles(c):
    """The constants bundles B2 is checked on for one app: its plan's
    (both modes), the tighten loop's single-mode bundles at a Python
    delta_eff, synthetic packs with zero bits and zero C entries, and the
    app's packs at INGEST_EDGE_DELTAS."""
    import torch
    from repro_torch.kernels.ee_gate.population import QuantConsts
    packs = (c.bits_pack, c.C_pack, c.mask_pack, c.load_pack)
    bits0 = c.bits_pack.clone()
    bits0[::3] = 0.0
    C0 = c.C_pack.clone()
    C0[torch.arange(C0.numel(), device=C0.device).reshape(C0.shape) % 4
       == 1] = 0.0
    return ([c] + [QuantConsts(*packs, (c.modes[0],), c.gamma,
                               c.delta * 0.85 ** r) for r in (1, 6)]
            + [QuantConsts(bits0, C0, c.mask_pack, c.load_pack, c.modes,
                           c.gamma, c.delta)]
            + [QuantConsts(*packs, c.modes, c.gamma, d)
               for d in INGEST_EDGE_DELTAS])


def divide_operands(n, seed):
    """Seeded float64 (a, b) pairs in B2's fast domain (+0 or [2^-200,
    2^200]) aimed at the divide's edges: significands all ones, powers of
    two, short and random significands, the domain's ends, zero dividends,
    and the ingest's own magnitudes (bits of 1e3-1e7 over rates of
    1e5-1e10)."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def draw(lo, hi):
        e = rng.integers(lo, hi + 1, n).astype(float)
        kind = rng.integers(0, 5, n)
        m = np.where(kind == 0, 2.0 - 2.0 ** -52, np.where(
            kind == 1, 1.0, np.where(kind == 2, 1.0 + rng.integers(
                0, 2 ** 12, n) * 2.0 ** -12, 1.0 + rng.random(n))))
        return np.ldexp(m, e.astype(int))

    a, b = draw(-199, 199), draw(-199, 199)
    near = rng.random(n) < 0.3
    a = np.where(near, draw(10, 23), a)
    b = np.where(near, draw(17, 33), b)
    ends = np.array([2.0 ** -200, 2.0 ** 200 * (1 - 2.0 ** -53)])
    a[rng.random(n) < 0.02] = 0.0
    a = np.where(rng.random(n) < 0.02, ends[rng.integers(0, 2, n)], a)
    b = np.where(rng.random(n) < 0.02, ends[rng.integers(0, 2, n)], b)
    return a, b


def tick_rows(q, src, N):
    """The (U, N) staging rows ``Population.ingest(MOBILE_UPLINK_BPS * q)``
    builds: each user's rate on every link, the source column inf."""
    import numpy as np
    from repro_torch.core.scenarios import MOBILE_UPLINK_BPS
    vec = np.empty((len(q), N))
    vec[:] = (MOBILE_UPLINK_BPS * q)[:, None]
    vec[:, src] = np.inf
    return vec


def phase_kernels_ingest(dev):
    """B2 against its plain version on the card, byte for byte: the h1 /
    h4 / h6 bundles of ``ingest_bundles`` on rows that reach every edge of
    the quantizer and of the divide, at several batch sizes; then the
    kernel's fast-path divide against IEEE division on the card and on
    the host, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.kernels.ee_gate.ops import (quant_signature_divide,
                                                 quant_signature_rows)
    from repro_torch.kernels.ee_gate.ref import quant_signature_rows_ref
    quant_signature_rows.launches = 0
    err = 0.0
    for app in ("h1", "h4", "h6"):
        c, src = ingest_consts(app, dev)
        bundles = ingest_bundles(c)
        for Us in INGEST_CHECK_ROWS:
            vec = torch.as_tensor(ingest_rows(c, Us, Us + len(app), src),
                                  device=dev)
            for b in bundles:
                args = (b.bits_pack, b.C_pack, b.mask_pack, b.load_pack,
                        b.modes, b.gamma, b.delta)
                got = quant_signature_rows(vec, *args)
                want = quant_signature_rows_ref(vec, *args)
                torch.cuda.synchronize()
                tag = (f"B2 {app} Us={Us} modes={b.modes} "
                       f"delta={b.delta!r}")
                check(got.shape == (Us, b.out_width) and torch.equal(
                    got, want), f"{tag}: kernel differs from the plain "
                    f"version")
                err = max(err, float((got.int() - want.int()).abs().max()))
                log("kernels", f"{tag}: byte-equal to the plain version "
                    f"({int((want >= 0).sum())} of {want.numel()} entries "
                    f"valid, levels {int(want.max())} max)")
    log("kernels", f"B2 quant_signature_rows: {quant_signature_rows.launches}"
        f" launches, byte-equal, max_abs_err {err}")
    a, b = divide_operands(1 << 22, 21)
    got = quant_signature_divide(torch.as_tensor(a, device=dev),
                                 torch.as_tensor(b, device=dev))
    card = torch.as_tensor(a, device=dev) / torch.as_tensor(b, device=dev)
    bad = int((got.view(torch.int64) != card.view(torch.int64)).sum())
    host = int((got.cpu().numpy().view(np.int64)
                != (a / b).view(np.int64)).sum())
    check(bad == 0 and host == 0, f"B2's fast-path divide differs from IEEE "
          f"division on {bad} (card) / {host} (host) of {len(a)} pairs")
    sig = np.frexp(b)[0]
    log("kernels", f"B2 fast-path divide (one reciprocal, Markstein): "
        f"bit-equal to IEEE division on the card and on the host for all "
        f"{len(a)} seeded pairs ({int((sig == 0.5).sum())} power-of-two "
        f"divisors, {int((sig == 1 - 2.0 ** -53).sum())} all-ones divisor "
        f"significands, {int((a == 0).sum())} zero dividends)")
    return err


def _pop_cohort(where):
    import repro_torch as T
    return T.Population(T.paper_scenario(n_extra_edge=2),
                        T.paper_profile(POP_APP),
                        T.PAPER_MULTIAPP_REQS[POP_APP], POP_USERS,
                        gamma=POP_GAMMA, backend="minplus", timing=True,
                        device=where)


def _pop_draws():
    """q0 for the cold attach (the AR(1)'s stationary law, seed 4) and the
    ticks' AR(1) qualities (benchmarks/bench_online.py ``_ar1_draws``:
    rho 0.95, sigma 0.05, mean 0.65, clipped to [0.3, 1], seed 5)."""
    import numpy as np
    q0 = np.clip(np.random.default_rng(4).normal(
        0.65, 0.05 / math.sqrt(1 - 0.95 ** 2), POP_USERS), 0.3, 1.0)
    rng = np.random.default_rng(5)
    q = np.full(POP_USERS, 0.65)
    draws = []
    for _ in range(POP_TICKS):
        q = np.clip(0.65 + 0.95 * (q - 0.65)
                    + rng.normal(0, 0.05, POP_USERS), 0.3, 1.0)
        draws.append(q.copy())
    return q0, draws


def _pop_tick(pop, q, launches):
    """One tick: ingest every user's rate, the dense gate, then the solve
    of the changed and the infeasible users.  Returns its log fields."""
    import numpy as np
    import torch
    from repro_torch.core.scenarios import MOBILE_UPLINK_BPS
    s0 = dict(pop.stats.__dict__)
    n0, b0, h0, d0 = pop.n_states, launches(), pop.h2d_bytes, pop.d2h_bytes
    t0 = time.perf_counter()
    changed = pop.ingest(MOBILE_UPLINK_BPS * q)
    t1 = time.perf_counter()
    _no, feas, _en = pop.evaluate_incumbents()
    t2 = time.perf_counter()
    users = np.nonzero(changed | ~feas)[0]
    pop.solve(users, build_solutions=False)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    st = pop.stats
    relaxed = st.dp_relaxes - s0["dp_relaxes"]
    b1 = launches() - b0
    return dict(wall=t3 - t0, ingest=(st.t_ingest_ms - s0["t_ingest_ms"]),
                gate=(t2 - t1) * 1e3, relax=st.t_relax_ms - s0["t_relax_ms"],
                post=st.t_post_ms - s0["t_post_ms"],
                changed=int(changed.sum()), solved=len(users),
                born=pop.n_states - n0, relaxed=relaxed, b1=b1,
                rows=(relaxed * pop.M / b1 if b1 else 0.0),
                h2d=pop.h2d_bytes - h0, d2h=pop.d2h_bytes - d0)


def _pop_mixed(pop):
    """The mixed tick: a node failure for every 8th user (solved), the
    recovery, a compute-slice and a backhaul repricing, a whole-cohort
    solve."""
    import numpy as np
    victims = np.arange(0, pop.U, 8)
    pop.mask_node(POP_FAIL_NODE, users=victims)
    pop.solve(victims, build_solutions=False)
    pop.unmask_node(POP_FAIL_NODE, users=victims)
    pop.update_slice(0.8)
    pop.update_backhaul(0.9)
    pop.solve(build_solutions=False)


def _pop_run(where, q0, draws, launches, tag):
    """The [pop_tick] sequence on ``where``: the cold attach, the AR(1)
    ticks and the mixed tick.  Returns the cohort and the walls."""
    import torch
    from repro_torch.core.scenarios import MOBILE_UPLINK_BPS
    t0 = time.perf_counter()
    pop = _pop_cohort(where)
    pop.attach_many(MOBILE_UPLINK_BPS * q0)
    torch.cuda.synchronize()
    walls = {"attach": time.perf_counter() - t0}
    log("pop_tick", f"{tag}: cold attach of {pop.U} users (build, B2, "
        f"relax, post-pass) {walls['attach']:.3f} s, {pop.n_states} states, "
        f"{pop.h2d_bytes} B host -> device, {pop.d2h_bytes} B device -> "
        f"host")
    for t, q in enumerate(draws):
        r = _pop_tick(pop, q, launches)
        walls[f"tick{t}"] = r["wall"]
        log("pop_tick", f"{tag} tick {t}: wall {r['wall'] * 1e3:.1f} ms = "
            f"ingest {r['ingest']:.1f} + gate {r['gate']:.1f} + relax "
            f"{r['relax']:.1f} + post-pass {r['post']:.1f} (+ grouping "
            f"and the rest); {r['changed']} signatures changed, "
            f"{r['solved']} users solved, {r['born']} states born, "
            f"dp_relaxes {r['relaxed']}, B1 launches {r['b1']} "
            f"({r['rows']:.1f} rows a launch); {r['h2d']} B host -> device, "
            f"{r['d2h']} B device -> host")
    t0 = time.perf_counter()
    _pop_mixed(pop)
    torch.cuda.synchronize()
    walls["mixed"] = time.perf_counter() - t0
    log("pop_tick", f"{tag} mixed tick (failure of node {POP_FAIL_NODE} for "
        f"every 8th user, recovery, slice 0.8, backhaul 0.9, whole-cohort "
        f"solve): {walls['mixed']:.3f} s, {pop.n_states} states")
    return pop, walls


def _same_cohorts(a, b, what, stats=True):
    """Identical incumbents, inc_found, PopulationStats counters (the t_*
    timings left out) and state_dict bytes."""
    import numpy as np
    check(np.array_equal(a.inc_found, b.inc_found), f"{what}: inc_found")
    for f in ("_inc_place", "_inc_exit", "_inc_energy"):
        check(getattr(a, f).tobytes() == getattr(b, f).tobytes(),
              f"{what}: {f} differs")
    if stats:
        sa, sb = ({k: v for k, v in p.stats.__dict__.items()
                   if not k.startswith("t_")} for p in (a, b))
        check(sa == sb, f"{what}: PopulationStats differ: {sa} vs {sb}")
    da, db = a.state_dict(), b.state_dict()
    check(sorted(da) == sorted(db), f"{what}: state_dict keys differ")
    for k in da:
        check(da[k].dtype == db[k].dtype and da[k].shape == db[k].shape
              and da[k].tobytes() == db[k].tobytes(),
              f"{what}: state_dict[{k!r}] bytes differ")


def phase_pop_tick(dev, counters):
    """One h4 cohort of 1,000,000 users on the card (``Population``, gamma
    10, minplus): a cold attach at per-user rates, 8 AR(1) ticks of ingest
    (B2 over every user), dense gate and solve of the changed and the
    infeasible users, one mixed tick, then a state_dict -> restore_state
    round trip into a fresh cohort and one more tick on both.  The kernels'
    counts are reset before and read after.  The same sequence on the CPU
    path must give identical incumbents, counters and state_dict bytes, and
    B2 over each tick's rows must equal its plain version on the card."""
    import torch
    import repro_torch as T
    from repro_torch.kernels.ee_gate.ops import quant_signature_rows
    from repro_torch.kernels.ee_gate.ref import quant_signature_rows_ref
    from repro_torch.kernels.minplus.ops import banded_minplus_chain
    t_phase = time.perf_counter()
    q0, draws = _pop_draws()
    extra = draws[-1][::-1].copy()            # the tick after the restore
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    gpu, walls = _pop_run(dev, q0, draws, lambda: banded_minplus_chain
                          .launches, "cuda")
    t0 = time.perf_counter()
    snap = gpu.state_dict()
    back = _pop_cohort(dev)
    back.update_slice(0.8)
    back.update_backhaul(0.9)
    back.restore_state(snap)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    for p in (gpu, back):
        _pop_tick(p, extra, lambda: banded_minplus_chain.launches)
    launches = {c.__name__: c.launches for c in counters}
    _same_cohorts(gpu, back, "restored cohort after a tick", stats=False)
    check(launches["quant_signature_rows"] > 0, "[pop_tick] launched no B2")
    check(launches["banded_minplus_chain"] > 0, "[pop_tick] launched no B1")
    log("pop_tick", f"cuda: state_dict -> restore_state into a fresh cohort "
        f"{t_restore:.3f} s; one more tick on both: identical incumbents and "
        f"state_dict bytes; kernel launches {launches}; "
        f"{gpu.h2d_bytes} B host -> device, {gpu.d2h_bytes} B device -> host"
        f" in all")
    del snap, back
    cpu, walls_c = _pop_run("cpu", q0, draws, lambda: 0, "cpu")
    _pop_tick(cpu, extra, lambda: 0)
    _same_cohorts(gpu, cpu, "[pop_tick] CUDA vs the CPU path")
    log("pop_tick", f"{POP_USERS} users: CUDA == CPU path (incumbents, "
        f"inc_found {int(gpu.inc_found.sum())}, PopulationStats counters, "
        f"state_dict bytes); stats {gpu.stats}")
    log("pop_tick", "walls s (host clock, ending in synchronize) cuda "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()) + " | cpu "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls_c.items()))
    del cpu
    c, src = ingest_consts(POP_APP, dev)
    for t, q in enumerate([q0] + draws):
        vec = torch.as_tensor(tick_rows(q, src, gpu.N), device=dev)
        args = (c.bits_pack, c.C_pack, c.mask_pack, c.load_pack, c.modes,
                c.gamma, c.delta)
        check(torch.equal(quant_signature_rows(vec, *args),
                          quant_signature_rows_ref(vec, *args)),
              f"[pop_tick] B2 over the rows of input {t} differs from the "
              f"plain version")
    log("pop_tick", f"B2 over the {len(draws) + 1} ingests' {POP_USERS}-row "
        f"inputs: byte-equal to the plain version on the card; the phase "
        f"took {time.perf_counter() - t_phase:.1f} s")
    profile_pop_tick(gpu, draws[-1])
    return launches


def profile_pop_tick(pop, q, ticks=3):
    """Where a [pop_tick] tick's time goes: the device's busy share of
    ``ticks`` ticks (torch.profiler's device events: B2, the copies, the
    rest), then the host functions of one tick by own time (cProfile)."""
    import cProfile
    import io
    import pstats
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as tp:
        wall = sum(_pop_tick(pop, q, lambda: 0)["wall"]
                   for _ in range(ticks)) * 1e3 / ticks
    fam = {"B2": 0.0, "copies": 0.0, "other": 0.0}
    seen = dict.fromkeys(fam, 0)
    for e in tp.events():
        if e.device_type != DeviceType.CUDA:
            continue
        k = e.name.lower()
        f = "B2" if "quant_signature" in k else "copies" \
            if "memcpy" in k or "memset" in k else "other"
        fam[f] += e.device_time_total / 1e3 / ticks
        seen[f] += 1
    busy = sum(fam.values())
    if busy <= 0:
        log("pop_profile", "device time: not measured (the profiler saw no "
            "device time)")
    else:
        log("pop_profile", f"{ticks} ticks under torch.profiler: wall "
            f"{wall:.1f} ms a tick, device busy {busy:.3f} ms ({busy / wall:.1%}"
            f", idle {1 - busy / wall:.1%}): " + ", ".join(
                f"{k} {v:.3f} ms ({seen[k]} device events in all)"
                for k, v in fam.items()))
    prof = cProfile.Profile()
    prof.enable()
    _pop_tick(pop, q, lambda: 0)
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
    for line in out.getvalue().splitlines():
        if line.strip():
            log("pop_profile", line.rstrip())


def _ar1(users, ticks, seed=5, q_mean=0.65, sigma=0.05):
    """benchmarks/bench_online.py ``_ar1_draws``: AR(1) qualities, rho
    0.95, clipped to [0.3, 1]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q = np.full(users, q_mean)
    out = []
    for _ in range(ticks):
        q = np.clip(q_mean + 0.95 * (q - q_mean)
                    + rng.normal(0, sigma, users), 0.3, 1.0)
        out.append(q.copy())
    return out


def _reports(reps):
    """TickReports as dicts, the ``t_*`` timings left out."""
    import dataclasses
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if not k.startswith("t_")} for r in reps]


def _same_orchs(a, b, what):
    """Identical cohorts (``_same_cohorts`` each: incumbents, counters,
    state_dict bytes, hence n_states) and hysteresis ledgers."""
    check(len(a.pops) == len(b.pops), f"{what}: cohort count")
    for i, (p, q) in enumerate(zip(a.pops, b.pops)):
        check(p.n_states == q.n_states, f"{what}: cohort {i} n_states "
              f"{p.n_states} vs {q.n_states}")
        _same_cohorts(p, q, f"{what}, cohort {i}")
    for f in ("_ref_energy", "_cur_energy", "quality", "attached"):
        check(getattr(a, f).tobytes() == getattr(b, f).tobytes(),
              f"{what}: ledger {f} differs")


def _launch_reader():
    """Current launch counts of B1, B2 and B3."""
    from repro_torch.kernels.ee_gate.ops import quant_signature_rows
    from repro_torch.kernels.minplus.ops import (banded_minplus_chain,
                                                 banded_minplus_chain_kbest)
    return lambda: {"B1": banded_minplus_chain.launches,
                    "B2": quant_signature_rows.launches,
                    "B3": banded_minplus_chain_kbest.launches}


def _reset(counters):
    import torch
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0


def _churn_orch(where, **kw):
    import repro_torch as T
    return T.ChurnOrchestrator(population=T.population_cohorts(
        CHURN_USERS, n_extra_edge=2, device=where, timing=True),
        hysteresis=0.05, **kw)


def _churn_tick(o, q, launches):
    """One ``step_arrays`` tick with its log fields."""
    import torch
    pops = o.pops
    n0 = [p.n_states for p in pops]
    r0 = [p.stats.dp_relaxes for p in pops]
    c0 = [p.stats.quant_changed for p in pops]
    h0 = sum(p.h2d_bytes for p in pops)
    d0 = sum(p.d2h_bytes for p in pops)
    l0 = launches()
    t0 = time.perf_counter()
    rep = o.step_arrays(q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    l1 = launches()
    dl = {k: l1[k] - l0[k] for k in l1}
    rows = sum((p.stats.dp_relaxes - r) * p.M for p, r in zip(pops, r0))
    return rep, dict(
        wall=wall, launches=dl, rows=rows,
        born={p.profile.name: p.n_states - n
              for p, n in zip(pops, n0) if p.n_states != n},
        rekeyed={p.profile.name: p.stats.quant_changed - c
                 for p, c in zip(pops, c0) if p.stats.quant_changed != c},
        relaxed=sum(p.stats.dp_relaxes - r for p, r in zip(pops, r0)),
        h2d=sum(p.h2d_bytes for p in pops) - h0,
        d2h=sum(p.d2h_bytes for p in pops) - d0)


def phase_churn(dev, counters):
    """[churn]: the churn orchestrator over ``population_cohorts(1e6,
    n_extra_edge=2)`` on the card (``benchmarks/bench_online.py``'s
    pop_scale_1e6 row): 3 AR(1) ``step_arrays`` ticks, then a fresh CUDA
    twin through ``run_arrays(stream=True, stream_overlap="always")``, then
    the same ticks on the CPU path.  All three must give identical reports
    (``t_*`` left out), incumbents, state counts, counters and state_dict
    bytes.  The kernels' counts are reset just before the first CUDA run
    and read just after it."""
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    draws = _ar1(CHURN_USERS, CHURN_TICKS)
    launches = _launch_reader()
    _reset(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gpu = _churn_orch(dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    log("churn", f"cuda: ChurnOrchestrator(population_cohorts({CHURN_USERS},"
        f" n_extra_edge=2), hysteresis 0.05) init (6 cohorts, cold solve) "
        f"{t_init:.3f} s; users per cohort "
        f"{[p.U for p in gpu.pops]}; {sum(p.h2d_bytes for p in gpu.pops)} B "
        f"host -> device, {sum(p.d2h_bytes for p in gpu.pops)} B device -> "
        f"host")
    reps = []
    for t, q in enumerate(draws):
        rep, r = _churn_tick(gpu, q, launches)
        reps.append(rep)
        rows_a = r["rows"] / r["launches"]["B1"] if r["launches"]["B1"] \
            else 0.0
        log("churn", f"cuda tick {t}: wall {r['wall'] * 1e3:.1f} ms; split "
            f"(Population timing) ingest {rep.t_ingest_ms:.2f} + relax "
            f"{rep.t_relax_ms:.2f} + post-pass {rep.t_post_ms:.2f} ms (the "
            f"rest: the gate and the orchestrator's ledgers); n_resolved "
            f"{rep.n_resolved}, n_held {rep.n_held}, n_failed "
            f"{rep.n_failed}, n_migrations {rep.n_migrations}; states born "
            f"{r['born'] or 0}, re-keyed users {r['rekeyed'] or 0}, "
            f"dp_relaxes {r['relaxed']}; launches B1 {r['launches']['B1']} "
            f"({rows_a:.1f} rows a launch), B2 {r['launches']['B2']}, B3 "
            f"{r['launches']['B3']}; {r['h2d']} B host -> device, "
            f"{r['d2h']} B device -> host")
    launched = launches()
    peak = torch.cuda.max_memory_allocated()
    check(launched["B2"] > 0, "[churn] launched no B2")
    check(launched["B1"] > 0, "[churn] launched no B1")
    rekeyed = [p.profile.name for p in gpu.pops if p.stats.quant_changed]
    log("churn", f"cuda: {CHURN_TICKS} ticks launched {launched}; states "
        f"{[p.n_states for p in gpu.pops]}; cohorts that re-keyed: "
        f"{rekeyed or 'none'}; device memory high-water "
        f"{peak} B (torch.cuda.max_memory_allocated); "
        f"{sum(p.h2d_bytes for p in gpu.pops)} B host -> device and "
        f"{sum(p.d2h_bytes for p in gpu.pops)} B device -> host in all")
    t0 = time.perf_counter()
    twin = _churn_orch(dev, stream_overlap="always")
    reps_s = twin.run_arrays(np.stack(draws), stream=True)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    check(twin._overlap_used, "[churn] the streamed run did not overlap")
    check(_reports(reps_s) == _reports(reps),
          "[churn] run_arrays(stream=True) reports differ from step_arrays")
    _same_orchs(gpu, twin, "[churn] CUDA streamed vs CUDA step_arrays")
    del twin
    t0 = time.perf_counter()
    cpu = _churn_orch("cpu")
    reps_c = [cpu.step_arrays(q) for q in draws]
    t_cpu = time.perf_counter() - t0
    check(_reports(reps_c) == _reports(reps),
          "[churn] CPU path reports differ from CUDA")
    _same_orchs(gpu, cpu, "[churn] CUDA vs the CPU path")
    log("churn", f"{CHURN_USERS} users: CUDA step_arrays == CUDA run_arrays"
        f"(stream=True, overlap always) == CPU path (reports, incumbents, "
        f"n_states, counters, state_dict bytes); walls s (init and "
        f"{CHURN_TICKS} ticks, host clock): cuda streamed {t_stream:.3f}, "
        f"cpu {t_cpu:.3f}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del cpu
    profile_churn(gpu, draws[-1], launches)
    return launched


def profile_churn(o, q, launches):
    """Where a [churn] tick's time goes, on two more ``step_arrays`` ticks
    that re-solve: every quality 0.1 lower (clipped at 0.3), under
    torch.profiler (the device's busy share), then 0.2 lower, under
    cProfile (the host functions by own time)."""
    import cProfile
    import io
    import pstats
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    l0 = launches()
    with torch.profiler.profile(activities=acts) as tp:
        t0 = time.perf_counter()
        rep = o.step_arrays(np.clip(q - 0.1, 0.3, 1.0))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    l1 = launches()
    busy = sum(e.device_time_total for e in tp.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    n_dev = sum(1 for e in tp.events() if e.device_type == DeviceType.CUDA)
    log("churn_profile", f"a tick of every quality - 0.1 under "
        f"torch.profiler: wall {wall:.1f} ms, n_resolved {rep.n_resolved}, "
        f"launches {({k: l1[k] - l0[k] for k in l1})}, device busy "
        f"{busy:.3f} ms ({n_dev} device events; "
        + ("not measured: the profiler saw no device time)" if busy <= 0
           else f"busy {busy / wall:.2%}, idle {1 - busy / wall:.2%})"))
    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    rep = o.step_arrays(np.clip(q - 0.2, 0.3, 1.0))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof.disable()
    log("churn_profile", f"a tick of every quality - 0.2 under cProfile: "
        f"wall {wall:.1f} ms, n_resolved {rep.n_resolved}")
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(8)
    for line in out.getvalue().splitlines():
        if line.strip():
            log("churn_profile", line.rstrip())


def phase_congestion(dev, counters):
    """[congestion]: ``benchmarks/bench_congestion.py``'s full-mode row.
    10,000 users over ``population_cohorts(n_extra_edge=2)``, 4 AR(1)
    ticks; an uncoupled run on the card calibrates the cap (0.6 of the
    busiest shared node's load); the coupled run on the card and on the
    CPU path must give identical reports, prices and incumbents, the
    capacity must hold after the transient and the later ticks
    converge."""
    import numpy as np
    import torch
    import repro_torch as T
    t_phase = time.perf_counter()
    U = CONGESTION_USERS
    draws = _ar1(U, CONGESTION_TICKS)
    ref = T.ChurnOrchestrator(population=T.population_cohorts(
        U, n_extra_edge=2, device=dev), hysteresis=0.05)
    for q in draws:
        ref.step_arrays(quality=q)
    nl, _ll = T.accumulate_loads(ref.pops)
    N = ref.pops[0].N
    busy = int(np.argmax(np.where(np.arange(N) == ref.pops[0].src, -1.0,
                                  nl)))
    check(nl[busy] > 0, "[congestion] no load on a shared node")
    node_cap = np.full(N, np.inf)
    node_cap[busy] = nl[busy] * CONGESTION_CAP_FRAC
    launches = _launch_reader()

    def coupled(where):
        o = T.ChurnOrchestrator(population=T.population_cohorts(
            U, n_extra_edge=2, device=where), hysteresis=0.05,
            shared_capacity=T.SharedCapacity(
                node_cap=node_cap.copy(), link_cap=np.full((N, N), np.inf)))
        t0 = time.perf_counter()
        reps, prices = [], []
        for q in draws:
            reps.append(o.step_arrays(quality=q))
            prices.append((o.congestion.node_k.copy(),
                           o.congestion.link_k.copy()))
        torch.cuda.synchronize()
        return o, reps, prices, time.perf_counter() - t0

    _reset(counters)
    gpu, reps, prices, wall = coupled(dev)
    launched = launches()
    check(launched["B1"] + launched["B2"] > 0,
          "[congestion] launched no kernel")
    cpu, reps_c, prices_c, wall_c = coupled("cpu")
    check(_reports(reps_c) == _reports(reps),
          "[congestion] CPU path reports differ from CUDA")
    check(all(a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()
              for (a, b), (c, d) in zip(prices, prices_c)),
          "[congestion] price exponents differ from the CPU path")
    _same_orchs(gpu, cpu, "[congestion] CUDA vs the CPU path")
    for r in reps[1:]:
        check(r.congestion_converged, "[congestion] a post-transient tick "
              "did not converge")
    nl2, ll2 = T.accumulate_loads(gpu.pops)
    check((nl2 <= gpu.congestion.node_cap).all()
          and (ll2 <= gpu.congestion.link_cap).all(),
          "[congestion] capacity violated")
    r0 = reps[0]
    log("congestion", f"{U} users, node {busy} capped at "
        f"{CONGESTION_CAP_FRAC} of its uncoupled load ({node_cap[busy]:.6g} "
        f"ops/s): transient tick iterations {r0.congestion_iters}, repriced "
        f"{r0.n_repriced}, evicted {r0.n_evicted}, unplaced "
        f"{reps[-1].n_unplaced}; node exponents after each tick "
        f"{[list(map(int, k)) for k, _ in prices]}; later ticks converged; "
        f"load {nl2[busy]:.6g} <= cap; CUDA == CPU path (reports, prices, "
        f"incumbents, counters, state_dict bytes); launches {launched}; "
        f"coupled walls (host clock) cuda {wall:.3f} s, cpu {wall_c:.3f} s;"
        f" the phase took {time.perf_counter() - t_phase:.1f} s")
    return launched


def phase_failover(dev, counters):
    """[failover]: ``benchmarks/bench_failover.py``'s ``_tier_trace_row``
    at full mode: 64 h2 users on ``paper_scenario(n_extra_edge=1)`` through
    20 ticks of tier outages and AR(1) fading with ``contingency=True``,
    then the frozen-channel control whose failure ticks must relax
    nothing.  Hits > 0, misses == 0; CUDA equals the CPU path."""
    import torch
    import repro_torch as T
    t_phase = time.perf_counter()
    U, n_ticks = FAILOVER_USERS, FAILOVER_TICKS
    nw = T.paper_scenario(n_extra_edge=1)
    prof = T.paper_profile("h2")
    req = T.AppRequirements(alpha=0.5, delta=8e-3)
    trace = T.churn_trace(U, n_ticks, seed=3, sigma=0.05, p_fail=0.4,
                          p_recover=0.5, fail_nodes=(1, 2),
                          failure_mode="tier")
    ctrl = T.churn_trace(U, n_ticks, seed=3, sigma=0.0, q_mean=0.65,
                         p_fail=0.4, p_recover=0.5, fail_nodes=(1, 2),
                         failure_mode="tier")
    warm = [T.ChurnEvent("uplink", u, 0.65) for u in range(U)]
    launches = _launch_reader()

    def run(where):
        o = T.ChurnOrchestrator(population=T.Population(
            nw, prof, req, n_users=U, device=where), contingency=True)
        t0 = time.perf_counter()
        stats = o.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        o2 = T.ChurnOrchestrator(population=T.Population(
            nw, prof, req, n_users=U, device=where), contingency=True)
        o2.step(warm)
        r0 = o2.pops[0].stats.dp_relaxes
        stats2 = o2.run(ctrl)
        return o, stats, o2, stats2, o2.pops[0].stats.dp_relaxes - r0, wall

    _reset(counters)
    o, stats, o2, stats2, fail_relax, wall = run(dev)
    launched = launches()
    hits = int(stats.total("contingency_hits"))
    misses = int(stats.total("contingency_misses"))
    prebuilt = int(stats.total("contingency_prebuilt"))
    check(hits > 0 and misses == 0,
          f"[failover] hits {hits}, misses {misses}")
    check(fail_relax == 0, f"[failover] the frozen-channel control's "
          f"failure ticks relaxed {fail_relax} states")
    check(launched["B1"] > 0, "[failover] launched no B1")
    c, cstats, c2, cstats2, c_fail, wall_c = run("cpu")
    check(_reports(cstats.ticks) == _reports(stats.ticks)
          and _reports(cstats2.ticks) == _reports(stats2.ticks),
          "[failover] CPU path reports differ from CUDA")
    _same_orchs(o, c, "[failover] CUDA vs the CPU path")
    _same_orchs(o2, c2, "[failover] control, CUDA vs the CPU path")
    outages = sum(1 for evs in trace if any(e.kind == "fail" for e in evs))
    log("failover", f"{U} h2 users, {n_ticks} ticks, {outages} outage "
        f"ticks: hits {hits}, misses {misses}, prebuilt states {prebuilt}; "
        f"frozen-channel control: failure-tick dp_relaxes {fail_relax}; "
        f"CUDA == CPU path (reports, incumbents, counters, state_dict "
        f"bytes); launches {launched}; walls of the trace (host clock) cuda "
        f"{wall:.3f} s, cpu {wall_c:.3f} s; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


def phase_multiapp(dev, counters):
    """[multiapp]: ``benchmarks/bench_fig8.py``'s population variant,
    ``run_multiapp(200, seed=1)`` with continuous draws and with 16 uplink
    buckets, on the card and on the CPU path: every ``AppStats`` field
    (``solve_time`` left out), ``energy_gain`` and the cache hits equal."""
    import dataclasses
    import numpy as np
    import torch
    import repro_torch as T
    t_phase = time.perf_counter()

    def fields(res):
        out = {}
        for app, by in res.stats.items():
            for name, st in by.items():
                d = dataclasses.asdict(st)
                d.pop("solve_time")
                d["exit_usage"] = d["exit_usage"].tobytes()
                out[app, name] = d
        return out

    launches = _launch_reader()
    _reset(counters)
    walls = {}
    res = {}
    for where in (dev, "cpu"):
        for buckets in (None, MULTIAPP_BUCKETS):
            t0 = time.perf_counter()
            res[str(where), buckets] = T.run_multiapp(
                MULTIAPP_USERS, seed=1, uplink_buckets=buckets, device=where)
            torch.cuda.synchronize()
            walls[str(where), buckets] = time.perf_counter() - t0
        if where is dev:
            launched = launches()
    check(launched["B1"] > 0, "[multiapp] launched no B1")
    for buckets in (None, MULTIAPP_BUCKETS):
        g, c = res[str(dev), buckets], res["cpu", buckets]
        check(fields(g) == fields(c), f"[multiapp] AppStats differ from the "
              f"CPU path (buckets {buckets})")
        for app in g.stats:
            a, b = g.energy_gain(app), c.energy_gain(app)
            check(a == b or (np.isnan(a) and np.isnan(b)),
                  f"[multiapp] energy_gain({app}) differs")
    b = res[str(dev), MULTIAPP_BUCKETS]
    hits = sum(b.stats[a]["mcp"].solve_cache_hits for a in b.stats)
    gains = {a: round(float(res[str(dev), None].energy_gain(a)), 6)
             for a in b.stats}
    log("multiapp", f"run_multiapp({MULTIAPP_USERS}, seed=1): CUDA == CPU "
        f"path (every AppStats field, energy_gain, cache hits), continuous "
        f"and {MULTIAPP_BUCKETS} buckets; FIN/MCP energy {gains}; MCP "
        f"bucket cache hits {hits}; launches {launched}; walls s (host "
        f"clock) " + ", ".join(f"{w} buckets {k}: {v:.3f}"
                               for (w, k), v in walls.items())
        + f"; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# fault tolerance: checkpoint / resume, the users mesh, elastic failover
# ---------------------------------------------------------------------------

def _timed_method(obj, name, walls):
    """Wrap ``obj.name`` so that each call's wall (host clock, ending in
    synchronize) is appended to ``walls``."""
    import torch
    orig = getattr(obj, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, timed)


def _join_relaxes(o):
    """Let a crashed orchestrator's in-flight background relaxations end
    (its cohorts' one-thread executors) before anything else runs."""
    import torch
    for p in o.pops:
        if p._relax_executor is not None:
            p._relax_executor.shutdown(wait=True)
    torch.cuda.synchronize()


def _same_resumed(a, b, what):
    """Identical incumbents and state_dict bytes (cohort by cohort) and
    hysteresis ledgers; the cumulative PopulationStats of a resumed run
    start at its restore, so its counters are compared through the
    reports."""
    check(len(a.pops) == len(b.pops), f"{what}: cohort count")
    for i, (p, q) in enumerate(zip(a.pops, b.pops)):
        check(p.n_states == q.n_states, f"{what}: cohort {i} n_states")
        _same_cohorts(p, q, f"{what}, cohort {i}", stats=False)
    for f in ("_ref_energy", "_cur_energy", "quality", "attached"):
        check(getattr(a, f).tobytes() == getattr(b, f).tobytes(),
              f"{what}: ledger {f} differs")


def phase_resume(dev, counters):
    """[resume]: the [churn] configuration (``population_cohorts(1e6,
    n_extra_edge=2)``, hysteresis 0.05, ``_ar1`` draws) through
    ``RESUME_TICKS`` ticks of ``run_arrays(checkpoint_dir=,
    checkpoint_every=2, checkpoint_keep=2)`` with an injected crash after
    tick 3 (stage ``post``), synchronous and streamed.  Each crash must
    raise ``InjectedCrash``; a fresh CUDA orchestrator's ``resume`` must
    give the tail reports, incumbents and state_dict bytes of an
    uninterrupted CUDA run, which equals the CPU path; the CUDA checkpoint
    resumed on the CPU path gives the same tail.  The kernels' counts are
    reset before the resumes and read after."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.faults import FaultPlan, FaultSpec, InjectedCrash
    from repro_torch.runtime import checkpoint as ckpt
    t_phase = time.perf_counter()
    Q = np.stack(_ar1(CHURN_USERS, RESUME_TICKS))
    launches = _launch_reader()
    t0 = time.perf_counter()
    clean = _churn_orch(dev)
    reps = clean.run_arrays(Q, stream=False)
    torch.cuda.synchronize()
    wall_clean = time.perf_counter() - t0
    cpu = _churn_orch("cpu")
    check(_reports(cpu.run_arrays(Q, stream=False)) == _reports(reps),
          "[resume] uninterrupted CPU path reports differ from CUDA")
    _same_resumed(clean, cpu, "[resume] uninterrupted CUDA vs CPU path")
    del cpu
    plan = FaultPlan(specs=[FaultSpec(kind="crash", tick=RESUME_CRASH,
                                      stage="post")])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    totals = {"B1": 0, "B2": 0, "B3": 0}
    try:
        for stream in (False, True):
            d = str(Path(tmp) / ("stream" if stream else "sync"))
            crashed = _churn_orch(dev, stream_overlap="always")
            saves = []
            _timed_method(crashed, "checkpoint", saves)
            t0 = time.perf_counter()
            try:
                crashed.run_arrays(Q, stream=stream, checkpoint_dir=d,
                                   checkpoint_every=2, checkpoint_keep=2,
                                   fault_plan=plan)
                raise PhaseFailed("[resume] the injected crash did not fire")
            except InjectedCrash:
                pass
            _join_relaxes(crashed)
            wall_crash = time.perf_counter() - t0
            del crashed
            steps = ckpt.available_steps(d)
            check(1 <= len(steps) <= 2, f"[resume] {len(steps)} checkpoints "
                  f"on disk (keep 2)")
            files = list(Path(d).rglob("*"))
            nbytes = sum(f.stat().st_size for f in files if f.is_file())
            raw = (Path(d) / f"step_{steps[-1]:012d}" / ckpt.ARRAYS
                   ).read_bytes()[:4]
            zstd = raw == ckpt._ZSTD_MAGIC
            _reset(counters)
            resumed = _churn_orch(dev, stream_overlap="always")
            rest = []
            _timed_method(resumed, "restore", rest)
            l0 = launches()
            t0 = time.perf_counter()
            tail = resumed.resume(d, Q, stream=stream)
            torch.cuda.synchronize()
            wall_resume = time.perf_counter() - t0
            l1 = launches()
            pos = RESUME_TICKS - len(tail)
            check(pos == RESUME_CRASH - RESUME_CRASH % 2,
                  f"[resume] resumed at trace position {pos}")
            check(_reports(tail) == _reports(reps[pos:]),
                  f"[resume] stream={stream}: resumed tail reports differ "
                  f"from the uninterrupted run")
            _same_resumed(clean, resumed, f"[resume] stream={stream}: "
                          f"resumed vs uninterrupted")
            for k in totals:
                totals[k] += l1[k] - l0[k]
            # the restore re-relaxes every state that held grids (B1); the
            # tail's ingest launches B2 only for re-solved users' rows
            check(l1["B1"] - l0["B1"] > 0,
                  f"[resume] the resume launched no B1 ({l1})")
            del resumed
            on_cpu = _churn_orch("cpu")
            check(_reports(on_cpu.resume(d, Q, stream=stream))
                  == _reports(reps[pos:]),
                  "[resume] the CUDA checkpoint resumed on the CPU path "
                  "gives another tail")
            _same_resumed(clean, on_cpu, "[resume] CUDA checkpoint resumed "
                          "on the CPU path")
            del on_cpu
            log("resume", f"stream={stream}: {CHURN_USERS} users, "
                f"{RESUME_TICKS} ticks, checkpoint_every 2, crash after "
                f"tick {RESUME_CRASH} (post) raised InjectedCrash after "
                f"{wall_crash:.3f} s (init, ticks, saves); checkpoints on "
                f"disk {steps} ({nbytes} B, zstd {zstd}); save walls s "
                f"{[round(w, 3) for w in saves]}; restore wall "
                f"{rest[0]:.3f} s; resume (restore + {len(tail)} ticks) "
                f"{wall_resume:.3f} s; launches of the resume B1 "
                f"{l1['B1'] - l0['B1']}, B2 {l1['B2'] - l0['B2']}, B3 "
                f"{l1['B3'] - l0['B3']}; tail == uninterrupted CUDA run "
                f"(reports, incumbents, state_dict bytes, ledgers) == the "
                f"CPU path == this checkpoint resumed on the CPU path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("resume", f"uninterrupted CUDA run (init + {RESUME_TICKS} ticks) "
        f"{wall_clean:.3f} s; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return totals


def _mesh_cohort(where, backend):
    import repro_torch as T
    return T.Population(T.paper_scenario(n_extra_edge=2),
                        T.paper_profile(POP_APP),
                        T.PAPER_MULTIAPP_REQS[POP_APP], POP_USERS,
                        gamma=POP_GAMMA, backend=backend, timing=True,
                        device=where)


def _mesh_run(where, backend, q0, draws):
    """[pop_tick]'s cold attach, AR(1) ticks and mixed tick (failures for
    every 8th user, recovery, slice and backhaul repricings: newborn
    states for the relaxer) on one cohort."""
    import numpy as np
    import torch
    from repro_torch.core.scenarios import MOBILE_UPLINK_BPS
    t0 = time.perf_counter()
    pop = _mesh_cohort(where, backend)
    pop.attach_many(MOBILE_UPLINK_BPS * q0)
    walls = [time.perf_counter() - t0]
    for q in draws:
        t0 = time.perf_counter()
        changed = pop.ingest(MOBILE_UPLINK_BPS * q)
        _no, feas, _en = pop.evaluate_incumbents()
        pop.solve(np.nonzero(changed | ~feas)[0], build_solutions=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    _pop_mixed(pop)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    return pop, walls


def phase_mesh(dev, counters):
    """[mesh]: ``Population(backend="mesh")`` of the [pop_tick] cohort
    (1,000,000 h4 users, gamma 10) on ``cuda:0`` through [pop_tick]'s cold
    attach, AR(1) draws and mixed tick: a users mesh over the visible
    cards, one float32 B1 launch a shard a relax.  It must equal the same
    cohort on the CPU path (incumbents, counters, state_dict bytes) and a
    ``backend="f32"`` CUDA cohort (incumbents: every user's placement,
    exit and energy).  With more than one card, ragged stacks through the
    mesh of every card equal a one-card relaxer's.  Then the retry ladder
    on the cohort's relaxer: a stall within the budget is retried and stays
    exact; one that never heals is demoted down to one card and raises
    there."""
    import numpy as np
    import torch
    from repro_torch.core.faults import FaultPlan
    t_phase = time.perf_counter()
    q0, draws = _pop_draws()
    launches = _launch_reader()
    _reset(counters)
    gpu, walls = _mesh_run(dev, "mesh", q0, draws)
    launched = launches()
    rx = gpu._mesh_relaxer
    check(rx is not None, "[mesh] the cohort built no relaxer")
    n_cards = rx.n_devices
    fused = gpu.stats.fused_relaxes
    check(launched["B1"] >= fused * rx.n_devices > 0,
          f"[mesh] B1 launches {launched['B1']} < mesh relaxes {fused} x "
          f"shards {rx.n_devices}")
    check(launched["B2"] > 0, "[mesh] launched no B2")
    f32, walls_f = _mesh_run(dev, "f32", q0, draws)
    for f in ("_inc_place", "_inc_exit", "_inc_energy"):
        check(getattr(gpu, f).tobytes() == getattr(f32, f).tobytes(),
              f"[mesh] {f} differs from the f32 CUDA cohort")
    del f32
    cpu, walls_c = _mesh_run("cpu", "mesh", q0, draws)
    _same_cohorts(gpu, cpu, "[mesh] CUDA vs the CPU path")
    del cpu
    if rx.n_devices > 1:
        from repro_torch.sharding import MeshRelaxer, PopulationMesh
        one = MeshRelaxer(PopulationMesh((torch.device(dev),)))
        init, E, steep = _rank_problem(0)
        for D in (1, rx.n_devices + 1, 3 * rx.n_devices - 1, len(init)):
            a = rx.relax(init[:D], E[:D], steep[:D], None)
            b = one.relax(init[:D], E[:D], steep[:D], None)
            check(all(x.tobytes() == y.tobytes() for x, y in zip(a, b)),
                  f"[mesh] {rx.n_devices} cards != one card at {D} chains")
        log("mesh", f"ragged stacks of 1 .. {len(init)} chains over "
            f"{rx.n_devices} cards == one card (hist, parents)")
    # the retry ladder on the cohort's relaxer, on its own stacks
    states = [s for s in gpu._states if s.dps is not None][:64]
    grid = torch.cat([s.grid for s in states])
    steep = torch.cat([s.steep for s in states])
    E_one = gpu._proto._ext.E
    E = E_one[None].expand((len(grid),) + tuple(E_one.shape))
    lo = gpu.depth_window_lo
    rx.backoff_s, rx.max_retries = 0.0, 2
    h0, p0 = rx.relax(grid, E, steep, lo)
    r0, d0 = rx.retries, rx.demotions
    rx.fault_hook = FaultPlan.stall_hook(2)
    h1, p1 = rx.relax(grid, E, steep, lo)
    check((rx.retries - r0, rx.demotions - d0) == (2, 0)
          and h1.tobytes() == h0.tobytes() and p1.tobytes() == p0.tobytes(),
          "[mesh] a stall within the retry budget was not retried exactly")
    rx.fault_hook = FaultPlan.stall_hook(10 ** 6)
    try:
        rx.relax(grid, E, steep, lo)
        raise PhaseFailed("[mesh] a stall that never heals did not raise")
    except TimeoutError:
        pass
    check(rx.n_devices == 1 and rx.demotions - d0 == (n_cards > 1),
          "[mesh] the ladder was not taken to its bottom")
    rx.fault_hook = None
    log("mesh", f"{POP_USERS} h4 users, backend mesh on {n_cards} "
        f"card(s): cold attach + {len(draws)} AR(1) ticks + the mixed tick;"
        f" walls s (host clock) mesh "
        + ", ".join(f"{w:.3f}" for w in walls) + " | f32 "
        + ", ".join(f"{w:.3f}" for w in walls_f) + " | cpu mesh "
        + ", ".join(f"{w:.3f}" for w in walls_c)
        + f"; {gpu.n_states} states, mesh relaxes {fused}, launches "
        f"{launched} (B1 >= relaxes x shards); relaxer bytes "
        f"{rx.h2d_bytes} up, {rx.d2h_bytes} down; == the CPU path "
        f"(incumbents, counters, state_dict bytes) == the f32 CUDA cohort "
        f"(incumbents); stall_hook(2) with max_retries 2: retried twice, "
        f"exact, no demotion; a stall that never heals raised "
        f"TimeoutError after {rx.retries - r0 - 2} more retries and "
        f"{rx.demotions - d0} demotions; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


def _rank_problem(rank):
    """A rank's ragged shard at the [mesh] cohort's widths (h4: 4 layers,
    N 5, G+1 11): MULTIHOST_ROWS + 7 * rank chains, from a seed."""
    import numpy as np
    rng = np.random.default_rng(60 + rank)
    D, L, N, Gp1 = MULTIHOST_ROWS + 7 * rank, 4, 5, POP_GAMMA + 1
    steep = np.where(rng.random((D, L, N, N)) < 0.5,
                     rng.integers(0, Gp1 - 1, (D, L, N, N)).astype(float),
                     np.inf)
    E = rng.random((D, L, N, N))
    init = np.where(rng.random((D, N, Gp1)) < 0.3,
                    rng.random((D, N, Gp1)), np.inf)
    return init, E, steep


def multihost_rank(rank, world, port):
    """One gloo rank of [multihost] (``chip_smoke.py --multihost-rank``):
    its ragged shard through the two-rank mesh on ``cuda:0`` equals a local
    relaxer; the symmetric stall schedule demotes it once, exactly; the
    orchestrator's gather sees both ranks' relax times."""
    import numpy as np
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.core.faults import FaultPlan
        from repro_torch.kernels.minplus.ops import banded_minplus_chain
        from repro_torch.sharding import (MeshRelaxer, PopulationMesh,
                                          population_mesh)
        dev = torch.device("cuda", 0)
        init, E, steep = _rank_problem(rank)
        dev_in = [torch.as_tensor(x, device=dev) for x in (init, E, steep)]
        mr = MeshRelaxer(population_mesh(), timeout_s=120.0)
        cards = torch.cuda.device_count()
        check(mr.multihost and mr.n_devices == world * cards,
              f"rank {rank}: mesh of {mr.n_devices} devices")
        banded_minplus_chain.launches = 0
        t0 = time.perf_counter()
        hist, par = mr.relax(*dev_in, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = banded_minplus_chain.launches
        local = MeshRelaxer(PopulationMesh((dev,)))
        hl, pl = local.relax(*dev_in, None)
        check(hist.tobytes() == hl.tobytes() and par.tobytes() ==
              pl.tobytes(), f"rank {rank}: global != local")
        drop = MeshRelaxer(population_mesh(), max_retries=1, backoff_s=0.0,
                           timeout_s=120.0)
        drop.fault_hook = FaultPlan.stall_hook(2)
        hd, pd = drop.relax(*dev_in, None)
        check((drop.demotions, drop.retries) == (1, 1)
              and not drop.multihost, f"rank {rank}: ladder "
              f"{drop.demotions} demotions, {drop.retries} retries")
        check(hd.tobytes() == hl.tobytes() and pd.tobytes() == pl.tobytes(),
              f"rank {rank}: inexact after the demotion")
        print(f"[multihost] rank {rank}: {len(init)} chains, global == local"
              f" exact ({wall * 1e3:.1f} ms, B1 launches {launches}, "
              f"{mr.h2d_bytes} B up, {mr.d2h_bytes} B down); demoted once "
              f"(1 retry), exact", flush=True)
    finally:
        dist.destroy_process_group()


def phase_multihost():
    """[multihost]: this script started twice as gloo ranks on the one card
    (``--multihost-rank r 2 port``); both must exit 0 and report their
    checks."""
    import socket
    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--multihost-rank", str(r), "2", str(port)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    b1 = 0
    for r, (rc, out) in enumerate(outs):
        tail = "\n".join(out.splitlines()[-15:])
        check(rc == 0, f"[multihost] rank {r} exited {rc}:\n{tail}")
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"[multihost] rank {r}:")]
        check(len(line) == 1, f"[multihost] rank {r} printed no result")
        print(line[0], flush=True)
        b1 += int(line[0].split("B1 launches ")[1].split(",")[0])
    log("multihost", f"2 gloo ranks on one card, ragged shards "
        f"{MULTIHOST_ROWS} / {MULTIHOST_ROWS + 7}: both exact, both demoted "
        f"once; B1 launches in the ranks' mesh relaxes {b1}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"B1": b1, "B2": 0, "B3": 0}


def _elastic_plans(where):
    import numpy as np
    import repro_torch as T
    from repro_torch.core.scenarios import MOBILE_UPLINK_BPS
    nw = T.paper_scenario(n_extra_edge=1)
    prof = T.paper_profile("h2")
    req = T.AppRequirements(alpha=0.5, delta=8e-3)
    q = np.random.default_rng(8).uniform(0.3, 1.0, ELASTIC_PLANS)
    plans = []
    for u in range(ELASTIC_PLANS):
        p = T.Plan(nw, prof, req, device=where)
        p.update_uplink(MOBILE_UPLINK_BPS * q[u])
        p.solve()
        plans.append(p)
    return plans


def _elastic_run(where, library):
    """Fail and recover every non-mobile node of every plan through
    ``fin_failover``; each failure's solution is held to a cold
    ``solve_fin`` on the reduced network.  Returns the outcomes as
    comparable tuples and the library hits."""
    import numpy as np
    import repro_torch as T
    from repro_torch.runtime.elastic import fin_failover
    plans = _elastic_plans(where)
    out, hits = [], 0
    for plan in plans:
        lib = None
        if library:
            lib = T.ContingencyLibrary(plan)
            lib.refill()
        for node in range(1, plan.network.n_nodes):
            for recover in (False, True):
                r = fin_failover(plan, node, recover=recover, library=lib)
                hits += r.library_hit
                sol = r.solution
                out.append((sol.found, sol.energy if sol.found else None,
                            tuple(sol.config.placement) if sol.found
                            else None, r.blocks_moved, r.migration_bits,
                            r.library_hit))
                if recover:
                    continue
                nw = plan.network
                keep = [i for i in range(nw.n_nodes) if i != node]
                red = T.Network(nodes=[nw.nodes[i] for i in keep],
                                bandwidth=nw.bandwidth[np.ix_(keep, keep)]
                                .copy(), compute=nw.compute[keep].copy(),
                                source_node=0)
                cold = T.solve_fin(red, plan.profile, plan.req,
                                   device=where)
                check(cold.found == sol.found
                      and (not sol.found or (
                          cold.energy == sol.energy
                          and [keep[p] for p in cold.config.placement]
                          == sol.config.placement)),
                      f"[elastic] fin_failover of node {node} differs from "
                      f"a cold solve_fin on the reduced network")
    return out, hits


def phase_elastic(dev, counters):
    """[elastic]: ``fin_failover`` over ``ELASTIC_PLANS`` h2 ``Plan``s on
    the card, failing and recovering each non-mobile node, without and with
    a ``ContingencyLibrary``: each failure equals a cold ``solve_fin`` on
    the reduced network, the library serves hits with identical outcomes,
    and the whole sequence equals the CPU path.  Then the mesh planner for
    qwen3-4b."""
    import torch
    from repro_torch.configs import get
    from repro_torch.runtime.elastic import (MeshPlan, candidate_meshes,
                                             plan_rescale)
    t_phase = time.perf_counter()
    launches = _launch_reader()
    _reset(counters)
    walls, res = {}, {}
    for where in (dev, "cpu"):
        for library in (False, True):
            t0 = time.perf_counter()
            res[str(where), library] = _elastic_run(where, library)
            torch.cuda.synchronize()
            walls[str(where), library] = time.perf_counter() - t0
        if where is dev:
            launched = launches()
    check(launched["B1"] > 0, "[elastic] launched no B1")
    for library in (False, True):
        check(res[str(dev), library] == res["cpu", library],
              f"[elastic] CUDA differs from the CPU path (library "
              f"{library})")
    plain, _ = res[str(dev), False]
    with_lib, hits = res[str(dev), True]
    check(hits > 0, "[elastic] the library served no hit")
    check([o[:5] for o in plain] == [o[:5] for o in with_lib],
          "[elastic] library outcomes differ from the warm re-solves")
    cfg = get("qwen3-4b")
    cands = candidate_meshes(cfg, 250)
    resc = plan_rescale(cfg, MeshPlan(data=16, model=16), 240,
                        param_bytes=8.8e9, global_batch=256)
    check(bool(cands) and resc is not None, "[elastic] no mesh for qwen3-4b")
    log("elastic", f"{ELASTIC_PLANS} h2 plans x {len(plain) // ELASTIC_PLANS}"
        f" failovers (fail + recover of each non-mobile node): each failure"
        f" == cold solve_fin on the reduced network; library hits {hits} of "
        f"{len(with_lib)}, outcomes identical to the warm re-solves; CUDA "
        f"== CPU path; launches {launched}; walls s (host clock) "
        + ", ".join(f"{w} library {k}: {v:.3f}" for (w, k), v in
                    walls.items())
        + f"; qwen3-4b: candidate_meshes(250) best {cands[0]}, "
        f"plan_rescale(16x16 -> 240 chips) new {resc.new}, moved "
        f"{resc.moved_bytes:.4g} B, batch_ok {resc.batch_ok}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


def ingest_times(dev, err):
    """B2 at the population tick's ingest, 1e6 rows, for h4 (the [pop_tick]
    cohort: 90 int16 a row) and h6 (L = 3: 50): device ms a call from
    CUDA-graph replays against the byte bound and the plain version,
    beside CUDA-event means.  Returns the kernels-line row of h4."""
    import numpy as np
    import torch
    from repro_torch.kernels.ee_gate.ops import quant_signature_rows
    from repro_torch.kernels.ee_gate.ref import quant_signature_rows_ref
    import re
    usage = ptxas_usage("quant_signature_kernel")
    shapes = {}
    for name, (regs, _smem, spill) in usage.items():
        m = re.search(r"ILi(n?\d+)ELi(n?\d+)ELi(n?\d+)ELi(n?\d+)E", name)
        key = tuple(int(x.replace("n", "-")) for x in m.groups()) if m \
            else name
        shapes[key] = (regs, spill)
    if shapes:
        regs = [r for r, _ in shapes.values()]
        log("times", f"B2 ptxas: {len(shapes)} instantiations ((2L-1, N) "
            f"x modes), {min(regs)}-{max(regs)} registers, "
            f"{max(sp for _, sp in shapes.values())} B spilled at most; "
            + ", ".join(f"(K2, N, mode0, mode1) {k}: {r} registers, {sp} B "
                        f"spilled" for k, (r, sp) in sorted(
                            shapes.items(), key=str)
                        if k in ((9, 5, 0, 1), (5, 5, 0, 1), (0, 0, 0, 1))))
    row = None
    q = np.clip(np.random.default_rng(5).normal(0.65, 0.16, POP_USERS), 0.3,
                1.0)
    for app in INGEST_TIME_APPS:
        c, src = ingest_consts(app, dev)
        vec = torch.as_tensor(tick_rows(q, src, c.C_pack.shape[1]),
                              device=dev)
        args = (c.bits_pack, c.C_pack, c.mask_pack, c.load_pack, c.modes,
                c.gamma, c.delta)
        ev = cuda_ms(lambda: quant_signature_rows(vec, *args), 50, 5)
        ms = graph_ms(lambda: quant_signature_rows(vec, *args), 20) or ev
        plain = graph_ms(lambda: quant_signature_rows_ref(vec, *args), 3) \
            or cuda_ms(lambda: quant_signature_rows_ref(vec, *args), 5, 1)
        nbytes = (vec.numel() * 8 + POP_USERS * c.out_width * 2
                  + sum(t.numel() * t.element_size() for t in args[:4]))
        ops = 4 * vec.numel() * c.C_pack.shape[0]   # 2 div, add, mul a slot
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float64"]
        bound = max(t_b, t_o) * 1e3
        by = "bytes" if t_b >= t_o else "operations"
        log("times", f"B2 {app} {POP_USERS} rows x {c.out_width} int16: "
            f"device ms a call (CUDA graph of 20 calls, plain 3) kernel "
            f"{ms:.4f}, plain {plain:.4f} | CUDA-event mean {ev:.4f} | bound "
            f"{bound:.6f} ms by {by} ({nbytes} B, {ops} ops, "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved, "
            f"{bound / ms:.1%} of the bound)")
        if app == POP_APP:
            row = dict(name="quant_signature_rows", route="cuda",
                       source=INGEST_SOURCE,
                       replaces="src/repro/kernels/ee_gate/population.py:136",
                       launches=None, max_abs_err=err, ms=ms, plain_ms=plain,
                       bound_ms=bound, bound_by=by, library_ms=None)
        del vec
    torch.cuda.empty_cache()
    ingest_pack_times(dev)
    return row


def ingest_pack_times(dev):
    """B2 on the [pop_tick] cohort's rows (its last AR(1) draw) with the
    packs before and after the mixed tick's slice and backhaul reprices,
    device ms a call by three methods on the same inputs: CUDA-graph
    replays, CUDA events around single synchronized launches (as a tick
    launches it), and torch.profiler's kernel times (as [pop_profile]
    reads them)."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.kernels.ee_gate.ops import quant_signature_rows
    _q0, draws = _pop_draws()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for tag, reprice in (("before", False), ("after", True)):
        c, src = ingest_consts(POP_APP, dev, reprice=reprice)
        vec = torch.as_tensor(tick_rows(draws[-1], src, c.C_pack.shape[1]),
                              device=dev)
        args = (c.bits_pack, c.C_pack, c.mask_pack, c.load_pack, c.modes,
                c.gamma, c.delta)
        fn = lambda: quant_signature_rows(vec, *args)
        ms = graph_ms(fn, 20)
        single = sorted(cuda_ms(fn, 1, 1) for _ in range(10))
        with torch.profiler.profile(activities=acts) as tp:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        prof = [e.device_time_total / 1e3 for e in tp.events()
                if e.device_type == DeviceType.CUDA
                and "quant_signature" in e.name.lower()]
        log("times", f"B2 {POP_APP} [pop_tick] rows (last AR(1) draw) on "
            f"the packs {tag} the slice / backhaul reprices: device ms a "
            f"call, CUDA graph of 20 "
            f"{'not measured' if ms is None else f'{ms:.4f}'}; single "
            f"synchronized launches (CUDA events, 10) median "
            f"{single[5]:.4f}, min {single[0]:.4f}; torch.profiler kernel "
            + (f"mean {sum(prof) / len(prof):.4f} over {len(prof)} launches"
               if prof else "not measured (no device events)"))
        del vec
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serving: B6, B7 and the split-serving engine
# ---------------------------------------------------------------------------

def _rel_err(a, b) -> float:
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def gate_rows(B, V, P, seed):
    """Seeded logits for the split gate with first-max ties on both sides
    of the first slice boundary (row 0), at that boundary and the row's end
    (row 1), across every boundary (row 2), and an all -inf last row; with
    the argmax each of those rows must give."""
    import numpy as np
    from repro_torch.kernels.ee_gate.ops import gate_slices
    x = np.random.default_rng(seed).normal(size=(B, V)) * 4
    cuts = [lo for lo, hi in gate_slices(V, P) if lo < hi][1:] or [V // 2]
    want = {}
    if B >= 3:
        x[0, [cuts[0] - 1, cuts[0]]] = 40.0
        x[1, [cuts[0], V - 1]] = 40.0
        for c in cuts:
            x[2, [c - 1, c]] = 50.0
        want = {0: cuts[0] - 1, 1: cuts[0], 2: cuts[0] - 1}
    x[B - 1] = -np.inf
    want[B - 1] = 0
    return x, want


def phase_kernels_serve(dev):
    """B6 and B7 against their plain versions on the card, f32 and bf16;
    B6 also on the split cases (ties across slice boundaries, all -inf
    rows), with the same bits on a repeat call."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.ee_gate.ops import ee_gate, gate_plan
    from repro_torch.kernels.ee_gate.ref import ee_gate_ref
    err = {"ee_gate": 0.0, "decode_attn": 0.0}

    def check_gate(x, tag, want):
        conf, arg = ee_gate(x)
        again = ee_gate(x)
        conf_p, arg_p = ee_gate_ref(x)
        torch.cuda.synchronize()
        rel = _rel_err(conf, conf_p)
        check(rel <= 1e-5, f"{tag}: conf off by {rel:.3g} relative "
              f"(> 1e-5)")
        check(torch.equal(arg, arg_p), f"{tag}: argmax differs")
        check(torch.equal(conf, again[0]) and torch.equal(arg, again[1]),
              f"{tag}: a repeat call gave other bits")
        check(all(int(arg[r]) == a for r, a in want.items()),
              f"{tag}: a tie across a slice boundary lost its first index")
        if want:
            check(abs(float(conf[-1]) * x.shape[1] - 1) <= 1e-6,
                  f"{tag}: an all -inf row is not 1/V")
        err["ee_gate"] = max(err["ee_gate"], max_abs_err(conf, conf_p))
        log("kernels_serve", f"{tag}: conf within {rel:.3g} relative, "
            f"argmax equal, the same bits on a repeat call")
    for B, V in GATE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for tail in (0, min(VOCAB_TAIL, V // 4)):
                x = np.random.default_rng(B + V).normal(size=(B, V)) * 4
                x[:, V - tail:] = -np.inf
                x = torch.as_tensor(x, dtype=torch.float32,
                                    device=dev).to(dtype)
                check_gate(x, f"B6 {(B, V)} {dtype} tail={tail}", {})
    for B, V in GATE_SPLIT_SHAPES:
        P = gate_plan(B, V, sm_count(dev))
        for dtype in (torch.float32, torch.bfloat16):
            x, want = gate_rows(B, V, P, B + V)
            x = torch.as_tensor(x, dtype=torch.float32, device=dev).to(dtype)
            check_gate(x, f"B6 split {(B, V)} {dtype} P={P}", want)
    cases = ([(s, 0, "tail") for s in ATTN_SHAPES]
             + [((1, 4, 2, 32, 256), w, "tail") for w in (16, 64)]
             + [(s, 0, m) for s, m in ATTN_MASK_CASES] + ATTN_MOE_CASES)
    for (B, H, KV, D, T), window, mask in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, cpos, pos = attn_inputs(B, H, KV, D, T, dtype, dev,
                                             mask, B + H + T + window)
            got = decode_attn(q, k, v, cpos, pos, window=window)
            again = decode_attn(q, k, v, cpos, pos, window=window)
            want = decode_attn_ref(q, k, v, cpos, pos, window=window)
            torch.cuda.synchronize()
            e = max_abs_err(got.float(), want.float())
            ok, tol = attn_within(got, want)
            tag = f"B7 {(B, H, KV, D, T)} {dtype} window={window} mask={mask}"
            check(ok, f"{tag}: off by {e:.3g} ({tol})")
            check(torch.equal(got, again), f"{tag}: a repeat call gave "
                  f"other bits")
            if window and T > window:
                # the check's own power: an output that ignores the window
                # (the dropped slots kept) must fail it
                blind = decode_attn_ref(q, k, v, cpos, pos, window=0)
                check(not attn_within(blind, want)[0], f"{tag}: the check "
                      f"passes an output that ignores the window")
            err["decode_attn"] = max(err["decode_attn"], e)
            log("kernels_serve", f"{tag}: max_abs_err {e:.3g} within {tol}; "
                f"a repeat call gives the same bits"
                + ("; an output that ignores the window fails the check"
                   if window and T > window else ""))
    return err


def attn_within(got, want):
    """B7 against its plain version: float32 within rtol = atol = 2e-5;
    bf16 within two bf16 ulps of the largest output (2^-6 max|want|, at
    least 2 ulps of any element), a bound scaled to the output's rounding
    and not to 1, since a long cache's outputs are small (~sqrt(e / T)).
    Returns (ok, the tolerance as text)."""
    import torch
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        tol = 2e-5
        return bool((d <= tol + tol * want.abs()).all()), \
            f"rtol = atol = {tol}"
    tol = 2.0 ** -6 * float(want.float().abs().max())
    return bool((d <= tol).all()), f"atol = 2^-6 max|want| = {tol:.3g}"


def attn_inputs(B, H, KV, D, T, dtype, dev, mask, seed):
    """Seeded decode-attention inputs.  mask "tail": the last quarter of the
    ring is empty (cache_pos -1) and the three slots before it lie in the
    future (pos = T - T/4 - 3); "range": the slots of the second block of
    B7's cluster empty, pos = T - 1; "full": every slot live, pos = T - 1;
    "dead": every slot empty."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attn.ops import split_plan, split_ranges
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                               device=dev).to(dtype)
               for s in ((B, H, D), (B, T, KV, D), (B, T, KV, D)))
    cpos = torch.arange(T, dtype=torch.int32, device=dev)
    pos = T - 1
    if mask == "tail":
        cpos[T - T // 4:] = -1
        pos = T - T // 4 - 3
    elif mask == "range":
        P = split_plan(B, KV, T, D, torch.empty((), dtype=dtype)
                       .element_size())
        check(P > 1, f"B7 {(B, H, KV, D, T)}: one block, no range to empty")
        lo, hi = split_ranges(T, P)[1]
        cpos[lo:hi] = -1
    elif mask == "dead":
        cpos[:] = -1
    return q, k, v, cpos, pos


def _serve_cfg(**overrides):
    import dataclasses
    from repro_torch.configs import get
    return dataclasses.replace(get(SERVE_ARCH), **overrides)


def _probe_thresholds(params, cfg, dev, n=64):
    """Exit thresholds from one probe step: the median confidence of each
    early exit over ``n`` seeded tokens at position 0, so that at random
    init (confidences near 1/vocab) early and late exits both fire."""
    import numpy as np
    import torch
    from repro_torch.kernels.ee_gate.ops import ee_gate
    from repro_torch.models import transformer as TT
    caches = TT.init_caches(cfg, n, 8, device=dev)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (n, 1)), device=dev)
    _, _, exits = TT.decode_step(params, cfg, toks, caches, 0)
    confs = {name: ee_gate(x)[0].cpu().numpy() for name, x in exits.items()}
    del caches
    return [float(np.median(confs[f"exit_{p}"])) for p in cfg.exit_layer_list]


def _serve_engine(cfg, params, dev, thresholds, cache_len=SERVE_CACHE):
    import repro_torch as T
    from repro_torch.runtime.serve_engine import SplitServeEngine
    return SplitServeEngine(
        cfg, params, batch_size=SERVE_BATCH, cache_len=cache_len,
        thresholds=thresholds, network=T.paper_scenario(),
        profile=T.paper_profile("h2"),
        req=T.AppRequirements(alpha=0.55, delta=8e-3), device=dev)


def _churn_ticks(victim):
    """Six ticks of AR(1) uplink fading (``churn_trace``, seed 5) with a
    failure of ``victim`` at tick 1 and its recovery at tick 3."""
    from repro_torch.core.scenarios import ChurnEvent, churn_trace
    trace = churn_trace(1, 6, seed=5)
    trace[1].append(ChurnEvent("fail", None, victim))
    trace[3].append(ChurnEvent("recover", None, victim))
    return trace


def _weight_bytes(params, cfg):
    """Bytes one decode step must read: every layer's weights once, the LM
    head once per head (the exits are tied to it) and the norms."""
    from repro_torch.models import transformer as TT
    layers = sum(x.numel() * x.element_size()
                 for x in TT._tree_leaves(params["layers"]))
    w = TT._lm_head_params(params, cfg)["w"]
    head = w.numel() * w.element_size()
    return layers, head, layers + (len(cfg.exit_layer_list) + 1) * head


def _state_bytes(caches):
    """Bytes of the SSM layers' float32 recurrent states, which a decode
    step reads and writes once each."""
    return sum(c["state"].numel() * 4 for c in caches.values()
               if "state" in c)


def _attn_layers(cfg):
    return cfg.n_periods * sum(s.kind == "attn" for s in cfg.pattern)


def phase_serve(dev, counters):
    """The serving path: qwen3-4b at full width in bf16 through the engine,
    16 requests, then a churn trace with a failure and a recovery."""
    return _serve_path("serve", _serve_cfg(), dev, counters)


def _serve_path(tag, cfg, dev, counters, probe=64, programs=()):
    """``cfg`` at its widths in bf16 through ``SplitServeEngine``:
    ``SERVE_REQUESTS`` requests of ``SERVE_NEW`` tokens at B =
    ``SERVE_BATCH``, then a churn trace with a failure and a recovery;
    launches, ms/step and the step's byte bound, then a profiled window."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as TT
    from repro_torch.runtime.serve_engine import serve_with_churn
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TT.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = TT.param_count(params)
    layer_b, head_b, step_b = _weight_bytes(params, cfg)
    log(tag, f"{cfg.name}: {cfg.n_layers} layers {list(cfg.pattern)[:2]}... "
        f"d_model {cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} head_dim "
        f"{cfg.head_dim if cfg.n_heads else 0} d_ff {cfg.d_ff} experts "
        f"{cfg.n_experts} top_k {cfg.top_k} ssm_state {cfg.ssm_state} vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}) {cfg.dtype}, exits "
        f"after periods {cfg.exit_layer_list}; {n_params} parameters drawn "
        f"in {t_init:.3f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    thresholds = _probe_thresholds(params, cfg, dev, n=probe)
    log(tag, f"thresholds from a {probe}-token probe step (median conf per "
        f"early exit): {thresholds}")

    for c in counters:
        c.launches = 0
    for p in programs:
        p.calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = _serve_engine(cfg, params, dev, thresholds)
    t_build = time.perf_counter() - t0
    state_b = _state_bytes(eng.caches)
    step_b += 2 * state_b
    reqs = [eng.submit([1 + i % 7] + list(range(2, SERVE_PROMPT + 1)),
                       SERVE_NEW) for i in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.run(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps_run = stats.steps
    check(all(r.done and len(r.tokens) == SERVE_NEW for r in reqs),
          f"{tag}: a request did not end with its tokens")
    placement0 = list(eng.placement.placement)
    # churn: a failure and a recovery of a non-source node mid-serving
    src = eng.plan.network.source_node
    victim = next((n for n in placement0 if n != src), 1)
    more = [eng.submit([1 + i % 7, 2, 3], SERVE_NEW) for i in range(4)]
    t0 = time.perf_counter()
    reports = serve_with_churn(eng, _churn_ticks(victim), steps_per_tick=2)
    eng.run(max_steps=1000)
    torch.cuda.synchronize()
    wall_churn = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    hiwater = torch.cuda.max_memory_allocated()
    st = eng.stats
    n_attn = _attn_layers(cfg)
    check(all(r.done and len(r.tokens) == SERVE_NEW for r in more),
          f"{tag}: a request under churn did not end with its tokens")
    check(sum(r["n_fail"] for r in reports) == 1
          and sum(r["n_recover"] for r in reports) == 1,
          f"{tag}: the churn trace did not fail and recover one node")
    check(st.contingency_hits + st.contingency_misses == 2,
          f"{tag}: the failure and the recovery did not go through the "
          f"contingency protocol")
    check(launches["ee_gate"] == (len(cfg.exit_layer_list) + 1) * st.steps,
          f"{tag}: B6 launched {launches['ee_gate']} times in {st.steps} "
          f"steps, not {len(cfg.exit_layer_list) + 1} a step")
    check(launches["decode_attn"] == n_attn * st.steps,
          f"{tag}: B7 launched {launches['decode_attn']} times in "
          f"{st.steps} steps, not {n_attn} a step")
    check(launches["banded_minplus_chain"] > 0,
          f"{tag}: the engine's Plan did not launch B1")
    check(len(st.exit_histogram) >= 2,
          f"{tag}: one exit taken only ({st.exit_histogram})")
    ms_step = wall / steps_run * 1e3
    tok_s = SERVE_REQUESTS * SERVE_NEW / wall
    bound_ms = step_b / HBM_BYTES_PER_S * 1e3
    log(tag, f"engine built in {t_build:.3f} s (Plan, frontier, "
        f"contingency library); {SERVE_REQUESTS} requests x {SERVE_NEW} "
        f"tokens in {steps_run} steps, {wall:.3f} s wall (host clock, ending"
        f" in synchronize): {ms_step:.3f} ms/step, {tok_s:.1f} tokens/s")
    log(tag, f"byte bound of a step: {step_b} B (layers {layer_b} B + "
        f"{len(cfg.exit_layer_list) + 1} x head {head_b} B + 2 x SSM state "
        f"{state_b} B) / 3.35 TB/s = {bound_ms:.4f} ms, "
        f"{SERVE_BATCH / bound_ms * 1e3:.1f} tokens/s at B = {SERVE_BATCH}; "
        f"the step takes {ms_step / bound_ms:.2f}x the bound")
    log(tag, f"churn: {len(reports)} ticks, victim node {victim}, "
        f"reports {reports}; {wall_churn:.3f} s with {st.steps - steps_run} "
        f"more steps")
    log(tag, f"kernel launches on the path {launches} over {st.steps} "
        f"steps: B6 {launches['ee_gate'] / st.steps:.0f} and B7 "
        f"{launches['decode_attn'] / st.steps:.0f} per step, B1 "
        f"{launches['banded_minplus_chain']}; device memory high-water "
        f"{hiwater} B")
    log(tag, f"placement {placement0} -> {list(eng.placement.placement)}"
        f" (final exit {eng.placement.final_exit}); exit histogram "
        f"{dict(sorted(st.exit_histogram.items()))}; stats "
        f"{dataclasses.asdict(st)}")
    prof = profile_serve(eng, dev, tag=f"{tag}_profile")
    del eng
    return params, cfg, launches, dict(ms_step=ms_step, tok_s=tok_s,
                                       bound_ms=bound_ms, hiwater=hiwater,
                                       **prof)


def profile_serve(eng, dev, steps=6, tag="serve_profile"):
    """Where a decode step's time goes: torch.profiler over ``steps``
    engine steps, device time by kernel family, against the steps' wall."""
    import torch
    from torch.autograd import DeviceType
    for i in range(SERVE_BATCH):
        eng.submit([1 + i, 2, 3], 64)
    for _ in range(4):                    # past the prompts
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as tp:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in tp.key_averages() if e.device_type != DeviceType.CPU]
    busy = sum(e.self_device_time_total for e in events) / 1e3     # ms
    if busy <= 0:
        log(tag, "device time: not measured (the profiler saw "
            "no device time)")
        return {}
    fam = {"matmul": 0.0, "B7 decode_attn": 0.0, "B6 ee_gate": 0.0,
           "copies": 0.0, "other": 0.0}
    for e in events:
        k = e.key.lower()
        t = e.self_device_time_total / 1e3
        if "decode_attn" in k:
            fam["B7 decode_attn"] += t
        elif "ee_gate" in k:
            fam["B6 ee_gate"] += t
        elif "memcpy" in k or "memset" in k:
            fam["copies"] += t
        elif any(w in k for w in ("gemm", "gemv", "sm90", "cutlass", "matmul",
                                  "splitk", "xmma", "cublas", "nvjet")):
            fam["matmul"] += t
        else:
            fam["other"] += t
    per = {k: v / steps for k, v in fam.items()}
    # host time blocked in the gates' device -> host copies (each .cpu()
    # waits for the step's queued kernels): the runtime calls that block
    sync = sum(e.self_cpu_time_total for e in tp.key_averages()
               if e.device_type == DeviceType.CPU
               and ("Synchronize" in e.key or "cudaMemcpy" in e.key)) / 1e3
    n_dev = sum(e.count for e in events) / steps
    log(tag, f"{steps} steps under torch.profiler: wall "
        f"{wall / steps * 1e3:.3f} ms/step, {n_dev:.0f} device kernels and "
        f"copies a step, device busy {busy / steps:.3f} "
        f"ms/step ({busy / (wall * 1e3):.1%}, idle "
        f"{1 - busy / (wall * 1e3):.1%}); host blocked in syncs / copies "
        f"{sync / steps:.3f} ms/step; device per step "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in per.items()))
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        log(tag, f"device {e.key[:80]}: "
            f"{e.self_device_time_total / 1e3 / steps:.4f} ms/step over "
            f"{e.count // steps} calls/step")
    return dict(busy_ms=busy / steps, wall_prof_ms=wall / steps * 1e3,
                sync_ms=sync / steps, split=per, kernels=n_dev)


def phase_serve_parity(dev):
    """qwen3-4b widths at 3 layers (exits after periods 1 and 2) in float32:
    decode_step logits within 1e-4 and the engine's tokens, exits and
    EngineStats identical on CUDA and the CPU path, same weights."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as TT
    # float32 products in full float32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _serve_cfg(n_layers=3, exit_layers=(1, 2), dtype="float32")
    params = TT.init_model(cfg, seed=1, device=dev)
    cpu = TT.tree_to(params, "cpu")
    worst = 0.0
    caches = {w: TT.init_caches(cfg, SERVE_BATCH, 32, device=w)
              for w in (dev, "cpu")}
    for pos in range(4):
        toks = torch.tensor([[1 + pos], [2], [3 + 2 * pos], [4]])
        lg, _, eg = TT.decode_step(params, cfg, toks.to(dev), caches[dev], pos)
        lc, _, ec = TT.decode_step(cpu, cfg, toks, caches["cpu"], pos)
        for name, a, b in [("final", lg, lc)] + [(n, eg[n], ec[n])
                                                 for n in ec]:
            e = max_abs_err(a.cpu(), b)
            check(e <= 1e-4, f"serve_parity step {pos} {name}: logits off by "
                  f"{e:.3g} (> 1e-4)")
            worst = max(worst, e)
    thresholds = _probe_thresholds(params, cfg, dev)
    runs = {}
    for where, p in ((dev, params), ("cpu", cpu)):
        eng = _serve_engine(cfg, p, where, thresholds, cache_len=64)
        reqs = [eng.submit([1 + i % 7, 2, 3], 6) for i in range(8)]
        t0 = time.perf_counter()
        eng.run(max_steps=200)
        torch.cuda.synchronize()
        runs[str(where)] = ([(r.tokens, r.exits_taken) for r in reqs],
                            dataclasses.asdict(eng.stats),
                            list(eng.placement.placement),
                            time.perf_counter() - t0)
    (tg, sg, pg, wg), (tc, sc, pc, wc) = runs[str(dev)], runs["cpu"]
    check(tg == tc, "serve_parity: token streams or exits differ between "
          "CUDA and the CPU path")
    check(sg == sc and pg == pc, "serve_parity: EngineStats or placement "
          "differ between CUDA and the CPU path")
    log("serve_parity", f"{cfg.n_layers} layers at {SERVE_ARCH} widths, f32:"
        f" decode_step logits (final and 2 exits, 4 steps) within {worst:.3g}"
        f" of the CPU path; engine (thresholds {thresholds}) tokens, exits, "
        f"EngineStats and placement identical; exit histogram "
        f"{sg['exit_histogram']}; wall s cuda {wg:.3f} cpu {wc:.3f}")
    del params, cpu, caches


def _arch_cfg(arch, periods=None, **overrides):
    """``arch`` at its published widths, cut to ``periods`` periods (all
    when None), with the early exits re-derived for the cut depth."""
    import dataclasses
    from repro_torch.configs import get
    cfg = get(arch)
    if periods is not None:
        overrides.setdefault("n_layers", periods * len(cfg.pattern))
    return dataclasses.replace(cfg, **overrides)


class CallCounter:
    """Counts the calls of a module function (a plain PyTorch program of
    the path: ``_ssd_scan``, ``chunked_attention``, ``_moe_gather``) while
    installed; the module's own callers look the name up at call time."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0

    def __enter__(self):
        def counted(*a, **kw):
            self.calls += 1
            return self.fn(*a, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _program_counters():
    from repro_torch.models import attention, moe, ssm
    return {"ssd_scan": CallCounter(ssm, "_ssd_scan"),
            "chunked_attention": CallCounter(attention, "chunked_attention"),
            "moe_gather": CallCounter(moe, "_moe_gather")}


def phase_serve_ssm(dev, counters):
    """mamba2-1.3b at full width and depth in bf16 through the engine, as
    [serve]: the recurrent state of 48 SSM layers, B6 and B1, no B7; then
    an SSM_PROMPT-token prompt through ``prefill`` (the chunked SSD of
    every layer) and one decode step from its caches."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as TT
    cfg = _arch_cfg(SSM_ARCH)
    params, cfg, launches, out = _serve_path("serve_ssm", cfg, dev, counters,
                                             probe=SSM_PROBE)
    check(launches["decode_attn"] == 0, "serve_ssm: B7 launched in an "
          "attention-free model")
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1, SSM_PROMPT + 1)), device=dev)
    with _program_counters()["ssd_scan"] as ssd:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, caches = TT.prefill(params, cfg,
                                    {"tokens": toks[:, :SSM_PROMPT]},
                                    cache_len=SSM_PROMPT + 1)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
    hi_pre = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "serve_ssm: prefill logits not finite or of the wrong shape")
    check(all(bool(torch.isfinite(c["state"]).all())
              for c in caches.values()), "serve_ssm: a prefill state is "
          "not finite")
    check(ssd.calls == cfg.n_layers, f"serve_ssm: {ssd.calls} _ssd_scan "
          f"calls in a prefill of {cfg.n_layers} SSM layers")
    lg, caches, _ = TT.decode_step(params, cfg, toks[:, SSM_PROMPT:],
                                   caches, SSM_PROMPT)
    check(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()),
          "serve_ssm: the decode step after prefill is not finite")
    log("serve_ssm", f"prefill of {SSM_PROMPT} tokens (B = 1, bf16): "
        f"{t_pre:.3f} s wall (host clock, ending in synchronize), "
        f"{SSM_PROMPT / t_pre:.1f} tokens/s, device memory high-water "
        f"{hi_pre} B; _ssd_scan calls {ssd.calls}; one decode step after "
        f"it finite")
    out.update(prefill_s=t_pre, ssd_calls=ssd.calls)
    del params, caches
    torch.cuda.empty_cache()
    return launches, out


def phase_serve_moe(dev, counters):
    """mixtral-8x22b at full width cut to MOE_PERIODS periods, in bf16:
    the engine run of [serve]; then a MOE_PROMPT-token prompt through
    ``prefill`` with cache_len 4,096 (the ring slots wrap past the window)
    and MOE_DECODE decode steps at B = 1 (B7 windowed over 4,096 slots)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as TT
    cfg = _arch_cfg(MOE_ARCH, MOE_PERIODS)
    progs = _program_counters()
    with progs["moe_gather"], progs["chunked_attention"]:
        params, cfg, launches, out = _serve_path(
            "serve_moe", cfg, dev, counters,
            programs=(progs["moe_gather"], progs["chunked_attention"]))
        log("serve_moe", f"depth cut: {MOE_PERIODS} of {MOE_ARCH}'s 56 "
            f"periods; _moe_gather calls on the engine run (its profiled "
            f"window included) "
            f"{progs['moe_gather'].calls}")
        toks = torch.as_tensor(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (1, MOE_PROMPT + MOE_DECODE)), device=dev)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        g0 = progs["moe_gather"].calls
        t0 = time.perf_counter()
        logits, caches = TT.prefill(params, cfg,
                                    {"tokens": toks[:, :MOE_PROMPT]},
                                    cache_len=cfg.sliding_window)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        hi_pre = torch.cuda.max_memory_allocated()
        T = cfg.sliding_window
        want_pos = torch.full((T,), -1, dtype=torch.int32)
        live = torch.arange(MOE_PROMPT - T, MOE_PROMPT, dtype=torch.int32)
        want_pos[live % T] = live
        check(torch.equal(caches["l0"]["pos"].cpu(),
                          want_pos.expand(cfg.n_periods, T)),
              "serve_moe: the prefill cache does not hold the last 4,096 "
              "positions at their ring slots")
        check(tuple(logits.shape) == (1, cfg.padded_vocab)
              and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
              "serve_moe: prefill logits not finite or of the wrong shape")
        walls = []
        for i in range(MOE_DECODE):
            pos = MOE_PROMPT + i
            t0 = time.perf_counter()
            lg, caches, ex = TT.decode_step(params, cfg, toks[:, pos:pos + 1],
                                            caches, pos)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()),
                  f"serve_moe: decode logits at {pos} not finite")
        dec_launches = {c.__name__: c.launches for c in counters}
        check(dec_launches["decode_attn"] == _attn_layers(cfg) * MOE_DECODE,
              f"serve_moe: B7 launched {dec_launches['decode_attn']} times "
              f"in {MOE_DECODE} decode steps")
        n_attn_prog = progs["chunked_attention"].calls
        log("serve_moe", f"prefill of {MOE_PROMPT} tokens (B = 1, cache_len "
            f"{T}): {t_pre:.3f} s wall (host clock, ending in synchronize), "
            f"{MOE_PROMPT / t_pre:.1f} tokens/s, device memory high-water "
            f"{hi_pre} B; ring slots hold positions {MOE_PROMPT - T}.."
            f"{MOE_PROMPT - 1}; chunked_attention calls {n_attn_prog}, "
            f"_moe_gather calls {progs['moe_gather'].calls - g0}")
        log("serve_moe", f"{MOE_DECODE} decode steps after it at B = 1 "
            f"(B7 over {T} slots, window {cfg.sliding_window}): ms/step "
            f"{[round(w * 1e3, 3) for w in walls]}; launches "
            f"{dec_launches}")
    for k, v in dec_launches.items():
        launches[k] += v
    out.update(prefill_s=t_pre, decode_ms=walls, programs={
        k: c.calls for k, c in progs.items()})
    del caches
    torch.cuda.empty_cache()
    moe_gather_times(params, cfg, dev, progs["moe_gather"].calls)
    attn_program_times(cfg, dev, n_attn_prog)
    del params
    torch.cuda.empty_cache()
    return launches, out


def _rel_last(full, lg):
    """The reference's teacher-forcing error: max |a - b| over the finite
    logits, relative to max |a|."""
    import torch
    a, b = full.double(), lg.double()
    m = torch.isfinite(a) & torch.isfinite(b)
    check(bool((torch.isfinite(a) == torch.isfinite(b)).all()),
          "prefill: the -inf vocab tails differ")
    return float((a[m] - b[m]).abs().max() / (a[m].abs().max() + 1e-9))


def phase_prefill(dev):
    """Teacher forcing on the card in float32 (tests/test_models_smoke.py's
    check): prefill of S - 1 tokens plus one decode step equals
    ``forward_train`` at the last position, relative error < 1e-4, for
    PREFILL_CASES; then ``encode`` for hubert-xlarge at full width and
    depth in bf16.  Returns the walls."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import transformer as TT
    out = {}
    progs = _program_counters()
    for arch, periods, B, S in PREFILL_CASES:
        cfg = _arch_cfg(arch, periods, dtype="float32")
        if cfg.n_experts:                  # no capacity drops
            cfg = dataclasses.replace(cfg, capacity_factor=16.0)
        torch.cuda.reset_peak_memory_stats()
        params = TT.init_model(cfg, seed=2, device=dev)
        toks = torch.as_tensor(np.random.default_rng(S).integers(
            0, cfg.vocab_size, (B, S)), device=dev)
        with progs["ssd_scan"], progs["chunked_attention"], \
                progs["moe_gather"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = TT.forward_train(params, cfg, {"tokens": toks})["final"][
                :, -1]
            torch.cuda.synchronize()
            t_fwd = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, caches = TT.prefill(params, cfg, {"tokens": toks[:, :S - 1]},
                                   cache_len=S + 4)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            lg, _, _ = TT.decode_step(params, cfg, toks[:, S - 1:], caches,
                                      S - 1)
        err = _rel_last(full, lg)
        check(err < 1e-4, f"prefill {arch}: decode after prefill differs "
              f"from forward_train by {err:.3g} relative (>= 1e-4)")
        wraps = cfg.sliding_window and S - 1 > cfg.sliding_window
        log("prefill", f"{arch} ({cfg.n_layers} layers, f32, B = {B}, S = "
            f"{S}{', capacity_factor 16' if cfg.n_experts else ''}"
            f"{', prompt past the window: ring slots wrap' if wraps else ''})"
            f": decode after prefill within {err:.3g} relative of "
            f"forward_train; walls (host clock, ending in synchronize) "
            f"forward_train {t_fwd:.3f} s, prefill {t_pre:.3f} s; device "
            f"memory high-water {torch.cuda.max_memory_allocated()} B")
        out[arch] = dict(err=err, forward_s=t_fwd, prefill_s=t_pre)
        del params, caches, full, lg
        torch.cuda.empty_cache()
    log("prefill", "program calls over the three cases: "
        + ", ".join(f"{k} {c.calls}" for k, c in progs.items()))
    out["programs"] = {k: c.calls for k, c in progs.items()}
    # encode: hubert-xlarge at full width and depth, bf16
    cfg = _arch_cfg("hubert-xlarge")
    params = TT.init_model(cfg, seed=3, device=dev)
    B, S = ENCODE_FRAMES
    g = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randn(B, S, cfg.d_model, generator=g, device=dev).to(
        params["final_norm"]["scale"].dtype)
    TT.encode(params, cfg, {"frames": frames})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = TT.encode(params, cfg, {"frames": frames})
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
          and bool(torch.isinf(logits[..., cfg.vocab_size:]).all()),
          "prefill: hubert-xlarge encode logits not finite or of the wrong "
          "shape")
    log("prefill", f"hubert-xlarge encode ({cfg.n_layers} layers, {cfg.dtype}, "
        f"frames {(B, S, cfg.d_model)}, {TT.param_count(params)} "
        f"parameters): logits {tuple(logits.shape)} finite (tail -inf), "
        f"{t_enc * 1e3:.3f} ms wall (second call; host clock, ending in "
        f"synchronize), {B * S / t_enc:.1f} frames/s")
    out["encode_ms"] = t_enc * 1e3
    del params, logits, frames
    torch.cuda.empty_cache()
    return out


def _close_tree(a, b, tol, what):
    """Leaves of two trees within rtol = atol = tol (integers equal)."""
    import torch
    if isinstance(b, dict):
        check(set(a) == set(b), f"{what}: keys differ")
        return max([_close_tree(a[k], b[k], tol, f"{what}/{k}") for k in b],
                   default=0.0)
    a = a.cpu()
    if not b.dtype.is_floating_point:
        check(torch.equal(a, b), f"{what}: differs")
        return 0.0
    ad, bd = a.double(), b.double()
    ok = bool(((ad == bd) | ((ad - bd).abs() <= tol + tol * bd.abs()))
              .all())                    # equal infinities (the vocab tail)
    e = max_abs_err(a, b)
    check(ok, f"{what}: off by {e:.3g} (rtol = atol = {tol})")
    return e


def phase_serve_parity_more(dev):
    """[serve_parity] for the SSM and MoE layers: mamba2-1.3b widths at 2
    periods and mixtral-8x22b widths at 1 period, float32: decode_step (4
    steps), prefill (logits and caches) and forward_train on CUDA against
    the port's CPU path, same weights, within rtol = atol = 1e-4."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as TT
    for arch, periods in ((SSM_ARCH, 2), (MOE_ARCH, 1)):
        cfg = _arch_cfg(arch, periods, dtype="float32", exit_layers=())
        params = TT.init_model(cfg, seed=4, device=dev)
        t0 = time.perf_counter()
        cpu = TT.tree_to(params, "cpu")
        t_copy = time.perf_counter() - t0
        B, S = 2, 24
        toks = torch.as_tensor(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (B, S + 4)))
        worst = {}
        where = {dev: params, "cpu": cpu}
        fw = {w: TT.forward_train(p, cfg, {"tokens": toks[:, :S].to(w)})
              for w, p in where.items()}
        worst["forward_train"] = _close_tree(fw[dev], fw["cpu"], 1e-4,
                                             f"serve_parity {arch} forward")
        pre = {w: TT.prefill(p, cfg, {"tokens": toks[:, :S].to(w)},
                             cache_len=S + 8) for w, p in where.items()}
        worst["prefill"] = _close_tree(
            {"logits": pre[dev][0], "caches": pre[dev][1]},
            {"logits": pre["cpu"][0], "caches": pre["cpu"][1]}, 1e-4,
            f"serve_parity {arch} prefill")
        for pos in range(S, S + 4):
            step = {w: TT.decode_step(p, cfg, toks[:, pos:pos + 1].to(w),
                                      pre[w][1], pos)
                    for w, p in where.items()}
            worst[f"decode {pos}"] = _close_tree(
                {"logits": step[dev][0], "exits": step[dev][2]},
                {"logits": step["cpu"][0], "exits": step["cpu"][2]}, 1e-4,
                f"serve_parity {arch} decode at {pos}")
        _close_tree(pre[dev][1], pre["cpu"][1], 1e-4,
                    f"serve_parity {arch} caches after decode")
        log("serve_parity", f"{arch} widths at {cfg.n_layers} layers, f32 "
            f"({TT.param_count(params)} parameters, copied to the host in "
            f"{t_copy:.3f} s): forward_train, prefill (logits and caches) "
            f"and 4 decode steps on CUDA within rtol = atol = 1e-4 of the "
            f"CPU path; max abs err " + ", ".join(
                f"{k} {v:.3g}" for k, v in worst.items()))
        del params, cpu, fw, pre, step
        torch.cuda.empty_cache()


def _program_row(tag, ms, calls, nbytes, ops, peak, lib):
    """Log one plain-PyTorch program of the path (an XLA program in the
    reference, not a Pallas kernel) against its bound."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / peak
    bound = max(t_b, t_o) * 1e3
    by = "bytes" if t_b >= t_o else "operations"
    log("programs", f"{tag}: device ms a call {ms:.4f} (plain PyTorch), "
        f"calls on the path {calls}, bound {bound:.6f} ms by {by} "
        f"({nbytes} B, {ops} ops at {peak / 1e12:.0f} TFLOP/s), "
        f"{bound / ms:.1%} of the bound; library "
        + ("none" if lib is None else f"{lib:.4f} ms"))
    return dict(ms=ms, calls=calls, bound_ms=bound, bound_by=by,
                library_ms=lib)


def _program_ms(fn, reps=3):
    return graph_ms(fn, reps) or cuda_ms(fn, reps, 1)


def moe_gather_times(params, cfg, dev, calls):
    """``_moe_gather`` of layer 0 at the engine's decode shape (4 groups of
    one token) and at the prefill shape (one group of MOE_PROMPT tokens),
    bf16.  Bytes: the experts this run's tokens select, read once, the
    router, x and y; operations: the router and each kept (token, expert)
    pair's SwiGLU."""
    import torch
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TT
    p = TT._period(params["layers"], 0)["l0"]["mlp"]
    d, ff, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    g = torch.Generator(device=dev).manual_seed(8)
    rows = {}
    for G, t in ((SERVE_BATCH, 1), (1, MOE_PROMPT)):
        x = torch.randn(G, t, d, generator=g, device=dev).to(torch.bfloat16)
        _, _, ids = M._route(p, cfg, x)
        used = int(torch.unique(ids).numel())
        C = min(M._capacity(t, cfg), t)
        kept = int((torch.zeros(G, t, E, device=dev).scatter_(
            -1, ids, 1.0).sum(1).clamp(max=C)).sum())
        nbytes = used * 3 * d * ff * 2 + d * E * 4 + 2 * G * t * d * 2
        ops = 2 * d * E * G * t + kept * 3 * 2 * d * ff
        ms = _program_ms(lambda: M._moe_gather(p, cfg, x))
        rows[(G, t)] = _program_row(
            f"_moe_gather bf16 x {(G, t, d)} (experts used {used} of {E}, "
            f"{kept} kept (token, expert) pairs, capacity {C})", ms,
            calls if (G, t) == (SERVE_BATCH, 1) else None, nbytes, ops,
            989e12, None)
    return rows


def attn_program_times(cfg, dev, calls):
    """``chunked_attention`` at [serve_moe]'s prefill shape (B = 1,
    MOE_PROMPT tokens, mixtral's heads, window 4,096, bf16) beside
    scaled_dot_product_attention with the same boolean mask.  Operations:
    4 H D for each live (query, key) pair."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import attention as A
    B, S, H, KV, D = 1, MOE_PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    W = cfg.sliding_window
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    fn = lambda: A.chunked_attention(q, k, v, pos, pos, causal=True,
                                     window=W, chunk=cfg.attn_chunk)
    ms = _program_ms(fn, 2)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    lib_fn = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    e = max_abs_err(lib_fn().transpose(1, 2).float(), fn().float())
    check(e <= 2e-2, f"chunked_attention vs scaled_dot_product_attention off "
          f"by {e:.3g}")
    lib = _program_ms(lib_fn, 2)
    live = sum(min(i + 1, W) for i in range(S)) * B
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    return _program_row(f"chunked_attention bf16 q {tuple(q.shape)} k/v "
                        f"{tuple(k.shape)} window {W} chunk {cfg.attn_chunk} "
                        f"({live} live pairs; library within {e:.3g})", ms,
                        calls, nbytes, 4 * H * D * live, 989e12, lib)


def ssd_program_times(dev, calls):
    """``_ssd_scan`` at [serve_ssm]'s prefill shape (B = 1, SSM_PROMPT
    tokens, 64 heads of 64, N = 128, chunk 256; xh, B and C in bf16 as the
    conv gives them, dt and log a in float32).  Operations: the causal
    half of each chunk's dual form, the inter-chunk product and the state
    update, on the real rows."""
    import torch
    from repro_torch.models import ssm as M
    from repro_torch.models.ssm import ssm_dims
    cfg = _arch_cfg(SSM_ARCH)
    di, H, P, N = ssm_dims(cfg)
    B, S = 1, SSM_PROMPT
    g = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16
    xh = torch.randn(B, S, H, P, generator=g, device=dev).to(bf)
    Bm = torch.randn(B, S, N, generator=g, device=dev).to(bf)
    Cm = torch.randn(B, S, N, generator=g, device=dev).to(bf)
    dt = torch.rand(B, S, H, generator=g, device=dev) * 0.5 + 0.01
    a_log = -torch.rand(B, S, H, generator=g, device=dev) * dt
    ms = _program_ms(lambda: M._ssd_scan(cfg, xh, Bm, Cm, dt, a_log))
    Q = min(cfg.ssm_chunk, S)
    ops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        pairs = q * (q + 1) // 2
        ops += B * (2 * N * pairs + 2 * H * pairs + 2 * H * P * pairs
                    + 4 * q * N * H * P)
    nbytes = (2 * (2 * xh.numel() + Bm.numel() + Cm.numel())
              + 4 * (dt.numel() + a_log.numel() + B * H * P * N))
    return _program_row(f"_ssd_scan bf16 xh {tuple(xh.shape)} N {N} chunk "
                        f"{cfg.ssm_chunk}", ms, calls, nbytes, ops, 67e12,
                        None)


def attn_times_moe(dev, err):
    """B7 at mixtral-8x22b's heads (H = 48, KV = 8, G = 6, D = 128) over a
    full 4,096-slot window, bf16, at B = 4 and at the decode path's B = 1:
    CUDA-graph replays against the byte bound, the plain version and
    scaled_dot_product_attention on the cache's view.  Returns the
    kernels-line row of B = 4."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import ops as attn_ops
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    H, KV, D, T = 48, 8, 128, 4096
    W = T
    g = torch.Generator(device=dev).manual_seed(12)
    row = None
    for B in (4, 1):
        q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
        k = torch.randn(B, T, KV, D, generator=g, device=dev).bfloat16()
        v = torch.randn(B, T, KV, D, generator=g, device=dev).bfloat16()
        cpos = torch.arange(T, dtype=torch.int32, device=dev)
        pos = T - 1
        kern = lambda: decode_attn(q, k, v, cpos, pos, window=W)
        ms = graph_ms(kern, 20) or cuda_ms(kern, 50, 5)
        plain_fn = lambda: decode_attn_ref(q, k, v, cpos, pos, window=W)
        plain = graph_ms(plain_fn, 5) or cuda_ms(plain_fn, 5, 1)
        mask = ((cpos >= 0) & (cpos <= pos) & (cpos > pos - W))[
            None, None, None, :]
        qs = q[:, :, None].contiguous()
        ks, vs = (t.transpose(1, 2) for t in (k, v))
        lib_fn = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
        e = max_abs_err(lib_fn()[:, :, 0].float(), kern().float())
        check(e <= 2e-2, f"B7 {(B, H, KV, D, T)} vs scaled_dot_product_"
              f"attention off by {e:.3g}")
        lib = graph_ms(lib_fn, 20) or cuda_ms(lib_fn, 50, 5)
        nbytes = q.numel() * 2 * 2 + (k.numel() + v.numel()) * 2 + T * 4
        ops = 4 * B * H * T * D
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
        bound, by = max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else \
            "operations"
        log("times", f"B7 bf16 mixtral heads q {tuple(q.shape)} cache "
            f"{tuple(k.shape)} window {W} (blocks a cluster P = "
            f"{attn_ops.split_plan(B, KV, T, D, 2)}, slots a warp "
            f"{attn_ops.slots_per_warp(D, 2)}): device ms a call (CUDA graph of 20 calls, plain 5) kernel "
            f"{ms:.4f}, plain {plain:.4f}, library scaled_dot_product_"
            f"attention on the cache's view {lib:.4f} (within {e:.3g}) | "
            f"bound {bound:.6f} ms by {by} ({nbytes} B, {ops} ops); "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved, "
            f"{bound / ms:.1%} of the bound")
        if B == 4:
            row = dict(name="decode_attn@mixtral-8x22b", route="cuda",
                       source=ATTN_SOURCE,
                       replaces="src/repro/kernels/decode_attn/"
                                "decode_attn.py:72",
                       launches=None, max_abs_err=err, ms=ms,
                       plain_ms=plain, bound_ms=bound, bound_by=by,
                       library_ms=lib)
        del q, k, v, ks, vs, qs
        torch.cuda.empty_cache()
    return row


def gate_times(dev, err):
    """B6 at the serving shape, [4, 153,600] with the qwen3-4b -inf vocab
    tail, on seeded logits in float32 and bf16: device ms a call from
    CUDA-graph replays against the bound, the plain version and
    softmax(x).max(-1), beside CUDA-event means.  Returns the kernels-line
    row of the float32 gate (the serving path's head dtype)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ee_gate.ops import ee_gate
    from repro_torch.kernels.ee_gate.ref import ee_gate_ref
    B, V = SERVE_BATCH, 153600
    logits = np.random.default_rng(3).normal(size=(B, V)) * 4
    logits[:, V - VOCAB_TAIL:] = -np.inf
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(logits, dtype=torch.float32, device=dev).to(dtype)
        ev = cuda_ms(lambda: ee_gate(x), 200, 10)
        ms = graph_ms(lambda: ee_gate(x), 50) or ev
        plain = graph_ms(lambda: ee_gate_ref(x), 20) or \
            cuda_ms(lambda: ee_gate_ref(x), 50, 5)
        lib = graph_ms(lambda: torch.softmax(x, -1).max(-1), 20) or \
            cuda_ms(lambda: torch.softmax(x, -1).max(-1), 50, 5)
        nbytes = x.numel() * x.element_size() + B * 8
        ops = 4 * x.numel()          # clamp, subtract, exp, add per element
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
        bound = max(t_b, t_o) * 1e3
        by = "bytes" if t_b >= t_o else "operations"
        note = _plan_note("gate", B, V)
        log("times", f"B6 {str(dtype)[6:]} {(B, V)} ({note}): device ms "
            f"a call (CUDA graph of 50 calls, plain and library 20) kernel "
            f"{ms:.4f}, plain {plain:.4f}, library softmax(x).max(-1), two "
            f"calls, {lib:.4f} | CUDA-event mean of "
            f"back-to-back calls (host launch cost included): kernel {ev:.4f}"
            f" | bound {bound:.6f} ms by {by} ({nbytes} B, {ops} ops, "
            f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s achieved, "
            f"{bound / ms:.1%} of the bound)")
        if dtype == torch.float32:
            row = dict(name="ee_gate", route="cuda", source=GATE_SOURCE,
                       replaces="src/repro/kernels/ee_gate/ee_gate.py:60",
                       launches=None, max_abs_err=err, ms=ms, plain_ms=plain,
                       bound_ms=bound, bound_by=by, library_ms=lib)
            gate_split_sweep(x, dev)
    for B, V, tail in GATE_MORE_SHAPES:
        logits = np.random.default_rng(V).normal(size=(B, V)) * 4
        logits[:, V - tail:] = -np.inf
        x = torch.as_tensor(logits, dtype=torch.float32, device=dev)
        ms = graph_ms(lambda: ee_gate(x), 50) or cuda_ms(lambda: ee_gate(x),
                                                         200, 10)
        plain = graph_ms(lambda: ee_gate_ref(x), 20) or \
            cuda_ms(lambda: ee_gate_ref(x), 50, 5)
        lib = graph_ms(lambda: torch.softmax(x, -1).max(-1), 20) or \
            cuda_ms(lambda: torch.softmax(x, -1).max(-1), 50, 5)
        nbytes, ops = x.numel() * 4 + B * 8, 4 * x.numel()
        bound = max(nbytes / HBM_BYTES_PER_S,
                    ops / PEAK_OPS_PER_S["float32"]) * 1e3
        log("times", f"B6 float32 {(B, V)} tail {tail} "
            f"({_plan_note('gate', B, V)}): device ms a call (CUDA graph) "
            f"kernel {ms:.4f}, plain {plain:.4f}, library softmax(x).max(-1)"
            f" {lib:.4f} | bound {bound:.6f} ms by bytes ({nbytes} B), "
            f"{bound / ms:.1%} of the bound")
    return row


def gate_split_sweep(x, dev):
    """B6 on ``x`` with each split P (the C entry point called directly):
    the measurement behind gate_plan's block target.  Skipped for a
    checkout whose gate takes no split."""
    import torch
    try:
        from repro_torch.kernels.ee_gate.ops import GATE_MAX_SPLIT
    except ImportError:
        return
    from repro_torch.kernels._build import launch
    B, V = x.shape
    conf = torch.empty(B, dtype=torch.float32, device=dev)
    arg = torch.empty(B, dtype=torch.int32, device=dev)
    cols = []
    for P in (1, 4, 8, 16, 33, 66, 132, GATE_MAX_SPLIT):
        ms = graph_ms(lambda: launch("ee_gate_f32", dev, x.data_ptr(),
                                     conf.data_ptr(), arg.data_ptr(), B, V,
                                     P), 50)
        cols.append(f"P = {P} ({B * P} blocks) "
                    + ("not measured" if ms is None else f"{ms:.4f} ms"))
    log("times", f"B6 f32 {(B, V)} by blocks a row, device ms a call (CUDA "
        f"graph of 50 calls): " + ", ".join(cols))


def ptxas_usage(fragment):
    """{kernel: (registers, static shared bytes, spill bytes)} from the
    ptxas report of the build, for entry functions whose name holds
    ``fragment``."""
    import re
    from repro_torch.kernels._build import load_library
    out, name = {}, None
    for line in load_library().log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if fragment in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(name, [None, 0, 0])[2] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            rec = out.setdefault(name, [None, 0, 0])
            rec[0], rec[1] = int(m.group(1)), int(smem.group(1)) if smem else 0
    return {k: tuple(v) for k, v in out.items()}


def attn_times(cfg, dev, err):
    """B7 at one layer of the decode step, a full cache and pos = T - 1, at
    the serving cache (T = 256) and two long ones: CUDA-event means against
    the byte bound, the plain version and scaled_dot_product_attention.
    Returns the kernels-line row of the serving shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import ops as attn_ops
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    B, H, KV, D = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = torch.bfloat16
    for kern, (regs, smem, spill) in ptxas_usage("decode_attn").items():
        log("times", f"B7 ptxas {kern[:70]}: {regs} registers, {smem} B "
            f"static shared memory, {spill} B spilled")
    g = torch.Generator(device=dev).manual_seed(4)
    row = None
    for T in ATTN_TIME_T:
        q = torch.randn(B, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, T, KV, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, T, KV, D, generator=g, device=dev).to(dt)
        cpos = torch.arange(T, dtype=torch.int32, device=dev)
        pos = T - 1
        reps = max(10, 200 * 256 // T)
        kern = lambda: decode_attn(q, k, v, cpos, pos)
        ev = cuda_ms(kern, reps, 5)
        ms = graph_ms(kern, 20) or ev
        plain_fn = lambda: decode_attn_ref(q, k, v, cpos, pos)
        plain = graph_ms(plain_fn, 5) or cuda_ms(plain_fn, 5, 1)
        # the library call on the same cache: [B, KV, T, D] views of it;
        # for the record also on a contiguous copy (the copy not timed)
        qs = q[:, :, None].contiguous()                  # [B, H, 1, D]
        ks, vs = (t.transpose(1, 2) for t in (k, v))
        kc, vc = ks.contiguous(), vs.contiguous()
        mask = ((cpos >= 0) & (cpos <= pos))[None, None, None, :]
        sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)
        e = max_abs_err(sdpa[:, :, 0].float(),
                        decode_attn(q, k, v, cpos, pos).float())
        check(e <= 2e-2, f"B7 T={T} vs scaled_dot_product_attention off by "
              f"{e:.3g}")
        lib_fn = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
        lib_ev = cuda_ms(lib_fn, reps, 5)
        lib = graph_ms(lib_fn, 20) or lib_ev
        lib_c = graph_ms(lambda: F.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=mask, enable_gqa=True), 20)
        nbytes = q.numel() * 2 * 2 + (k.numel() + v.numel()) * 2 + T * 4
        ops = 4 * B * H * T * D          # QK^T and PV, multiply + add
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
        bound, by = max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else \
            "operations"
        log("times", f"B7 bf16 q {tuple(q.shape)} cache {tuple(k.shape)} "
            f"(blocks a cluster P = {attn_ops.split_plan(B, KV, T, D, 2)}, "
            f"dynamic shared memory {attn_ops.smem_bytes(D, 2)} B): device ms "
            f"a call (CUDA graph of 20 calls, plain 5): kernel {ms:.4f}, plain "
            f"{plain:.4f}, library scaled_dot_product_attention (enable_gqa, "
            f"bool mask, the cache's [B, KV, T, D] view) {lib:.4f}, within "
            f"{e:.3g} of B7; on a contiguous copy {lib_c or math.nan:.4f} | "
            f"CUDA-event mean "
            f"of back-to-back calls (host launch cost included): kernel "
            f"{ev:.4f}, library {lib_ev:.4f} | bound {bound:.6f} ms by {by} "
            f"({nbytes} B, {ops} ops); {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
            f"achieved, {bound / ms:.1%} of the bound")
        if T == SERVE_CACHE:
            row = dict(name="decode_attn", route="cuda", source=ATTN_SOURCE,
                       replaces="src/repro/kernels/decode_attn/"
                                "decode_attn.py:72",
                       launches=None, max_abs_err=err, ms=ms,
                       plain_ms=plain, bound_ms=bound, bound_by=by,
                       library_ms=lib)
        del q, k, v, ks, vs, kc, vc, qs, sdpa
        torch.cuda.empty_cache()
    attn_split_sweep(B, H, KV, D, dev, g)
    # float32 at the longest cache: the kernel's FMA path, twice the bytes
    T = ATTN_TIME_T[-1]
    q = torch.randn(B, H, D, generator=g, device=dev)
    k = torch.randn(B, T, KV, D, generator=g, device=dev)
    v = torch.randn(B, T, KV, D, generator=g, device=dev)
    cpos = torch.arange(T, dtype=torch.int32, device=dev)
    ms32 = graph_ms(lambda: decode_attn(q, k, v, cpos, T - 1), 10)
    if ms32:
        nbytes = (k.numel() + v.numel()) * 4
        log("times", f"B7 f32 cache {tuple(k.shape)}: device {ms32:.4f} ms a "
            f"call, {nbytes / (ms32 * 1e-3) / 1e9:.1f} GB/s (float32 runs "
            f"both products on the FMA pipe, bf16 on the tensor cores)")
    del q, k, v
    torch.cuda.empty_cache()
    return row


def attn_split_sweep(B, H, KV, D, dev, g):
    """B7 at the long caches with each cluster size P (the C entry point
    called directly): the measurement behind split_plan's block target."""
    import torch
    from repro_torch.kernels._build import launch
    for T in ATTN_TIME_T[1:]:
        q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
        k = torch.randn(B, T, KV, D, generator=g, device=dev).bfloat16()
        v = torch.randn(B, T, KV, D, generator=g, device=dev).bfloat16()
        cpos = torch.arange(T, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        cols = []
        for P in (1, 2, 3, 4, 8):
            ms = graph_ms(lambda: launch(
                "decode_attn_bf16", dev, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), cpos.data_ptr(), out.data_ptr(), B, T, H, KV,
                D, T - 1, 0, P), 10)
            cols.append(f"P = {P} ({B * KV * P} blocks) "
                        + ("not measured" if ms is None else f"{ms:.4f} ms"))
        log("times", f"B7 bf16 cache {tuple(k.shape)} by cluster size, device "
            f"ms a call (CUDA graph of 10 calls): " + ", ".join(cols))
        del q, k, v
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The paper's branchy CNNs and the training path
# ---------------------------------------------------------------------------

def _tf32_on():
    """Turn the global TF32 flags on and return a function that restores
    them: the CNN and train paths must not depend on them."""
    import torch
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    def restore():
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    return restore


def branchy_gate_check(dev) -> float:
    """B6 at the branchy exits' shapes against its plain version (conf to
    a relative 1e-5, argmax equal, the same bits on a repeat call)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ee_gate.ops import ee_gate, gate_plan
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.ee_gate.ref import ee_gate_ref
    err = 0.0
    for B, V in BRANCHY_GATE_SHAPES:
        x = torch.as_tensor(np.random.default_rng(B).normal(size=(B, V)) * 3,
                            dtype=torch.float32, device=dev)
        conf, arg = ee_gate(x)
        again = ee_gate(x)
        conf_p, arg_p = ee_gate_ref(x)
        torch.cuda.synchronize()
        rel = _rel_err(conf, conf_p)
        tag = f"B6 {(B, V)} float32 P={gate_plan(B, V, sm_count(dev))}"
        check(rel <= 1e-5, f"{tag}: conf off by {rel:.3g} relative")
        check(torch.equal(arg, arg_p), f"{tag}: argmax differs")
        check(torch.equal(conf, again[0]) and torch.equal(arg, again[1]),
              f"{tag}: a repeat call gave other bits")
        err = max(err, max_abs_err(conf, conf_p))
        ms = _program_ms(lambda: ee_gate(x), 20)
        plain = _program_ms(lambda: ee_gate_ref(x), 20)
        lib = _program_ms(lambda: torch.softmax(x, -1).max(-1), 20)
        nbytes = x.numel() * 4 + B * 8
        bound = max(nbytes / HBM_BYTES_PER_S,
                    4 * x.numel() / PEAK_OPS_PER_S["float32"]) * 1e3
        log("branchy", f"{tag} (rows {V * 4} B apart: the scalar head and "
            f"tail path): conf within {rel:.3g} relative, argmax equal, the "
            f"same bits on a repeat call; device ms a call kernel {ms:.4f}, "
            f"plain {plain:.4f}, library softmax(x).max(-1) {lib:.4f}, "
            f"bound {bound:.6f} ms by bytes ({nbytes} B)")
    return err


def _branchy_pair(name, kw, seed, dev):
    """A branchy model on ``dev`` and its copy on the CPU, same weights."""
    from repro_torch.models.branchy import PAPER_MODELS
    net = PAPER_MODELS[name](**kw).init(seed=seed, device=dev)
    cpu = PAPER_MODELS[name](**kw).init(seed=seed, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    return net, cpu


def _branchy_macs(net) -> float:
    """MACs of one image through every block and every exit head."""
    pf = net.extract_profile()
    return sum(pf.block_ops) + sum(e.ops for e in pf.exits)


def _same_gate(net, lg, lc, pg, eg, pc, ec, thr, what):
    """``infer`` on CUDA against the CPU path, on the samples whose
    decision the forward's rounding cannot move: an exit taken is
    compared where, at every gate before the last, the confidence from
    each path's logits lies on the same side of the threshold and more
    than 1e-6 from it; a prediction where, at the exit taken, both
    paths' logits have the same argmax and top two probabilities more
    than 1e-6 apart.  Requires half the samples compared.  Returns
    (exits compared, predictions compared)."""
    import torch
    eb = net.exit_blocks()
    B = lc[eb[0]].shape[0]
    clear = torch.ones(B, dtype=torch.bool)
    sure = []
    for j, b in enumerate(eb):
        ps = [torch.softmax(x, -1) for x in (lg[b].cpu(), lc[b])]
        top = [p.topk(2, -1).values for p in ps]
        sure.append((ps[0].argmax(-1) == ps[1].argmax(-1))
                    & ((top[0][:, 0] - top[0][:, 1]) > 1e-6)
                    & ((top[1][:, 0] - top[1][:, 1]) > 1e-6))
        if j < len(eb) - 1:
            d = [t[:, 0] - thr[j] for t in top]
            clear &= (d[0] * d[1] > 0) & (d[0].abs() > 1e-6) \
                & (d[1].abs() > 1e-6)
    check(int(clear.sum()) * 2 >= B, f"{what}: only {int(clear.sum())} of "
          f"{B} samples clear of the thresholds")
    check(torch.equal(eg.cpu()[clear], ec[clear]),
          f"{what}: exits differ from the CPU path")
    pick = torch.stack(sure, 1).gather(1, ec.long()[:, None])[:, 0] & clear
    check(torch.equal(pg.cpu()[pick], pc[pick]),
          f"{what}: predictions differ from the CPU path")
    return int(clear.sum()), int(pick.sum())


def phase_branchy(dev, counters):
    """The paper's DNNs at Table III widths, float32, seeded weights:
    B-LeNet, B-AlexNet (227x227x3) and B-ResNet-110.  The forward and
    ``infer`` at B = 256 on CUDA (the global TF32 flags turned on: the
    models turn TF32 off for their own work) against the CPU path within
    1e-4 x max|CPU|; B6 launched once an exit; ``extract_profile`` through
    ``solve_fin`` on the paper scenario equal on CUDA and the CPU; B6 at
    the exits' shapes; images/s, ms a batch against the bound by
    operations at 67 TFLOP/s, device memory high-water."""
    import numpy as np
    import torch
    import repro_torch as T
    from repro_torch.kernels.ee_gate.ops import ee_gate
    err = branchy_gate_check(dev)
    B = BRANCHY_BATCH
    rows, launches = {}, 0
    restore = _tf32_on()
    try:
        for name, kw in BRANCHY_MODELS:
            net, cpu = _branchy_pair(name, kw, 11, dev)
            eb = net.exit_blocks()
            thr = [BRANCHY_THRESHOLD] * (len(eb) - 1)
            x_np = np.random.default_rng(5).normal(
                size=(B,) + net.input_shape).astype(np.float32)
            x = torch.from_numpy(x_np).to(dev)
            _reset(counters)
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                lg, hg = net.apply(x)
                pg, eg = net.infer(x, thr)
            torch.cuda.synchronize()
            n6 = ee_gate.launches
            peak = torch.cuda.max_memory_allocated()
            check(n6 == len(eb), f"[branchy] {name}: B6 launched {n6} times "
                  f"for {len(eb)} exits")
            launches += n6
            check(torch.backends.cudnn.allow_tf32,
                  f"[branchy] {name}: the caller's TF32 flag was not put back")
            t0 = time.perf_counter()
            with torch.no_grad():
                lc, hc = cpu.apply(torch.from_numpy(x_np))
                pc, ec = cpu.infer(torch.from_numpy(x_np), thr)
            t_cpu = time.perf_counter() - t0
            worst = 0.0
            for b, want in list(lc.items()) + [("features", hc)]:
                got = (lg[b] if b != "features" else hg).cpu()
                e = max_abs_err(got, want)
                scale = float(want.abs().max())
                check(e <= 1e-4 * scale, f"[branchy] {name} exit {b}: off by "
                      f"{e:.3g} (> 1e-4 x max|CPU| = {1e-4 * scale:.3g})")
                worst = max(worst, e / scale)
            n_cmp, n_pred = _same_gate(net, lg, lc, pg, eg, pc, ec, thr,
                                       f"[branchy] {name}")
            used = np.bincount(eg.cpu().numpy(), minlength=len(eb)).tolist()
            # the Plane-2 profile of the real network through FIN
            pf = net.extract_profile()
            nw = T.paper_scenario()
            alpha = min(e.accuracy for e in pf.exits)
            found = 0
            for gamma, delta in ((10, 2e-3), (25, 5e-2)):
                req = T.AppRequirements(alpha, delta)
                got = T.solve_fin(nw, pf, req, gamma=gamma, device=dev)
                want = T.solve_fin(nw, pf, req, gamma=gamma, device="cpu")
                check(same_solution(got, want), f"[branchy] {name}: "
                      f"solve_fin on its profile, gamma={gamma}: CUDA differs "
                      f"from the CPU path")
                found += got.found
            macs = _branchy_macs(net)
            with torch.no_grad():
                fwd = cuda_ms(lambda: net.apply(x), 5, 1)
                inf = cuda_ms(lambda: net.infer(x, thr), 5, 1)
            bound = 2 * macs * B / PEAK_OPS_PER_S["float32"] * 1e3
            rows[name] = dict(ms=fwd, infer_ms=inf, bound_ms=bound,
                              images_s=B / (fwd * 1e-3), peak=peak)
            log("branchy", f"{name} {kw or ''} ({sum(p.numel() for p in net.parameters())} "
                f"parameters, {macs / 1e9:.4f} GMAC an image, blocks "
                f"{[int(np.prod(s)) for s in _block_shapes(net)]}): forward "
                f"and infer at B = {B} on CUDA within {worst:.3g} x max|CPU| "
                f"of the CPU path (CPU pass {t_cpu:.3f} s); exits taken "
                f"{used}, {n_cmp} samples clear of the thresholds "
                f"{thr} compared, {n_pred} predictions; B6 launches {n6}; "
                f"solve_fin on its profile equal on CUDA and the CPU "
                f"({found} of 2 found); device ms a batch: forward {fwd:.4f} "
                f"({B / (fwd * 1e-3):.1f} images/s), infer {inf:.4f}; "
                f"bound {bound:.4f} ms by operations ({2 * macs * B:.4g} "
                f"FLOP at 67 TFLOP/s float32), {bound / fwd:.1%} of the "
                f"bound; max_memory_allocated {peak} B")
            del net, cpu, lg, hg, x
            torch.cuda.empty_cache()
    finally:
        restore()
    return rows, launches, err


def _block_shapes(net):
    shape, out = net.input_shape, []
    for blk in net.blocks:
        shape = blk.out_shape(shape)
        out.append(shape)
    return out


def _branchy_train_steps(net, x, y, steps, lr):
    """``steps`` AdamW steps of the joint loss on one batch; the losses
    and each step's wall (synchronized)."""
    import torch
    from repro_torch.optim import AdamW
    params = dict(net.named_parameters())
    opt = AdamW(lr=lr)
    state = opt.init(params)
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, grads = net.value_and_grad(x, y)
        _, state = opt.update(grads, state, params)
        losses.append(float(loss))
        if x.is_cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return losses, walls


def phase_branchy_train(dev):
    """B-ResNet-110 for 20 AdamW steps of ``BranchyModel.loss`` on
    ``synthetic_images(0, 256, (32, 32, 3), 10)`` on CUDA (the loss
    falls); then B-LeNet for 5 steps on CUDA against the CPU path, the
    loss within a relative 1e-4 a step (the parameters' distance after is
    logged: AdamW turns a gradient near zero whose sign the two paths
    round apart into a step of +-lr)."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic_images
    from repro_torch.models.branchy import b_resnet
    restore = _tf32_on()
    try:
        net = b_resnet(blocks_per_stage=18).init(seed=12, device=dev)
        x, y = synthetic_images(0, BRANCHY_BATCH, (32, 32, 3), 10)
        x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        torch.cuda.reset_peak_memory_stats()
        losses, walls = _branchy_train_steps(net, x, y, BRANCHY_TRAIN_STEPS,
                                             1e-3)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"[branchy_train] B-ResNet-110: the loss did not fall: "
              f"{losses}")
        ms = float(np.median(walls[1:])) * 1e3
        bound = 6 * _branchy_macs(net) * BRANCHY_BATCH \
            / PEAK_OPS_PER_S["float32"] * 1e3
        log("branchy_train", f"B-ResNet-110 B = {BRANCHY_BATCH}, "
            f"{BRANCHY_TRAIN_STEPS} AdamW steps (lr 1e-3): loss "
            f"{losses[0]:.6g} -> {losses[-1]:.6g} ({[f'{v:.4g}' for v in losses]}); "
            f"ms a step (host wall, synchronized, median of steps 1-"
            f"{BRANCHY_TRAIN_STEPS - 1}) {ms:.3f}, first {walls[0] * 1e3:.3f}; "
            f"{BRANCHY_BATCH / (ms * 1e-3):.1f} images/s; bound {bound:.4f} "
            f"ms by operations (forward + backward = 3 x forward at 67 "
            f"TFLOP/s float32), {bound / ms:.1%} of the bound; "
            f"max_memory_allocated {peak} B")
        del net, x, y
        torch.cuda.empty_cache()
        gpu, cpu = _branchy_pair("b-lenet", {}, 13, dev)
        xs, ys = synthetic_images(1, BRANCHY_BATCH, (28, 28, 1), 10)
        xs, ys = torch.from_numpy(xs), torch.from_numpy(ys)
        lg, _ = _branchy_train_steps(gpu, xs.to(dev), ys.to(dev),
                                     LENET_PARITY_STEPS, 1e-3)
        lc, _ = _branchy_train_steps(cpu, xs, ys, LENET_PARITY_STEPS, 1e-3)
        rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
        check(rel <= 1e-4, f"[branchy_train] B-LeNet: CUDA losses {lg} vs "
              f"CPU {lc} (relative {rel:.3g} > 1e-4)")
        worst = _leafwise([p.detach() for p in gpu.parameters()],
                          [p.detach() for p in cpu.parameters()], None,
                          "[branchy_train] B-LeNet")
        log("branchy_train", f"B-LeNet {LENET_PARITY_STEPS} AdamW steps on "
            f"CUDA vs the CPU path: losses within {rel:.3g} relative a step "
            f"({lg[0]:.6f} -> {lg[-1]:.6f}); parameters after within "
            f"{worst:.3g} x max|CPU| a parameter")
    finally:
        restore()


def _param_count(cfg) -> int:
    """Parameters of ``cfg``'s model, from one period's shapes on the meta
    device (nothing allocated)."""
    import torch
    from repro_torch.models import transformer as TT
    gen = torch.Generator()
    per = sum(x.numel() for i, s in enumerate(cfg.pattern)
              for x in TT._tree_leaves(TT._layer_init(gen, cfg, s,
                                                      torch.float32, "meta")))
    d, V = cfg.d_model, cfg.padded_vocab
    return (per * cfg.n_periods + V * d * (1 if cfg.tie_embeddings else 2)
            + d * (1 + len(cfg.exit_layer_list)))


def phase_train(dev):
    """qwen3-4b at full width and depth (36 layers, bf16, float32 moments,
    ``remat="full"``) through ``train()`` for 8 steps at B = 4, S = 512 on
    the k-gram stream: finite losses, the last below the first; ms a step,
    tokens/s and the memory high-water against 8 N tokens at 989 TFLOP/s.
    Should the state not fit, the depth (never the width) is cut and
    logged."""
    import gc
    import numpy as np
    import torch
    from repro_torch.runtime.train_loop import train
    gc.collect()
    torch.cuda.empty_cache()
    restore = _tf32_on()
    try:
        for periods in (None, 24, 12):
            cfg = _arch_cfg(TRAIN_ARCH, periods, remat="full")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                res = train(cfg, n_steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ, seed=0, log_every=0, device=dev)
                break
            except torch.cuda.OutOfMemoryError as e:
                log("train", f"{cfg.n_layers} layers do not fit "
                    f"({str(e)[:160]}); cutting depth")
                gc.collect()
                torch.cuda.empty_cache()
        else:
            raise PhaseFailed("[train] no depth fits")
    finally:
        restore()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = res.losses
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"[train] losses not finite: {losses}")
    check(losses[-1] < losses[0], f"[train] the loss did not fall: {losses}")
    N = _param_count(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = float(np.median(res.step_times[1:])) * 1e3
    bound = 8 * N * tokens / 989e12 * 1e3
    state = N * 2 * 2 + N * 4 * 2
    log("train", f"{TRAIN_ARCH} {cfg.n_layers} layers at full width "
        f"({N} parameters, bf16, float32 moments, remat={cfg.remat}), "
        f"{TRAIN_STEPS} steps at B = {TRAIN_BATCH}, S = {TRAIN_SEQ} "
        f"through train() ({wall:.3f} s with the init): losses "
        f"{[round(v, 4) for v in losses]}; ms a step (host wall to the "
        f"loss, median of steps 1-{TRAIN_STEPS - 1}) {ms:.3f}, first "
        f"{res.step_times[0] * 1e3:.3f}; {tokens / (ms * 1e-3):.1f} "
        f"tokens/s; bound {bound:.3f} ms (8 N tokens = {8 * N * tokens:.4g} "
        f"FLOP at 989 TFLOP/s bf16), {bound / ms:.1%} of the bound; "
        f"max_memory_allocated {peak} B (params + grads + moments "
        f"{state} B)")
    return dict(ms=ms, bound_ms=bound, tokens_s=tokens / (ms * 1e-3),
                peak=peak, ce_calls=1 + len(cfg.exit_layer_list))


def _leafwise(a, b, tol, what):
    """Two trees of float tensors (``a`` on the card, ``b`` on the CPU)
    leaf by leaf, on the card a piece at a time (a CPU comparison of
    mixtral's 2.4 G-element expert leaf would hold tens of GB): the worst
    max|a - b| / max|b|, which must be within ``tol`` unless ``tol`` is
    None."""
    import torch
    from repro_torch.optim.adamw import pieces, tree_leaves
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        y = y.to(x.device)
        e = scale = 0.0
        for px, py in zip(pieces(x), pieces(y)):
            check(bool(torch.isfinite(px).all() and torch.isfinite(py).all()),
                  f"{what}: a leaf is not finite")
            e = max(e, float((px - py).abs().max()))
            scale = max(scale, float(py.abs().max()))
        del y
        check(scale > 0 or e == 0, f"{what}: a leaf is zero on the CPU only")
        worst = max(worst, e / scale if scale else 0.0)
    check(tol is None or worst <= tol, f"{what}: a leaf off by {worst:.3g} "
          f"x max|CPU| (> {tol})")
    return worst


def phase_train_parity(dev):
    """In float32, on CUDA against the CPU path: ``loss_fn`` and its
    gradients (1e-4 x max|CPU| a leaf), then 3 ``build_train_step`` steps
    (loss and gradient norm within 1e-4 relative each step; the
    parameters' distance after is logged), for qwen3-4b widths at 2
    layers, mamba2-1.3b and mixtral widths at 1 period.  Then ``train()`` on the reduced qwen3-4b with a
    checkpoint at step 4 and a resume to step 8 on CUDA, equal to the
    uninterrupted run's losses within a relative 1e-5, a tolerance for any
    backward that adds with atomics on the card (the embedding's sums its
    rows in a fixed order); the count of bit-equal losses is logged."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.data import LMStreamConfig, SyntheticLMStream
    from repro_torch.models import transformer as TT
    from repro_torch.runtime import steps as S
    from repro_torch.runtime.train_loop import batch_to, train
    restore = _tf32_on()
    try:
        for arch, periods in TRAIN_PARITY:
            cfg = _arch_cfg(arch, periods, dtype="float32", remat="full")
            params = TT.init_model(cfg, seed=21, device=dev)
            cpu = TT.tree_to(params, "cpu")
            stream = SyntheticLMStream(LMStreamConfig(
                cfg.vocab_size, TRAIN_PARITY_SEQ, TRAIN_PARITY_BATCH, seed=3))
            b0 = stream.batch(0)
            lg, gg = S.value_and_grad(lambda p: TT.loss_fn(
                p, cfg, batch_to(b0, dev)), params)
            t0 = time.perf_counter()
            lc, gc_ = S.value_and_grad(lambda p: TT.loss_fn(
                p, cfg, batch_to(b0, "cpu")), cpu)
            t_cpu = time.perf_counter() - t0
            rel = abs(float(lg) - float(lc)) / abs(float(lc))
            check(rel <= 1e-5, f"[train_parity] {arch}: loss_fn {float(lg)} "
                  f"vs CPU {float(lc)}")
            g_worst = _leafwise(gg, gc_, 1e-4, f"[train_parity] {arch} "
                                f"gradients")
            del gg, gc_
            step = S.build_train_step(cfg)
            sg = {"params": params, "opt": S.make_optimizer(cfg).init(params)}
            sc = {"params": cpu, "opt": S.make_optimizer(cfg).init(cpu)}
            step_rel, t_steps = [], [0.0, 0.0]
            for i in range(3):
                t0 = time.perf_counter()
                sg, mg = step(sg, batch_to(stream.batch(i), dev))
                float(mg["loss"])
                t1 = time.perf_counter()
                sc, mc = step(sc, batch_to(stream.batch(i), "cpu"))
                t_steps[0] += t1 - t0
                t_steps[1] += time.perf_counter() - t1
                for k in ("loss", "grad_norm"):
                    r = abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
                    check(r <= 1e-4, f"[train_parity] {arch} step {i}: {k} "
                          f"{float(mg[k])} vs CPU {float(mc[k])}")
                    step_rel.append(r)
            p_worst = _leafwise(sg["params"], sc["params"], None, "")
            log("train_parity", f"{arch} widths at {cfg.n_layers} layers, "
                f"f32 ({TT.param_count(params)} parameters, exits "
                f"{cfg.exit_layer_list}), B = {TRAIN_PARITY_BATCH}, S = "
                f"{TRAIN_PARITY_SEQ}: loss_fn within {rel:.3g} relative, "
                f"gradients within {g_worst:.3g} x max|CPU| a leaf (CPU pass "
                f"{t_cpu:.3f} s); 3 train steps ({t_steps[0]:.3f} s on CUDA, "
                f"{t_steps[1]:.3f} s on the CPU), losses and gradient norms "
                f"within {max(step_rel):.3g} relative, parameters after "
                f"within {p_worst:.3g} x max|CPU| a leaf")
            del params, cpu, sg, sc, step
            gc.collect()
            torch.cuda.empty_cache()
        cfg = get(TRAIN_ARCH, reduced=True)
        kw = dict(global_batch=8, seq_len=64, seed=0, log_every=0, device=dev)
        full = train(cfg, n_steps=8, **kw)
        d = tempfile.mkdtemp(prefix="train_resume_")
        try:
            first = train(cfg, n_steps=4, ckpt_dir=d, ckpt_every=4, **kw)
            second = train(cfg, n_steps=8, ckpt_dir=d, **kw)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        check(second.resumed_from == 4 and second.steps == 8,
              f"[train_parity] resume started at {second.resumed_from}")
        got = first.losses + second.losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, full.losses))
        check(rel <= 1e-5, f"[train_parity] resumed losses {got} vs "
              f"uninterrupted {full.losses}")
        same = sum(a == b for a, b in zip(got, full.losses))
        log("train_parity", f"reduced {TRAIN_ARCH} (f32) train() 8 steps "
            f"on CUDA, checkpoint at 4 and a resume to 8: losses within "
            f"{rel:.3g} relative of the uninterrupted run ({same} of 8 "
            f"bit-equal; tolerance 1e-5); loss {full.losses[0]:.4f} -> {full.losses[-1]:.4f}")
    finally:
        restore()


def ce_program_times(dev, calls):
    """``chunked_cross_entropy`` forward plus backward at [train]'s shape
    (qwen3-4b: B = 4, S = 512, d = 2,560, V_pad = 153,600, bf16 hiddens
    and head, chunk 256): device ms a call against the bound of its 6 B S
    d V FLOP at 989 TFLOP/s (forward 2, backward 4; the recompute of the
    checkpointed chunk is the implementation's) and of its bytes."""
    import numpy as np
    import torch
    from repro_torch.models.layers import chunked_cross_entropy
    cfg = _arch_cfg(TRAIN_ARCH)
    B, Sq, d, V = TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, cfg.padded_vocab
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((B, Sq, d), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    w = (torch.randn((d, V), generator=gen, device=dev) / d ** 0.5).to(
        torch.bfloat16).requires_grad_(True)
    labels = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, Sq)), device=dev)

    def fwd_bwd():
        loss = chunked_cross_entropy(h, w, labels, cfg.vocab_size)
        return torch.autograd.grad(loss, (h, w))

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(fwd_bwd, 5, 2)
    peak = torch.cuda.max_memory_allocated()
    nbytes = 2 * (h.numel() + w.numel()) * 2 + labels.numel() * 8
    row = _program_row("chunked_cross_entropy (forward + backward)", ms,
                       calls, nbytes, 6 * B * Sq * d * V, 989e12, None)
    log("programs", f"chunked_cross_entropy at [B, S, d, V_pad] = "
        f"{[B, Sq, d, V]}: max_memory_allocated {peak} B (the full logits "
        f"would be {B * Sq * V * 4} B)")
    return row


TIMES = ("chain", "dense", "kbest", "gate", "attn", "plan", "ingest",
         "serve")


def times_only(dev, which, counters) -> None:
    """``--times``: the named timings alone (all without a name), for
    comparing two checkouts in one call on one card."""
    grid = full_grid() if {"chain", "dense", "kbest"} & set(which) else None
    if "chain" in which:
        chain_times(grid, dev, {"chain": None}, times_raw(grid, dev))
    if "dense" in which:
        dense_times(grid, dev, {"minplus_vecmat": None,
                                "minplus_vecmat_argmin": None})
    if "kbest" in which:
        kbest_times(grid, dev, {"kbest": None}, *times_inputs(grid, dev))
    if "gate" in which:
        gate_times(dev, None)
    if "attn" in which:
        attn_times(_serve_cfg(), dev, None)
    if "plan" in which:
        plan_times(dev, counters)
    if "ingest" in which:
        ingest_times(dev, None)
    if "serve" in which:
        _serve_path("serve", _serve_cfg(), dev, counters)


def main(argv) -> int:
    _preflight()
    import torch
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.ee_gate.ops import ee_gate, quant_signature_rows
    from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                                 banded_minplus_chain,
                                                 banded_minplus_chain_kbest,
                                                 minplus_vecmat,
                                                 minplus_vecmat_argmin)
    dev = torch.device("cuda", 0)
    # float32 products in full float32: the f32 comparisons against the CPU
    # path ([serve_parity]) rest on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (banded_minplus_chain, banded_minplus_argmin,
                banded_minplus_chain_kbest, minplus_vecmat,
                minplus_vecmat_argmin, ee_gate, decode_attn,
                quant_signature_rows)

    if argv[:1] == ["--multihost-rank"] and len(argv) == 4:
        multihost_rank(int(argv[1]), int(argv[2]), argv[3])
        return 0
    if argv and (argv[0] != "--times" or not set(argv[1:]) <= set(TIMES)):
        print(f"usage: python3 chip_smoke.py [--times [{'] ['.join(TIMES)}]]"
              f"; got {argv}", file=sys.stderr)
        return 2
    phase_environment()
    if argv:
        times_only(dev, argv[1:] or TIMES, counters)
        return 0
    err = phase_kernels(dev)
    err.update(phase_kernels_dense(dev))
    err["ingest"] = phase_kernels_ingest(dev)
    grid = full_grid()
    phase_graphs(grid, dev)
    phase_solve_fin(dev)
    launches, wall, sols = phase_solve_many(grid, dev, counters)
    launches_d, _, b4_path_ms = phase_solve_many_dense(grid, dev, counters,
                                                       sols, wall)
    del sols
    launches_t7 = phase_table7_dense(dev, counters)
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
    # B2 on the population tick
    launches_pop = phase_pop_tick(dev, counters)
    ingest_row = ingest_times(dev, err["ingest"])
    ingest_row["launches"] = launches_pop["quant_signature_rows"]
    rows.append(ingest_row)
    # the churn orchestrator and the modules it imports
    paths = {"churn": phase_churn(dev, counters),
             "congestion": phase_congestion(dev, counters),
             "failover": phase_failover(dev, counters),
             "multiapp": phase_multiapp(dev, counters)}
    # the fault-tolerance layer: checkpoint / resume, the users mesh on one
    # and two ranks, elastic failover
    paths["resume"] = phase_resume(dev, counters)
    paths["mesh"] = phase_mesh(dev, counters)
    paths["multihost"] = phase_multihost()
    paths["elastic"] = phase_elastic(dev, counters)
    # B4 on solve_many(backend="dense"), B5 on the Table VII path
    dense_rows, table7_layer = dense_times(grid, dev, err)
    for row, path in zip(dense_rows, (launches_d, launches_t7)):
        row["launches"] = path[row["name"]]
        check(row["launches"] > 0, f"{row['name']}: no launch on its path")
    rows += dense_rows
    err_serve = phase_kernels_serve(dev)
    params, cfg, launches_s, serve = phase_serve(dev, counters)
    serve_rows = [gate_times(dev, err_serve["ee_gate"]),
                  attn_times(cfg, dev, err_serve["decode_attn"])]
    for row in serve_rows:
        row["launches"] = launches_s[row["name"]]
        check(row["launches"] > 0, f"{row['name']}: no launch on its path")
    rows += serve_rows
    del params
    torch.cuda.empty_cache()
    phase_serve_parity(dev)
    # the rest of model serving: Mamba-2, MoE, prefill and encode
    launches_ssm, serve_ssm = phase_serve_ssm(dev, counters)
    launches_moe, serve_moe = phase_serve_moe(dev, counters)
    phase_prefill(dev)
    phase_serve_parity_more(dev)
    ssd_program_times(dev, serve_ssm["ssd_calls"])
    moe_row = attn_times_moe(dev, err_serve["decode_attn"])
    moe_row["launches"] = launches_moe["decode_attn"]
    check(moe_row["launches"] > 0, "decode_attn: no launch on [serve_moe]")
    check(launches_ssm["ee_gate"] > 0 and launches_moe["ee_gate"] > 0,
          "ee_gate: no launch on [serve_ssm] or [serve_moe]")
    rows.append(moe_row)
    # the paper's branchy CNNs (B6 at the exits) and the training path
    walls, t0 = {}, time.perf_counter()
    _, launches_branchy, _ = phase_branchy(dev, counters)
    check(launches_branchy > 0, "ee_gate: no launch on [branchy]")
    walls["branchy"], t0 = time.perf_counter() - t0, time.perf_counter()
    phase_branchy_train(dev)
    walls["branchy_train"], t0 = time.perf_counter() - t0, time.perf_counter()
    train_row = phase_train(dev)
    walls["train"], t0 = time.perf_counter() - t0, time.perf_counter()
    phase_train_parity(dev)
    walls["train_parity"], t0 = time.perf_counter() - t0, time.perf_counter()
    ce_program_times(dev, train_row["ce_calls"])
    walls["programs ce"] = time.perf_counter() - t0
    log("order", f"B6 launches on [branchy]: {launches_branchy}; phase "
        f"walls (s): " + ", ".join(f"[{k}] {v:.1f}" for k, v in walls.items())
        + f"; since the start {time.perf_counter() - T_START:.1f}")
    log("order", f"launches on [serve_ssm]: B6 {launches_ssm['ee_gate']}, "
        f"B7 {launches_ssm['decode_attn']}, B1 "
        f"{launches_ssm['banded_minplus_chain']}; on [serve_moe]: B6 "
        f"{launches_moe['ee_gate']}, B7 {launches_moe['decode_attn']}, B1 "
        f"{launches_moe['banded_minplus_chain']}; plain programs "
        f"{serve_moe['programs']}")
    # B5's launches on its path are Table VII layers, not the [times] shape
    at_path = {r["name"]: (r["ms"], r["bound_ms"]) for r in rows}
    at_path["minplus_vecmat"] = table7_layer
    order = sorted(((r["launches"] * (at_path[r["name"]][0]
                                      - at_path[r["name"]][1]), r["name"])
                    for r in rows), reverse=True)
    log("order", "launches x (time - bound) on each kernel's path (B5 at the "
        "gamma-25 Table VII layer, CUDA-graph time; the others at their "
        "[times] shape): "
        + ", ".join(f"{n} {v:.4f} ms" for v, n in order)
        + "; B4's whole device time on [solve_many_dense] (torch.profiler): "
        + ("not measured" if b4_path_ms is None else f"{b4_path_ms:.4f} ms")
        + f"; B1 launches on [pop_tick]: "
        f"{launches_pop['banded_minplus_chain']}; B1 / B2 / B3 launches on "
        + ", ".join(f"[{k}] {v['B1']} / {v['B2']} / {v['B3']}"
                    for k, v in paths.items()))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
