"""Drive the PyTorch port of the FIN placement system on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

It builds every hand-written kernel of ``src/repro_torch`` (the banded
(min,+) argmin chain B1 and k-slot chain B3, the dense (min,+) products B5
and B4, the exit gate B6, the flash-decode attention B7, the population
tick's fused ingest B2, the flash-prefill attention B8, the SSD chunked
scan B9, the MoE experts' SwiGLU B10, the training loss B11, and the
train step's optimizer programs, the gradients' global norm B12 and
AdamW's update with the clip folded in B13; one ``nvcc`` per source, all
in parallel), holds each against its plain PyTorch version on the card
([kernels_prefill] for B8 and B9: float32 and bf16, every head grouping
and width of the registry, causal, windowed and bidirectional masks,
ragged keys, -1 slots, masked leading tiles, dead rows; ragged chunks of
8, 13 and 256 rows; [kernels_moe] for B10, inside [serve_moe]: float32
and bf16 at mixtral's decode and prefill shapes with the path's layer-0
weights, and small cases: a dead expert with NaN weights, every slot
valid, C no tile multiple, 16 experts; [kernels_ce] for B11: float32
and bf16, ragged rows, -1 labels and every label -1, a padded vocab tail,
a label in the last live column, the tied table.T head, g != 1, several
backward passes, and [train]'s call, mamba2's tied head and
[train_parity]'s call at full width, then heads split over 2-4 vocab
shards, the ranks run in turn; [kernels_adamw] for B12 and B13: every
dtype instantiation of p, g and the moments, misaligned views and odd
sizes, with and without the folded clip, B13 bit-equal, B12 repeating
bit for bit within 1e-6 of its plain version and a float64 sum), checks graph
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
                      depth in bf16 (48 SSM layers: B14 once a layer a
                      step, B6 and B1, no B7), then a 4,096-token
                      ``prefill`` (B9 once a layer);
  [serve_moe]         the same on mixtral-8x22b at full width cut to 4 of
                      its 56 periods (B7 at G = 6, D = 128), then a
                      4,608-token ``prefill`` into its 4,096-slot window
                      (the ring slots wrap; B8 once a layer) and 8 decode
                      steps at B = 1 (B10 once an MoE layer throughout:
                      4 calls a decode step, 4 a prefill), then
                      [kernels_moe] on its layer-0 weights;
  [prefill]           teacher forcing on the card in float32 (prefill of
                      S - 1 tokens plus a decode step equals
                      ``forward_train``): qwen3-4b at 3 layers, mamba2-1.3b
                      whole, mixtral at 4 periods past its window; and
                      hubert-xlarge's ``encode`` at full width in bf16 (B8
                      once a layer);
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
                      loss falls; B13 once a step); B-LeNet 5 steps
                      against the CPU path;
  [train]             qwen3-4b at full width and depth (bf16, float32
                      moments, ``remat="full"``) through ``train()``, 8
                      steps at B = 4, S = 512 (B11 three calls a step, B12
                      and B13 one each), then one more step under
                      torch.profiler, split by family (products, B8, B11,
                      copies) and range (clip: B12's call, AdamW: B13's);
  [train_parity]      ``loss_fn``, its gradients and 3 train steps in
                      float32 on CUDA against the CPU path (qwen3-4b widths
                      at 2 layers, mamba2 and mixtral at 1 period), and a
                      checkpoint / resume through ``train()``;
  [dryrun]            ``launch.dryrun.run_cell`` for every cell of
                      ``all_cells()`` on both production meshes, baseline
                      and optimized (meta tensors only: the card's
                      ``memory_allocated`` does not move), and
                      ``launch.report.roofline_table`` over them;
  [examples]          the four examples of ``examples_torch/`` on the card
                      (``train_lm`` 40 steps; its loss falls).

[serve], [serve_ssm], [serve_moe] and [train] also hold ``params_shapes``,
``cache_shape_dtypes`` and ``train_state_shapes`` (meta trees) to the trees
they build on the card, and print the port's analytic roofline of the
path's own step (``launch.analytic`` + ``launch.roofline``) beside its
measured time, with both parameter counts.

It then times the kernels at their paths' shapes (B7 also at mixtral's
heads over 4,096 slots; B8 and B9 at their prefills' shapes beside their
plain versions and, for B8, scaled_dot_product_attention; B10 at
[serve_moe]'s decode and prefill shapes beside its plain version, the
three cuBLAS products alone and the whole ``_moe_gather``), B11
(``chunked_cross_entropy`` forward plus backward) at [train]'s shape beside
its plain version, the parent's chunked program and the library route
(two calls: cuBLAS ``mm(out_dtype=float32)`` and ``F.cross_entropy``)
([programs]), B12 and B13 at [train]'s tree beside their plain versions,
``torch._foreach_norm`` and ``torch._fused_adamw_`` (at bf16 moments: it
takes one dtype a leaf), relaxes 2^20 scenario rows at population size,
and prints the kernels JSON line (B1-B13) followed by the final status
line.  The launch counters of B8, B9 and B10 are reset before
[serve_moe]'s and [serve_ssm]'s prefills, [prefill]'s cases, hubert's
timed ``encode``, [serve_parity]'s mixtral, [train_parity] and
[sharded]'s sharded train step, and printed after each; B11's, B12's
and B13's before [train], [train_parity] and [sharded]'s steps (on
DTensors B11 runs on each rank's shards through ``local_map``, B12 and
B13 on the local shards), B13's before [branchy_train].  Every failing
phase raises; without a CUDA card, or
without the repository beside it, it exits non-zero and prints no result.

  python3 chip_smoke.py --times [chain] [dense] [kbest] [gate] [attn] [plan]
                                [ingest] [serve] [prefill] [moe] [ce]

builds the kernels and runs only the timings (no checks, no result line):
B1 at the main path's largest launch (20,480 rows) in float64 and float32
with a sweep of its scenarios a group, B1u, B1 at 2^20 rows in both dtypes
and ``batched_banded_relax_argmin`` whole at the 20,480-row launch,
B4 / B5 at the dense path's largest launch and at both Table VII layers,
B3 at the k-best path's largest launch in float64 and float32, at K = 32
and gamma = 10, and at the largest [frontier] launch, B6 at [4, 153,600] in float32 and bf16 on seeded logits, B7, and the
[plan] wall (768 plans, 9 ticks, CUDA and the CPU path), B2 at 1e6 rows
for h4 and h6 (and on the [pop_tick] rows with the packs before and after
the reprices, by graph replays, single launches and torch.profiler),
[serve]'s engine run, B8 at [serve_moe]'s prefill and hubert's encode
shapes and B9 at [serve_ssm]'s prefill shape beside their plain versions
and the library call ([prefill]), B10 at [serve_moe]'s decode and prefill
shapes on one seeded mixtral MoE layer beside its plain version and the
three cuBLAS products ([moe]), B11 at [train]'s call ([ce]), B14 at
[serve_ssm]'s decode shape (256 rows) and jamba's heads beside its plain
version, state and conv cache bit-equal ([ssm]); all of them
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
PREFILL_SOURCE = "src/repro_torch/kernels/prefill_attn/csrc/prefill_attn.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSM_DECODE_SOURCE = "src/repro_torch/kernels/ssm_decode/csrc/ssm_decode.cu"
MOE_SOURCE = "src/repro_torch/kernels/moe_ffn/csrc/moe_ffn.cu"
CE_SOURCE = "src/repro_torch/kernels/linear_ce/csrc/linear_ce.cu"
ADAMW_SOURCE = "src/repro_torch/kernels/adamw/csrc/adamw.cu"
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
# (B, Sq, Sk, H, KV, D, causal, window, mask, chunk) of the flash-prefill
# checks (B8, prefill_inputs): the reduced configs' heads (D = 16, G = 2);
# hubert's (G = 1, D = 80), bidirectional; qwen-like G = 4 at D = 64 with
# -1 key slots and a ragged Sk; mixtral's (G = 6, D = 128) windowed;
# granite's MQA (G = 48); leading key tiles masked for every row by a
# short window; dead rows beside live ones; every row dead;
# [serve_moe]'s prefill shape (4,608 tokens, window 4,096); hubert's full
# encode shape (2 x 1,024 frames, 16 heads of 80, bidirectional); a
# granite-like MQA (G = 48, D = 128, causal) over 1,537 tokens, whose bf16
# tiles hold 2 positions of 48 heads and end on a half tile; 10,000 keys
# with -1 slots, more than the bf16 kernel's shared-memory copy of k_pos
# holds at D = 128; G = 256, which the bf16 kernel cuts into two chunks
# of 128 heads
PREFILL_CHECK_CASES = [(2, 24, 24, 4, 2, 16, True, 0, "full", 32),
                       (1, 100, 100, 16, 16, 80, False, 0, "full", 32),
                       (1, 257, 257, 32, 8, 64, True, 0, "slots", 64),
                       (1, 600, 600, 48, 8, 128, True, 256, "full", 128),
                       (1, 333, 333, 48, 1, 128, True, 0, "full", 1024),
                       (2, 70, 200, 8, 2, 64, True, 16, "lead", 64),
                       (1, 90, 97, 12, 2, 80, True, 0, "dead", 32),
                       (1, 40, 129, 6, 1, 16, False, 0, "empty", 16),
                       (1, 4608, 4608, 48, 8, 128, True, 4096, "full", 1024),
                       (2, 1024, 1024, 16, 16, 80, False, 0, "full", 1024),
                       (1, 1537, 1537, 48, 1, 128, True, 0, "full", 1024),
                       (1, 64, 10000, 32, 4, 128, True, 0, "slots", 1024),
                       (1, 40, 40, 256, 1, 64, True, 0, "full", 32)]
# (B, S, H, P, N, chunk) of the SSD scan checks (B9, ssd_inputs): the
# reduced configs' Q = 8, P = N = 16; Q = 13 with a ragged S; mamba2's
# P = 64, N = 128 at Q = 256 with a short last chunk, and below one chunk
# (Q = S); [serve_ssm]'s prefill shape
SSD_CHECK_CASES = [(2, 24, 4, 16, 16, 8), (2, 37, 4, 16, 16, 13),
                   (1, 600, 8, 64, 128, 256), (1, 100, 3, 64, 128, 256),
                   (1, 4096, 64, 64, 128, 256)]
# (G, t, E, Ck, d, ff, live) of B10's small checks at narrow widths
# (moe_inputs): the decode step's slots (Ck = 1 < C = 8, the stream
# regime), 16 slots an expert (two n8 tiles of slots), 17 (the first
# tensor-core tile shape), Ck = 200 of 600 tokens (C no multiple of the
# 128-row tile; ff no multiple of the 128-column tile), G > 1 with
# Ck < t, every slot valid, jamba's 16 experts, and the wgmma tiles'
# edges (d = 136 and ff = 200: K and N no multiple of 64 or of the column
# block, TMA zero-filling past them; M = 300 with a slot tile crossing
# the groups); "mixed" leaves expert 0 without a token (its weights NaN:
# a block that read them would give NaN) and expert E - 1 with every slot
# valid
MOE_CHECK_CASES = [(4, 1, 8, 1, 128, 256, "mixed"),
                   (1, 1, 8, 1, 64, 128, "mixed"),
                   (2, 8, 8, 8, 64, 192, "mixed"),
                   (17, 1, 4, 1, 64, 128, "mixed"),
                   (1, 600, 8, 200, 256, 320, "mixed"),
                   (3, 40, 4, 24, 128, 256, "all"),
                   (2, 64, 16, 20, 64, 128, "mixed"),
                   (2, 300, 4, 150, 136, 200, "mixed")]
# (G, t) of B10 at mixtral's widths with [serve_moe]'s layer-0 weights:
# the engine's decode step, the decode after the prefill, the prefill
MOE_REAL_SHAPES = [(4, 1), (1, 1), (1, 4608)]
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
# B14 at the served batch of mamba2-1.3b (the benchmark's 256 clients) and
# at jamba's 256 heads, at as many rows as hold the same state bytes
SSM_DECODE_SHAPES = (("mamba2-1.3b", 256), ("jamba-1.5-large-398b", 64))
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
#: [kernels_adamw]: B12 / B13 leaves (1 and 7 elements, a 0-dim leaf, a
#: chunk less and more one, three chunks and a bit, a 2-D leaf, 2^22 + 3),
#: and element offsets of each leaf's tensors into larger buffers:
#: aligned, a shared scalar head, shifts that disagree (element by
#: element)
ADAMW_CHECK_SHAPES = ((1,), (7,), (), (65535,), (65537,), (196613,),
                      (37, 129), (4194307,))
ADAMW_OFFSETS = ((0,), (3,), (0, 1, 2, 5))
#: B12 against its plain version (float32 sums a piece at a time) and a
#: float64 sum, relative
ADAMW_NORM_RTOL = 1e-6
TRAIN_ARCH = "qwen3-4b"
TRAIN_STEPS = 8
TRAIN_BATCH = 4
TRAIN_SEQ = 512
TRAIN_PARITY = (("qwen3-4b", 2), ("mamba2-1.3b", 1), ("mixtral-8x22b", 1))
TRAIN_PARITY_BATCH = 2
TRAIN_PARITY_SEQ = 32
# (case, N, d, V_pad, vocab, tied, g, dl rows a pass or None for one pass)
# of the B11 checks ([kernels_ce]), float32 and bf16: ragged rows (no
# multiple of 128), -1 labels, every label -1, a padded tail no multiple of
# 256 (1,000 = 3 x 256 + 232), a label in the last live column (every case
# has one at row 0), the tied table.T head, g != 1, several backward passes
# on the tied head, an odd count of ragged row tiles (3) and of column tiles
# (5) on the tied head; then, bf16, [train]'s call (qwen3-4b, B = 4, S = 512)
# and mamba2-1.3b's tied head at its width, and, float32, [train_parity]'s
# qwen3-4b call (B = 2, S = 32)
CE_CHECK_CASES = [("ragged", 70, 64, 2048, 2048, False, 1.0, None),
                  ("unlabelled", 300, 128, 1000, 999, False, 1.0, None),
                  ("all_unlabelled", 130, 64, 512, 500, False, 1.0, None),
                  ("padded", 257, 64, 1000, 990, False, 1.0, None),
                  ("last_live", 129, 64, 768, 700, False, 1.0, None),
                  ("tied", 200, 96, 1536, 1500, True, 1.0, None),
                  ("g", 96, 64, 1024, 1000, False, -2.5, None),
                  ("passes", 600, 64, 1024, 1000, True, 0.5, 256),
                  ("odd_tiles", 383, 64, 1280, 1250, True, 1.0, None)]
CE_TRAIN_CASE = ("train", 2048, 2560, 153600, 151936, False, 1.0, None)
CE_WIDE_CASES = [(CE_TRAIN_CASE, "bfloat16"),
                 (("tied_mamba2", 2048, 2048, 51200, 50280, True, 1.0, None),
                  "bfloat16"),
                 (("parity", 64, 2560, 153600, 151936, False, 1.0, None),
                  "float32")]
# (case, N, d, V_pad, vocab, tied, ranks, dtype) of B11 on a vocab-sharded
# head ([kernels_ce]), the ranks run one after another on the card: each
# rank's K1 partials, the combine over all of them, K2 and K3 on its
# columns; the last rank all padding (1,000 of 1,024 over 4: 768-1,023),
# the tied head, and [train]'s head over 4 ranks
CE_SHARD_CASES = [("shards_dead", 300, 128, 1024, 700, False, 4, "float32"),
                  ("shards_dead", 300, 128, 1024, 700, False, 4, "bfloat16"),
                  ("shards_tied", 257, 64, 2048, 2000, True, 2, "bfloat16"),
                  ("shards_train", 2048, 2560, 153600, 151936, False, 4,
                   "bfloat16")]
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
#: [sharded]: the model's steps over DTensors on a ("data", "model") =
#: (1, SHARDED_WORLD) DeviceMesh, this script started once a rank with
#: ``--sharded-rank r SHARDED_WORLD port``.  Two gloo ranks on the one card
#: would be the tensor-parallel run, but DTensor's collectives are the
#: functional ones, and ``_c10d_functional.all_gather_into_tensor`` then
#: ``wait_tensor`` over gloo on CUDA tensors ends both ranks with SIGSEGV
#: on the card's torch (2.11.0+cu128; gloo's own all_reduce / all_gather /
#: reduce_scatter on CUDA tensors and the functional all-gather on CPU
#: tensors work), and NCCL refuses two ranks on one card.  So the phase
#: runs one process over a (1, 1) NCCL mesh: every tensor a DTensor, every
#: collective over a mesh dimension of one.
SHARDED_WORLD = 1
SHARDED_BACKEND = "nccl"
#: decode: qwen3-4b at full width and depth, B = 4, a 256-slot cache, a
#: 16-token prefill, 8 steps; train: 2 periods, seq_parallel, B = 2, S = 128
SHARDED_BATCH, SHARDED_CACHE, SHARDED_PROMPT, SHARDED_STEPS = 4, 256, 16, 8
SHARDED_TRAIN_PERIODS, SHARDED_TRAIN_B, SHARDED_TRAIN_S = 2, 2, 128
#: the CPU test's bf16 tolerance (tests/test_torch_sharded.py, the
#: reference's rtol on the loss)
SHARDED_RTOL = 5e-3
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


def queued_ms(fn, reps: int, lead_cycles: int = 400_000_000):
    """(device ms, host ms) of ``fn`` a call when the host runs ahead of
    the card, as it does in a train step: the stream first sleeps
    ``lead_cycles`` clock cycles while the host queues ``reps`` calls,
    then CUDA events time the calls.  For calls that cannot be captured
    into a graph and whose host work is as long as their device time (the
    optimizer kernels build their chunk table on the host at each call).
    Logged if the host had not queued every call when the sleep ended:
    the device time then holds host gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(lead_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    lead = ev[0].elapsed_time(ev[1])
    if host >= lead:
        log("times", f"queued_ms: the host took {host:.3f} ms to queue "
            f"{reps} calls, longer than the {lead:.3f} ms lead: the device "
            f"time holds host gaps")
    return ev[1].elapsed_time(ev[2]) / reps, host / reps


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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_environment():
    import torch
    from repro_torch.kernels._build import load_library
    print(card_line(), flush=True)
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


def _sharded_param_bound(w, mu, opt, rtol):
    """tests/test_torch_sharded.py's bound on an updated parameter, at
    ``rtol``, plus one bf16 ulp of its value."""
    g = mu.double() / (1 - opt.b1)
    amp = opt.eps / (g.abs() + opt.eps) ** 2
    return (2 ** -7 * w.double().abs() + rtol * float(w.abs().max())
            + opt.lr * amp * rtol * float(g.abs().max()))


def _sharded_b7_row(cfg, world, dev):
    """B7 at the shape one rank hands it in [sharded]'s decode: device ms
    (CUDA-graph replays) against its plain version and
    ``scaled_dot_product_attention``, and the byte bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.decode_attn.ref import decode_attn_ref
    B, T, D = SHARDED_BATCH, SHARDED_CACHE, cfg.head_dim_
    H, KV = cfg.n_heads // world, max(1, cfg.n_kv_heads // world)
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(B, H, D, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, T, KV, D, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    cpos = torch.arange(T, dtype=torch.int32, device=dev)
    pos = T - 1
    saved = decode_attn.launches
    kern = lambda: decode_attn(q, k, v, cpos, pos)
    err = max_abs_err(kern().float(),
                      decode_attn_ref(q, k, v, cpos, pos).float())
    ms = graph_ms(kern, 20) or cuda_ms(kern, 50, 5)
    plain_fn = lambda: decode_attn_ref(q, k, v, cpos, pos)
    plain = graph_ms(plain_fn, 5) or cuda_ms(plain_fn, 5, 1)
    qs = q[:, :, None].contiguous()
    ks, vs = (t.transpose(1, 2) for t in (k, v))
    mask = ((cpos >= 0) & (cpos <= pos))[None, None, None, :]
    lib_fn = lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib = graph_ms(lib_fn, 20) or cuda_ms(lib_fn, 50, 5)
    decode_attn.launches = saved          # the comparison's launches
    nbytes = q.numel() * 2 * 2 + (k.numel() + v.numel()) * 2 + T * 4
    ops = 4 * B * H * T * D
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
    return dict(name="decode_attn@sharded", route="cuda",
                source=ATTN_SOURCE,
                replaces="src/repro/kernels/decode_attn/decode_attn.py:72",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=lib, shape=[B, H, KV, D, T])


def sharded_rank(rank, world, port):
    """One rank of [sharded] (``chip_smoke.py --sharded-rank``): qwen3-4b
    decode at full width and depth, then a 2-period ``seq_parallel`` train
    step, each over DTensors placed by ``launch.dryrun.place_inputs`` and
    run under ``activation_sharding``, against the unsharded step on the
    same card.  Prints one ``[sharded] rank r: {json}`` line."""
    import copy
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import SHAPES
    from repro_torch.kernels.decode_attn.ops import decode_attn
    from repro_torch.kernels.prefill_attn.ops import prefill_attn
    from repro_torch.launch.dryrun import place_inputs
    from repro_torch.launch.mesh import MeshDesc, device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import (build_serve_step,
                                           build_train_step,
                                           init_train_state, make_optimizer)
    from repro_torch.sharding.context import activation_sharding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(SHARDED_BACKEND,
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    full = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x
    out = {}
    try:
        dm = device_mesh(MeshDesc(("data", "model"), (1, world)), "cuda")
        # --- decode: full width and depth, the baseline (tp) config
        cfg = _arch_cfg(SERVE_ARCH)
        B, P = SHARDED_BATCH, SHARDED_PROMPT
        params = T.init_model(cfg, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(7)
        prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                               device=dev, dtype=torch.int32)
        toks = torch.randint(0, cfg.vocab_size, (SHARDED_STEPS, B, 1),
                             generator=g, device=dev, dtype=torch.int32)
        step = build_serve_step(cfg)
        shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=B,
                                    seq_len=SHARDED_CACHE)
        with torch.no_grad():
            _, caches = T.prefill(params, cfg, {"tokens": prompt},
                                  cache_len=SHARDED_CACHE)
            placed = place_inputs(cfg, shape, {
                "params": params, "caches": copy.deepcopy(caches),
                "tokens": toks[0], "pos": P}, dm)
            want, t_plain = [], []
            for i in range(SHARDED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, caches, ex = step(params, caches, toks[i], P + i)
                torch.cuda.synchronize()
                t_plain.append(time.perf_counter() - t0)
                want.append((lg.float(), {k: v.float() for k, v in
                                          ex.items()}))
            decode_attn.launches = 0
            err, t_shard = 0.0, []
            for i in range(SHARDED_STEPS):
                tok = place_inputs(cfg, shape, {"tokens": toks[i]},
                                   dm)["tokens"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with activation_sharding(dm):
                    lg2, _, ex2 = step(placed["params"], placed["caches"],
                                       tok, P + i)
                torch.cuda.synchronize()
                t_shard.append(time.perf_counter() - t0)
                w_lg, w_ex = want[i]
                scale = float(w_lg[torch.isfinite(w_lg)].abs().max())
                e = max_abs_err(full(lg2).float(), w_lg) / scale
                for k in w_ex:
                    e = max(e, max_abs_err(full(ex2[k]).float(), w_ex[k])
                            / scale)
                err = max(err, e)
            launches = decode_attn.launches
            cache_err = max(
                max_abs_err(full(a).float(), b.float())
                / max(float(b.float().abs().max()), 1e-30)
                for a, b in zip(tree_leaves(placed["caches"]),
                                tree_leaves(caches)))
        n_attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.pattern)
        check(launches == SHARDED_STEPS * n_attn,
              f"rank {rank}: B7 launched {launches} times in the sharded "
              f"decode, not {SHARDED_STEPS} x {n_attn}")
        check(err <= 2 ** -6, f"rank {rank}: sharded logits off by {err:.3g}"
              f" of max |logit| (bf16 tolerance 2^-6)")
        check(cache_err <= 2 ** -6, f"rank {rank}: caches off by "
              f"{cache_err:.3g}")
        out.update(decode=dict(
            layers=cfg.n_layers, err=err, cache_err=cache_err,
            launches=launches, plain_ms=[t * 1e3 for t in t_plain],
            sharded_ms=[t * 1e3 for t in t_shard]))
        row = _sharded_b7_row(cfg, dm.size(1), dev)
        del params, placed, caches, want
        torch.cuda.empty_cache()
        # --- train: full width, 2 periods, seq_parallel, bf16
        cfg_t = _arch_cfg(TRAIN_ARCH, SHARDED_TRAIN_PERIODS,
                          seq_parallel=True)
        Bt, St = SHARDED_TRAIN_B, SHARDED_TRAIN_S
        shape_t = dataclasses.replace(SHAPES["train_4k"], global_batch=Bt,
                                      seq_len=St)
        state = init_train_state(cfg_t, seed=0, device=dev)
        batch = {k: torch.randint(0, cfg_t.vocab_size, (Bt, St),
                                  generator=g, device=dev, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        placed = place_inputs(cfg_t, shape_t, {
            "state": copy.deepcopy(state), "batch": batch}, dm)
        tstep = build_train_step(cfg_t)
        _reset(_b11_counters() + _optim_counters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, m = tstep(state, batch)
        torch.cuda.synchronize()
        t_train_plain = time.perf_counter() - t0
        b11_plain = _b11_counters()[0].launches
        optim_plain = [c.launches for c in _optim_counters()]
        prefill_attn.launches = 0
        _reset(_b11_counters() + _optim_counters())
        t0 = time.perf_counter()
        with activation_sharding(dm):
            new2, m2 = tstep(placed["state"], placed["batch"])
        torch.cuda.synchronize()
        t_train_shard = time.perf_counter() - t0
        b8 = prefill_attn.launches
        b11 = _b11_counters()[0].launches
        optim = [c.launches for c in _optim_counters()]
        check(optim == optim_plain == [1, 1], f"rank {rank}: B12 / B13 "
              f"launched {optim} times in the sharded train step, "
              f"{optim_plain} unsharded")
        check(b8 > 0, f"rank {rank}: B8 not launched in the sharded train "
              f"step")
        check(b11 > 0 and b11 == b11_plain and all(
            c.launches for c in _b11_counters()), f"rank {rank}: B11 "
              f"launched {[c.launches for c in _b11_counters()]} times in "
              f"the sharded train step, {b11_plain} forwards unsharded")
        loss, loss2 = float(m["loss"]), float(full(m2["loss"]))
        gn, gn2 = float(m["grad_norm"]), float(full(m2["grad_norm"]))
        check(abs(loss2 - loss) <= SHARDED_RTOL * abs(loss),
              f"rank {rank}: sharded loss {loss2} vs {loss}")
        check(abs(gn2 - gn) <= SHARDED_RTOL * abs(gn),
              f"rank {rank}: sharded grad norm {gn2} vs {gn}")
        opt = make_optimizer(cfg_t)
        worst, n_leaves = 0.0, 0
        for (path, w), mu, got in zip(_paths_of(new["params"]),
                                      tree_leaves(new["opt"].mu),
                                      tree_leaves(new2["params"])):
            bound = _sharded_param_bound(w, mu, opt, SHARDED_RTOL)
            e = (full(got).double() - w.double()).abs()
            check(bool((e <= bound).all()), f"rank {rank}: {path} beyond "
                  f"the bound by {float((e - bound).max()):.3g}")
            worst = max(worst, float(e.max()))
            n_leaves += 1
        del state, new, w, mu, got
        torch.cuda.empty_cache()
        out.update(train=dict(
            layers=cfg_t.n_layers, loss=loss, loss_sharded=loss2,
            grad_norm=gn, grad_norm_sharded=gn2, worst_param_err=worst,
            leaves=n_leaves, plain_ms=t_train_plain * 1e3,
            sharded_ms=t_train_shard * 1e3, b8_launches=b8,
            b11_launches=b11, optim_launches=optim))
        out["b7"] = row
        print(f"[sharded] rank {rank}: {json.dumps(out)}", flush=True)
    finally:
        dist.destroy_process_group()


def _paths_of(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths_of(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def phase_sharded():
    """[sharded]: this script started once a rank of the (1,
    SHARDED_WORLD) mesh (``--sharded-rank r world port``); every rank must
    exit 0 and report its checks.  Returns B7's kernels-line row with the
    ranks' launches in the sharded decode, and B11's forward launches in
    the sharded train step (``b11_launches``)."""
    import socket
    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--sharded-rank", str(r), str(SHARDED_WORLD),
                               str(port)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(SHARDED_WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for r, (rc, out) in enumerate(outs):
        tail = "\n".join(out.splitlines()[-25:])
        check(rc == 0, f"[sharded] rank {r} exited {rc}:\n{tail}")
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"[sharded] rank {r}: ")]
        check(len(line) == 1, f"[sharded] rank {r} printed no result")
        res.append(json.loads(line[0].split(": ", 1)[1]))
    d, t, row = res[0]["decode"], res[0]["train"], res[0]["b7"]
    med = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]
    log("sharded", f"{SHARDED_WORLD} rank(s), {SHARDED_BACKEND}, mesh "
        f"(data, model) = (1, {SHARDED_WORLD}); decode qwen3-4b "
        f"{d['layers']} layers bf16, B = {SHARDED_BATCH}, cache "
        f"{SHARDED_CACHE}, {SHARDED_STEPS} steps after a {SHARDED_PROMPT}-"
        f"token prefill: logits and exits within {d['err']:.3g} of max "
        f"|logit| of the unsharded step, caches within {d['cache_err']:.3g};"
        f" ms a step (host wall, median of steps 2-{SHARDED_STEPS}) "
        f"unsharded {med(d['plain_ms']):.3f}, sharded "
        f"{med(d['sharded_ms']):.3f} (first {d['plain_ms'][0]:.3f} / "
        f"{d['sharded_ms'][0]:.3f}); B7 launches "
        f"{sum(x['decode']['launches'] for x in res)}")
    log("sharded", f"train qwen3-4b {t['layers']} layers, seq_parallel, "
        f"B = {SHARDED_TRAIN_B}, S = {SHARDED_TRAIN_S}, bf16: loss "
        f"{t['loss']:.6f} / {t['loss_sharded']:.6f}, grad norm "
        f"{t['grad_norm']:.6f} / {t['grad_norm_sharded']:.6f}, "
        f"{t['leaves']} parameters within the bound (largest |diff| "
        f"{t['worst_param_err']:.3g}); one step (host wall) unsharded "
        f"{t['plain_ms']:.3f} ms, sharded "
        f"{t['sharded_ms']:.3f} ms (its first); B8 launches on the ranks' "
        f"shards in the sharded step (counter reset before it) "
        f"{sum(x['train']['b8_launches'] for x in res)}; B11 forward "
        f"launches there (each K1 + combine, then K2 + K3; counters reset "
        f"before it) {sum(x['train']['b11_launches'] for x in res)}, "
        f"through local_map on each rank's shards (over a mesh dimension "
        f"of one the head is whole on every rank: no gather of K1's "
        f"partials); B12 / B13 launches there on the ranks' local shards "
        f"{sum(x['train']['optim_launches'][0] for x in res)} / "
        f"{sum(x['train']['optim_launches'][1] for x in res)} (B12's leaf "
        f"sums go over the mesh between the two halves of its finish)")
    log("sharded", f"B7 at a rank's shape {row.pop('shape')}: "
        f"{row['ms']:.4f} ms (CUDA graph), plain {row['plain_ms']:.4f}, "
        f"sdpa {row['library_ms']:.4f}, bound {row['bound_ms']:.6f} by "
        f"{row['bound_by']}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    row["launches"] = sum(x["decode"]["launches"] for x in res)
    row["b11_launches"] = sum(x["train"]["b11_launches"] for x in res)
    row["optim_launches"] = [sum(x["train"]["optim_launches"][i]
                                 for x in res) for i in range(2)]
    return row


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


def prefill_inputs(B, Sq, Sk, H, KV, D, mask, dtype, dev, seed):
    """Seeded B8 inputs: q / k / v and int32 positions.  mask "full": the
    queries at the last Sq key positions; "slots": a tenth of the key
    slots at -1; "lead": queries far past a short window, so the first key
    tiles are masked for every row; "dead": the keys start 40 positions
    past the first query (causal: the first rows have no live key);
    "empty": every key slot at -1 (every row dead)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                               device=dev).to(dtype)
               for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))
    k_pos = np.arange(Sk)
    q_pos = np.arange(Sk - Sq, Sk)
    if mask == "slots":
        k_pos[rng.choice(Sk, Sk // 10, replace=False)] = -1
    elif mask == "dead":
        k_pos = k_pos + 40
        q_pos = np.arange(Sq)
    elif mask == "empty":
        k_pos[:] = -1
    qp, kp = (torch.as_tensor(p, dtype=torch.int32, device=dev)
              for p in (q_pos, k_pos))
    return q, k, v, qp, kp


def ssd_inputs(B, S, H, P, N, dtype, dev, seed):
    """Seeded B9 inputs: x, B and C in ``dtype``, dt in [0.01, 0.5] and
    log a = -dt * U(0.01, 1) in float32, as the mixer gives them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    xh, Bm, Cm = (f(rng.normal(size=s)).to(dtype)
                  for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = f(rng.uniform(0.01, 0.5, (B, S, H)))
    a_log = -f(rng.uniform(0.01, 1.0, (B, S, H))) * dt
    return xh, Bm, Cm, dt, a_log


def ssd_within(y, st, y_p, st_p):
    """B9 against its plain version: y and the final state within 1e-4 of
    their largest |value| in float32 (the sums run in another order and
    the log decays are cumulated by a parallel scan; every decay is an
    exp of the same difference), bf16 y within 2^-7 of its largest |value|
    (each side rounds a float32 sum once, half a bf16 ulp = 2^-9 of a
    value, and the sums differ below that).  Returns (ok, y error, state
    error, the tolerance as text)."""
    import torch
    ty = (1e-4 if y.dtype == torch.float32 else 2.0 ** -7) * float(
        y_p.float().abs().max())
    ts = 1e-4 * float(st_p.abs().max())
    ey = float((y.float() - y_p.float()).abs().max())
    es = float((st - st_p).abs().max())
    return ey <= ty and es <= ts, ey, es, (
        f"y atol {'1e-4' if y.dtype == torch.float32 else '2^-7'} max|y| = "
        f"{ty:.3g}, state atol 1e-4 max|state| = {ts:.3g}")


def phase_kernels_prefill(dev):
    """[kernels_prefill]: B8 and B9 against their plain versions on the
    card, float32 and bf16, with the same bits on a repeat call.

    B8 at PREFILL_CHECK_CASES within ``attn_within``'s tolerance, B7's:
    float32 rtol = atol = 2e-5 (the kernel sums the scores and the online
    softmax in another order and in tiles of 32 keys, not chunks), bf16
    2^-6 of the largest |output| (two bf16 ulps of it: the kernel rounds
    the probabilities of a 64-key tile to bf16, the plain version those of
    a chunk, at other scales); a windowed case must fail the check with
    the window ignored, and a dead row must equal the plain version's sum
    of v over the padded chunk count.  B9 at SSD_CHECK_CASES within
    ``ssd_within``.  Returns each kernel's largest abs error."""
    import torch
    from repro_torch.kernels.prefill_attn.ops import prefill_attn
    from repro_torch.kernels.prefill_attn.ref import prefill_attn_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    err = {"prefill_attn": 0.0, "ssd_scan": 0.0}
    n8, n9 = prefill_attn.launches, ssd_scan.launches
    t_phase = time.perf_counter()
    for case in PREFILL_CHECK_CASES:
        B, Sq, Sk, H, KV, D, causal, window, mask, chunk = case
        kw = dict(causal=causal, window=window, chunk=chunk)
        for dtype in (torch.float32, torch.bfloat16):
            args = prefill_inputs(B, Sq, Sk, H, KV, D, mask, dtype, dev,
                                  Sq + Sk + H + D)
            got = prefill_attn(*args, **kw)
            again = prefill_attn(*args, **kw)
            want = prefill_attn_ref(*args, **kw)
            torch.cuda.synchronize()
            e = max_abs_err(got.float(), want.float())
            ok, tol = attn_within(got, want)
            tag = (f"B8 (B, Sq, Sk, H, KV, D) {(B, Sq, Sk, H, KV, D)} "
                   f"{dtype} causal={causal} window={window} mask={mask} "
                   f"chunk={chunk}")
            check(got.dtype == dtype and ok, f"{tag}: off by {e:.3g} ({tol})")
            check(torch.equal(got, again), f"{tag}: a repeat call gave "
                  f"other bits")
            notes = []
            if window and Sk > window:
                blind = prefill_attn_ref(*args, causal=causal, window=0,
                                         chunk=chunk)
                check(not attn_within(blind, want)[0], f"{tag}: the check "
                      f"passes an output that ignores the window")
                notes.append("an output that ignores the window fails it")
            if mask in ("dead", "empty"):
                n_pad = -(-Sk // chunk) * chunk
                dead = args[2].float().sum(1)[:, None] / n_pad  # [B,1,KV,D]
                G = H // KV
                d = dead.repeat_interleave(G, dim=2)[:, 0]
                e0 = max_abs_err(got[:, 0].float(), d)
                check(e0 <= 2.0 ** -6 * float(d.abs().max()) + 1e-6,
                      f"{tag}: a dead row is not sum(v) / {n_pad} "
                      f"(off by {e0:.3g})")
                notes.append(f"dead rows = sum(v) / {n_pad} within {e0:.3g}")
            err["prefill_attn"] = max(err["prefill_attn"], e)
            log("kernels_prefill", f"{tag}: max_abs_err {e:.3g} within "
                f"{tol}; a repeat call gives the same bits"
                + "".join(f"; {n}" for n in notes))
            del args, got, again, want
    for B, S, H, P, N, chunk in SSD_CHECK_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(B, S, H, P, N, dtype, dev, S + H + P + N)
            y, st = ssd_scan(*args, chunk=chunk)
            y2, st2 = ssd_scan(*args, chunk=chunk)
            y_p, st_p = ssd_scan_ref(*args, chunk=chunk)
            torch.cuda.synchronize()
            ok, ey, es, tol = ssd_within(y, st, y_p, st_p)
            tag = (f"B9 (B, S, H, P, N) {(B, S, H, P, N)} chunk {chunk} "
                   f"(Q = {min(chunk, S)}, {-(-S // min(chunk, S))} chunks, "
                   f"last {S - (-(-S // min(chunk, S)) - 1) * min(chunk, S)}"
                   f" rows) x {dtype}")
            check(y.dtype == dtype and ok, f"{tag}: y off by {ey:.3g}, state"
                  f" by {es:.3g} ({tol})")
            check(torch.equal(y, y2) and torch.equal(st, st2),
                  f"{tag}: a repeat call gave other bits")
            err["ssd_scan"] = max(err["ssd_scan"], ey, es)
            log("kernels_prefill", f"{tag}: y max_abs_err {ey:.3g}, state "
                f"{es:.3g}, within {tol}; a repeat call gives the same bits")
            del args, y, st, y2, st2, y_p, st_p
    # the comparisons' launches are not a path's
    prefill_attn.launches, ssd_scan.launches = n8, n9
    torch.cuda.empty_cache()
    log("kernels_prefill", f"the phase took {time.perf_counter() - t_phase:.1f}"
        f" s")
    return err


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


def _moe_layers(cfg):
    return cfg.n_periods * sum(s.mlp == "moe" for s in cfg.pattern)


def phase_serve(dev, counters):
    """The serving path: qwen3-4b at full width in bf16 through the engine,
    16 requests, then a churn trace with a failure and a recovery."""
    return _serve_path("serve", _serve_cfg(), dev, counters)


def _serve_path(tag, cfg, dev, counters, probe=64):
    """``cfg`` at its widths in bf16 through ``SplitServeEngine``:
    ``SERVE_REQUESTS`` requests of ``SERVE_NEW`` tokens at B =
    ``SERVE_BATCH``, then a churn trace with a failure and a recovery;
    launches, ms/step and the step's byte bound, then a profiled window."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as TT
    from repro_torch.runtime.serve_engine import serve_with_churn
    from repro_torch.runtime.steps import params_shapes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TT.init_model(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = TT.param_count(params)
    n_leaves = _same_tree(_tree_specs(params), params_shapes(cfg),
                          f"{tag}: params_shapes")
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = _serve_engine(cfg, params, dev, thresholds)
    t_build = time.perf_counter() - t0
    n_cache = _same_tree(_tree_specs(eng.caches), TT.cache_shape_dtypes(
        cfg, SERVE_BATCH, SERVE_CACHE), f"{tag}: cache_shape_dtypes")
    log(tag, f"params_shapes == the drawn parameters ({n_leaves} leaves) "
        f"and cache_shape_dtypes == the engine's caches ({n_cache} "
        f"leaves), in path, shape and dtype")
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
    check(launches["moe_ffn"] == _moe_layers(cfg) * st.steps,
          f"{tag}: B10 launched {launches['moe_ffn']} times in {st.steps} "
          f"steps, not {_moe_layers(cfg)} a step")
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
    log(tag, _analytic_line(cfg, SERVE_BATCH, SERVE_CACHE, "decode",
                            ms_step, n_params))
    log(tag, f"churn: {len(reports)} ticks, victim node {victim}, "
        f"reports {reports}; {wall_churn:.3f} s with {st.steps - steps_run} "
        f"more steps")
    log(tag, f"kernel launches on the path {launches} over {st.steps} "
        f"steps: B6 {launches['ee_gate'] / st.steps:.0f}, B7 "
        f"{launches['decode_attn'] / st.steps:.0f} and B10 "
        f"{launches['moe_ffn'] / st.steps:.0f} per step, B1 "
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
                                       n_params=n_params, **prof)


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
    check(launches["ssm_decode"] > 0 and launches["ssm_decode"]
          % cfg.n_layers == 0, f"serve_ssm: B14 launched "
          f"{launches['ssm_decode']} times, not once an SSM layer a step")
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1, SSM_PROMPT + 1)), device=dev)
    _reset(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = TT.prefill(params, cfg, {"tokens": toks[:, :SSM_PROMPT]},
                                cache_len=SSM_PROMPT + 1)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre = {c.__name__: c.launches for c in counters}
    hi_pre = torch.cuda.max_memory_allocated()
    check(pre["ssd_scan"] == cfg.n_layers, f"serve_ssm: B9 launched "
          f"{pre['ssd_scan']} times in a prefill of {cfg.n_layers} SSM "
          f"layers")
    check(tuple(logits.shape) == (1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "serve_ssm: prefill logits not finite or of the wrong shape")
    check(all(bool(torch.isfinite(c["state"]).all())
              for c in caches.values()), "serve_ssm: a prefill state is "
          "not finite")
    lg, caches, _ = TT.decode_step(params, cfg, toks[:, SSM_PROMPT:],
                                   caches, SSM_PROMPT)
    check(bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()),
          "serve_ssm: the decode step after prefill is not finite")
    log("serve_ssm", f"prefill of {SSM_PROMPT} tokens (B = 1, bf16): "
        f"{t_pre:.3f} s wall (host clock, ending in synchronize), "
        f"{SSM_PROMPT / t_pre:.1f} tokens/s, device memory high-water "
        f"{hi_pre} B; launches in the prefill (counters reset before it) "
        f"{pre}; one decode step after it finite")
    log("serve_ssm", "prefill: " + _analytic_line(
        cfg, 1, SSM_PROMPT, "prefill", t_pre * 1e3, out["n_params"]))
    out.update(prefill_s=t_pre, prefill_launches=pre)
    del params, caches
    torch.cuda.empty_cache()
    return launches, out


def phase_serve_moe(dev, counters):
    """mixtral-8x22b at full width cut to MOE_PERIODS periods, in bf16:
    the engine run of [serve]; then a MOE_PROMPT-token prompt through
    ``prefill`` with cache_len 4,096 (the ring slots wrap past the window)
    and MOE_DECODE decode steps at B = 1 (B7 windowed over 4,096 slots),
    B10 once an MoE layer throughout; then [kernels_moe] and B10's
    timings on layer 0's weights, and B8 at the prefill's shape."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as TT
    cfg = _arch_cfg(MOE_ARCH, MOE_PERIODS)
    params, cfg, launches, out = _serve_path("serve_moe", cfg, dev, counters)
    log("serve_moe", f"depth cut: {MOE_PERIODS} of {MOE_ARCH}'s 56 periods")
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (1, MOE_PROMPT + MOE_DECODE)), device=dev)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = TT.prefill(params, cfg,
                                {"tokens": toks[:, :MOE_PROMPT]},
                                cache_len=cfg.sliding_window)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    pre = {c.__name__: c.launches for c in counters}
    hi_pre = torch.cuda.max_memory_allocated()
    check(pre["prefill_attn"] == _attn_layers(cfg), f"serve_moe: B8 "
          f"launched {pre['prefill_attn']} times in a prefill of "
          f"{_attn_layers(cfg)} attention layers")
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
    log("serve_moe", f"prefill of {MOE_PROMPT} tokens (B = 1, cache_len "
        f"{T}): {t_pre:.3f} s wall (host clock, ending in synchronize), "
        f"{MOE_PROMPT / t_pre:.1f} tokens/s, device memory high-water "
        f"{hi_pre} B; ring slots hold positions {MOE_PROMPT - T}.."
        f"{MOE_PROMPT - 1}; launches in the prefill (counters reset "
        f"before it) {pre}")
    log("serve_moe", "prefill: " + _analytic_line(
        cfg, 1, MOE_PROMPT, "prefill", t_pre * 1e3, out["n_params"]))
    log("serve_moe", f"{MOE_DECODE} decode steps after it at B = 1 "
        f"(B7 over {T} slots, window {cfg.sliding_window}): ms/step "
        f"{[round(w * 1e3, 3) for w in walls]}; launches "
        f"{dec_launches}")
    # the counters run on from the prefill through the decode steps
    n_moe = _moe_layers(cfg)
    dec_b10 = dec_launches["moe_ffn"] - pre["moe_ffn"]
    check(pre["moe_ffn"] == n_moe, f"serve_moe: B10 launched "
          f"{pre['moe_ffn']} times in a prefill of {n_moe} MoE layers")
    check(dec_b10 == n_moe * MOE_DECODE, f"serve_moe: B10 launched "
          f"{dec_b10} times in {MOE_DECODE} decode steps of {n_moe} MoE "
          f"layers")
    log("serve_moe", f"B10 launch counts (calls; each is two launches): "
        f"engine run {launches['moe_ffn']} ({n_moe} a step), prefill "
        f"{pre['moe_ffn']}, {MOE_DECODE} decode steps after it {dec_b10}")
    decode_calls = launches["moe_ffn"] + dec_b10
    for k, v in dec_launches.items():
        launches[k] += v
    out.update(prefill_s=t_pre, decode_ms=walls, prefill_launches=pre)
    del caches
    torch.cuda.empty_cache()
    layer0 = TT._period(params["layers"], 0)["l0"]["mlp"]
    out["b10_err"] = phase_kernels_moe(dev, layer0, cfg)
    out["b10_rows"] = moe_ffn_times(layer0, cfg, dev,
                                    (decode_calls, pre["moe_ffn"]))
    out["b8_row"] = attn_program_times(cfg, dev, pre["prefill_attn"])
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
    from repro_torch.kernels.moe_ffn.ops import moe_ffn
    from repro_torch.kernels.prefill_attn.ops import prefill_attn
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.models import transformer as TT
    out = {}
    kernels = (prefill_attn, ssd_scan, moe_ffn)
    _reset(kernels)
    for arch, periods, B, S in PREFILL_CASES:
        cfg = _arch_cfg(arch, periods, dtype="float32")
        if cfg.n_experts:                  # no capacity drops
            cfg = dataclasses.replace(cfg, capacity_factor=16.0)
        torch.cuda.reset_peak_memory_stats()
        params = TT.init_model(cfg, seed=2, device=dev)
        toks = torch.as_tensor(np.random.default_rng(S).integers(
            0, cfg.vocab_size, (B, S)), device=dev)
        # B8 / B9 / B10 launches of this case's forward_train and prefill
        mark = lambda: tuple(c.launches for c in kernels)
        marks = [mark()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = TT.forward_train(params, cfg, {"tokens": toks})["final"][
            :, -1]
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        marks.append(mark())
        t0 = time.perf_counter()
        _, caches = TT.prefill(params, cfg, {"tokens": toks[:, :S - 1]},
                               cache_len=S + 4)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        marks.append(mark())
        lg, _, _ = TT.decode_step(params, cfg, toks[:, S - 1:], caches,
                                  S - 1)
        case_launches = [" / ".join(str(b - a) for a, b in zip(m0, m1))
                         for m0, m1 in zip(marks, marks[1:])]
        err = _rel_last(full, lg)
        check(err < 1e-4, f"prefill {arch}: decode after prefill differs "
              f"from forward_train by {err:.3g} relative (>= 1e-4)")
        wraps = cfg.sliding_window and S - 1 > cfg.sliding_window
        log("prefill", f"{arch} ({cfg.n_layers} layers, f32, B = {B}, S = "
            f"{S}{', capacity_factor 16' if cfg.n_experts else ''}"
            f"{', prompt past the window: ring slots wrap' if wraps else ''})"
            f": decode after prefill within {err:.3g} relative of "
            f"forward_train; walls (host clock, ending in synchronize) "
            f"forward_train {t_fwd:.3f} s, prefill {t_pre:.3f} s; B8 / B9 "
            f"/ B10 launches: forward_train {case_launches[0]}, prefill "
            f"{case_launches[1]}; device memory high-water "
            f"{torch.cuda.max_memory_allocated()} B")
        out[arch] = dict(err=err, forward_s=t_fwd, prefill_s=t_pre)
        del params, caches, full, lg
        torch.cuda.empty_cache()
    launched = {c.__name__: c.launches for c in kernels}
    check(all(launched.values()), f"prefill: B8 / B9 / B10 launches "
          f"{launched} over the teacher-forcing cases")
    log("prefill", f"kernel launches over the three cases (counters reset "
        f"before them) {launched}")
    out["launches"] = launched
    # encode: hubert-xlarge at full width and depth, bf16
    cfg = _arch_cfg("hubert-xlarge")
    params = TT.init_model(cfg, seed=3, device=dev)
    B, S = ENCODE_FRAMES
    g = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randn(B, S, cfg.d_model, generator=g, device=dev).to(
        params["final_norm"]["scale"].dtype)
    TT.encode(params, cfg, {"frames": frames})
    torch.cuda.synchronize()
    _reset(kernels)
    t0 = time.perf_counter()
    logits = TT.encode(params, cfg, {"frames": frames})
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    enc = {c.__name__: c.launches for c in kernels}
    check(enc["prefill_attn"] == _attn_layers(cfg), f"prefill: B8 launched "
          f"{enc['prefill_attn']} times in an encode of {_attn_layers(cfg)} "
          f"attention layers")
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
          and bool(torch.isinf(logits[..., cfg.vocab_size:]).all()),
          "prefill: hubert-xlarge encode logits not finite or of the wrong "
          "shape")
    log("prefill", f"hubert-xlarge encode ({cfg.n_layers} layers, {cfg.dtype}, "
        f"frames {(B, S, cfg.d_model)}, {TT.param_count(params)} "
        f"parameters): logits {tuple(logits.shape)} finite (tail -inf), "
        f"{t_enc * 1e3:.3f} ms wall (second call; host clock, ending in "
        f"synchronize), {B * S / t_enc:.1f} frames/s; kernel launches "
        f"(counters reset before the timed call) {enc}")
    out["encode_ms"] = t_enc * 1e3
    out["encode_launches"] = enc
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
    from repro_torch.kernels.moe_ffn.ops import moe_ffn
    from repro_torch.models import transformer as TT
    for arch, periods in ((SSM_ARCH, 2), (MOE_ARCH, 1)):
        cfg = _arch_cfg(arch, periods, dtype="float32", exit_layers=())
        _reset((moe_ffn,))
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
        # forward_train, prefill and 4 decode steps, once an MoE layer each
        n_b10 = 6 * _moe_layers(cfg)
        check(moe_ffn.launches == n_b10, f"serve_parity {arch}: B10 "
              f"launched {moe_ffn.launches} times, not {n_b10}")
        log("serve_parity", f"{arch} widths at {cfg.n_layers} layers, f32 "
            f"({TT.param_count(params)} parameters, copied to the host in "
            f"{t_copy:.3f} s): forward_train, prefill (logits and caches) "
            f"and 4 decode steps on CUDA within rtol = atol = 1e-4 of the "
            f"CPU path (B10 calls {moe_ffn.launches}); max abs err "
            + ", ".join(
                f"{k} {v:.3g}" for k, v in worst.items()))
        del params, cpu, fw, pre, step
        torch.cuda.empty_cache()


def _program_row(tag, ms, calls, nbytes, ops, peak, lib,
                 what="plain PyTorch"):
    """Log one program of the path (an XLA program in the reference, not a
    Pallas kernel; ``what`` runs it) against its bound."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / peak
    bound = max(t_b, t_o) * 1e3
    by = "bytes" if t_b >= t_o else "operations"
    log("programs", f"{tag}: device ms a call {ms:.4f} ({what}), "
        f"calls on the path {calls}, bound {bound:.6f} ms by {by} "
        f"({nbytes} B, {ops} ops at {peak / 1e12:.0f} TFLOP/s), "
        f"{bound / ms:.1%} of the bound; library "
        + ("none" if lib is None else f"{lib:.4f} ms"))
    return dict(ms=ms, calls=calls, bound_ms=bound, bound_by=by,
                library_ms=lib)


def _program_ms(fn, reps=3):
    return graph_ms(fn, reps) or cuda_ms(fn, reps, 1)


def moe_inputs(G, t, E, Ck, d, ff, live, dtype, dev, seed):
    """Seeded inputs of B10 as the top-C selection gives them: each
    (group, expert) row of slots holds distinct tokens, its live slots
    first (top_w > 0, descending), dead ones with top_w 0; "mixed" leaves
    expert 0 without a token, NaN in its weights, and expert E - 1 full."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    top_idx = np.stack([np.stack([rng.permutation(t)[:Ck] for _ in range(E)])
                        for _ in range(G)])
    counts = rng.integers(0, Ck + 1, size=(G, E))
    if live == "all":
        counts[:] = Ck
    else:
        counts[:, 0] = 0
        counts[:, -1] = Ck
    top_w = -np.sort(-rng.uniform(0.05, 1.0, (G, E, Ck)), axis=-1)
    top_w[np.arange(Ck)[None, None, :] >= counts[..., None]] = 0.0
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    xg = f(rng.normal(size=(G, t, d))).to(dtype)
    w = [(f(rng.normal(size=sh)) / sh[1] ** 0.5).to(dtype)
         for sh in ((E, d, ff), (E, d, ff), (E, ff, d))]
    if live == "mixed":
        for a in w:
            a[0] = float("nan")
    tw = f(top_w)
    return (xg, torch.as_tensor(top_idx, dtype=torch.int64, device=dev),
            tw > 0, tw, *w)


def moe_stage(p, cfg, x):
    """B10's inputs at a layer's routing of x [G, t, d]: xg, top_idx,
    valid, top_w and the experts' weights, as ``_moe_gather`` gives them."""
    from repro_torch.models import moe as M
    top_idx, valid, top_w = M._slots(p, cfg, x)
    return (x, top_idx.contiguous(), valid.contiguous(), top_w.contiguous(),
            p["w_gate"], p["w_up"], p["w_down"])


def moe_within(got, want, dtype):
    """B10 against its plain version: float32 inputs within 1e-5 of the
    largest |ye| (float32 sums in another order), bf16 within 2^-6 of it
    (h rounded to bf16 after sums in another order than cuBLAS's may land
    one ulp apart); (ok, error, tolerance)."""
    e = max_abs_err(got, want)
    tol = (1e-5 if dtype == "float32" else 2.0 ** -6) * float(
        want.abs().max())
    return e <= tol, e, tol


def phase_kernels_moe(dev, p, cfg):
    """[kernels_moe]: B10 against its plain version on the card, bf16 and
    float32, with the same bits on a repeat call and exact zeros at every
    dead slot: at mixtral's widths with [serve_moe]'s layer-0 weights
    (MOE_REAL_SHAPES, routed by the layer's router; float32 on a float32
    copy of the weights), and at MOE_CHECK_CASES, where a dead expert's
    NaN weights (which the plain version turns into NaN) must come out as
    exact zeros.  Returns the largest abs error."""
    import gc
    import torch
    from repro_torch.kernels.moe_ffn.ops import moe_ffn, moe_ffn_plan
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref
    t_phase = time.perf_counter()
    saved = moe_ffn.launches
    worst = 0.0
    g = torch.Generator(device=dev).manual_seed(14)
    xs = {(G, t): torch.randn(G, t, cfg.d_model, generator=g, device=dev)
          for G, t in MOE_REAL_SHAPES}
    for dtype in ("bfloat16", "float32"):
        td = getattr(torch, dtype)
        pw = p if dtype == "bfloat16" else {k: v.float() for k, v in
                                            p.items()}
        for (G, t), x in xs.items():
            args = moe_stage(pw, cfg, x.to(td))
            got = moe_ffn(*args)
            again = moe_ffn(*args)
            want = moe_ffn_ref(*args)
            torch.cuda.synchronize()
            ok, e, tol = moe_within(got, want, dtype)
            valid = args[2]
            plan = moe_ffn_plan(G, cfg.n_experts, args[1].shape[-1],
                                cfg.d_model, cfg.d_ff, td)
            tag = (f"B10 mixtral widths (G, t) {(G, t)} {dtype} ({plan.regime}"
                   f", experts used {int(valid.any(0).any(-1).sum())} of "
                   f"{cfg.n_experts}, {int(valid.sum())} live slots of "
                   f"{valid.numel()})")
            check(ok, f"{tag}: off by {e:.3g} ({tol:.3g})")
            check(torch.equal(got, again), f"{tag}: a repeat call gave other "
                  f"bits")
            check(not bool(got[~valid].any()), f"{tag}: a dead slot is not "
                  f"zero")
            worst = max(worst, e)
            log("kernels_moe", f"{tag}: max_abs_err {e:.3g} within "
                f"{tol:.3g}; same bits again; dead slots exact zeros")
            del args, got, again, want
        del pw
        gc.collect()
        torch.cuda.empty_cache()
    for case in MOE_CHECK_CASES:
        G, t, E, Ck, d, ff, live = case
        for dtype in ("float32", "bfloat16"):
            args = moe_inputs(*case, getattr(torch, dtype), dev, sum(case[:6]))
            got = moe_ffn(*args)
            again = moe_ffn(*args)
            want = moe_ffn_ref(*args)
            torch.cuda.synchronize()
            tag = (f"B10 (G, t, E, Ck, d, ff) {case[:6]} {live} {dtype} "
                   f"({moe_ffn_plan(G, E, Ck, d, ff, args[0].dtype).regime})")
            if live == "mixed":
                check(bool(torch.isnan(want[:, 0]).all())
                      and bool((got[:, 0] == 0).all()), f"{tag}: the dead "
                      f"expert's NaN weights were read")
                got, again, want = got[:, 1:], again[:, 1:], want[:, 1:]
            ok, e, tol = moe_within(got, want, dtype)
            check(ok, f"{tag}: off by {e:.3g} ({tol:.3g})")
            check(torch.equal(got, again), f"{tag}: a repeat call gave other "
                  f"bits")
            check(not bool(got[~args[2][:, 1:] if live == "mixed"
                               else ~args[2]].any()),
                  f"{tag}: a dead slot is not zero")
            worst = max(worst, e)
            log("kernels_moe", f"{tag}: max_abs_err {e:.3g} within {tol:.3g}"
                f"; same bits again; dead slots exact zeros"
                + ("; the dead expert (NaN weights) exact zeros"
                   if live == "mixed" else ""))
    moe_ffn.launches = saved               # the comparisons' launches
    log("kernels_moe", f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return worst


def moe_ffn_times(p, cfg, dev, launches):
    """B10 at [serve_moe]'s shapes with layer-0 weights (bf16): the
    engine's decode step (4 groups of one token) and the prefill (one group
    of MOE_PROMPT tokens).  Device ms a call (CUDA-graph replays) beside
    its plain version (the reference's gather, three products and
    weighting), the library (the plain version's three cuBLAS
    ``bmm(out_dtype=float32)`` products alone, on its [E, G * Ck, .]
    operands, the down product on the h those inputs give) and the bound:
    bytes the live experts' weights, xg, the routing and ye once;
    operations each live slot's SwiGLU, 6 d ff (989 TFLOP/s).  The card
    runs the prefill's products at its power limit, where the clock
    follows the heat and the data (a product of zeros draws less), so the
    kernel and the library are timed in turns (kernel, library, library,
    kernel) and averaged; the library with its down product on h = 0 is
    logged beside it.  The whole ``_moe_gather`` (routing and scatter-add
    too) is logged as well.  ``launches``: (decode calls, prefill calls) on
    the path.  Returns the two kernels-line rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.moe_ffn.ops import moe_ffn, moe_ffn_plan
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref
    from repro_torch.models import moe as M
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    g = torch.Generator(device=dev).manual_seed(8)
    saved = moe_ffn.launches
    rows = []
    for (G, t), calls in zip(((SERVE_BATCH, 1), (1, MOE_PROMPT)), launches):
        x = torch.randn(G, t, d, generator=g, device=dev).to(torch.bfloat16)
        args = moe_stage(p, cfg, x)
        _, top_idx, valid, _, wg, wu, wd = args
        Ck = top_idx.shape[-1]
        used = int(valid.any(0).any(-1).sum())
        kept = int(valid.sum())
        reps = 10 if t == 1 else 3
        kern = lambda: moe_ffn(*args)
        xe = x[torch.arange(G, device=dev)[:, None, None], top_idx]
        xe = xe.transpose(0, 1).reshape(E, G * Ck, d).contiguous()
        h = (F.silu(torch.bmm(xe, wg, out_dtype=torch.float32))
             * torch.bmm(xe, wu, out_dtype=torch.float32)).to(x.dtype)
        lib_of = lambda hh: lambda: (
            torch.bmm(xe, wg, out_dtype=torch.float32),
            torch.bmm(xe, wu, out_dtype=torch.float32),
            torch.bmm(hh, wd, out_dtype=torch.float32))
        lib_fn = lib_of(h)
        turns = {"kernel": [], "library": []}
        for who in ("kernel", "library", "library", "kernel"):
            fn = kern if who == "kernel" else lib_fn
            turns[who].append(graph_ms(fn, reps) or cuda_ms(fn, 5, 1))
        ms = sum(turns["kernel"]) / 2
        lib = sum(turns["library"]) / 2
        lib_h0 = _program_ms(lib_of(torch.zeros_like(h)))
        plain = _program_ms(lambda: moe_ffn_ref(*args))
        whole = _program_ms(lambda: M._moe_gather(p, cfg, x))
        log("programs", f"B10 at {(G, t)}: device time a call by kernel "
            f"(torch.profiler, 5 calls): {launch_split(kern)}; in turns: "
            f"kernel {turns['kernel'][0]:.4f} / {turns['kernel'][1]:.4f} "
            f"ms, library {turns['library'][0]:.4f} / "
            f"{turns['library'][1]:.4f} ms (with h = 0: {lib_h0:.4f} ms)")
        nbytes = (used * 3 * d * ff * 2 + G * t * d * 2
                  + G * E * Ck * (8 + 1 + 4) + G * E * Ck * d * 4)
        ops = kept * 6 * d * ff
        plan = moe_ffn_plan(G, E, Ck, d, ff, x.dtype)
        prog = _program_row(
            f"B10 moe_ffn bf16 xg {(G, t, d)} ({plan.regime}; experts used "
            f"{used} of {E}, {kept} live slots of {G * E * Ck}; plain "
            f"{plain:.4f} ms; the whole _moe_gather {whole:.4f} ms)", ms,
            calls, nbytes, ops, 989e12, lib, "kernel B10")
        rows.append(_kernel_row("moe_ffn", MOE_SOURCE,
                                "src/repro/models/moe.py:63", plain, prog))
        del args, xe, h
    moe_ffn.launches = saved               # the timings' launches
    torch.cuda.empty_cache()
    return rows


def _kernel_row(name, source, replaces, plain, prog):
    """The kernels-line row of a kernel that ``_program_row`` logged as
    ``prog`` (max_abs_err filled in by main from the checks)."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=prog["calls"], max_abs_err=None, ms=prog["ms"],
                plain_ms=plain, bound_ms=prog["bound_ms"],
                bound_by=prog["bound_by"], library_ms=prog["library_ms"])


def launch_split(fn, reps=5) -> str:
    """The device time of ``fn`` a call by kernel, from torch.profiler's
    device events over ``reps`` calls, as text ("not measured" where the
    profiler records none)."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as tp:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in tp.key_averages()
                     if e.device_type != DeviceType.CPU
                     and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    if not events:
        return "not measured (no device events)"
    def name(key):   # "void (anonymous namespace)::f<T>(...)" -> "f"
        key = key.replace("(anonymous namespace)::", "")
        return key.split("(")[0].split("<")[0].split()[-1]
    return ", ".join(f"{name(e.key)} "
                     f"{e.self_device_time_total / 1e3 / reps:.4f} ms"
                     for e in events)


def b8_times(dev, cfg, B, S, launches, tag):
    """B8 at ``cfg``'s heads over B sequences of S tokens at positions
    0..S-1 (its mask and window; bf16): device ms a call (CUDA-graph
    replays) beside its plain version (the reference's chunked loop) and
    scaled_dot_product_attention with the same boolean mask (none where
    every pair is live).  Operations: 4 H D for each live (query, key)
    pair; bytes q, k, v, out and the positions once.  Returns the
    kernels-line row with ``launches``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.prefill_attn.ops import prefill_attn
    from repro_torch.kernels.prefill_attn.ref import prefill_attn_ref
    H, KV, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, \
        cfg.sliding_window
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=g, device=dev).to(torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    kw = dict(causal=cfg.causal, window=W, chunk=cfg.attn_chunk)
    saved = prefill_attn.launches
    kern = lambda: prefill_attn(q, k, v, pos, pos, **kw)
    plain_fn = lambda: prefill_attn_ref(q, k, v, pos, pos, **kw)
    ms = graph_ms(kern, 10) or cuda_ms(kern, 10, 2)
    plain = _program_ms(plain_fn, 2)
    mask = torch.ones((S, S), dtype=torch.bool, device=dev)
    if cfg.causal:
        mask &= pos[None, :] <= pos[:, None]
    if W > 0:
        mask &= pos[None, :] > pos[:, None] - W
    live = int(mask.sum()) * B
    lib_fn = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=None if live == B * S * S else mask, enable_gqa=True)
    got = kern()
    e_lib = max_abs_err(lib_fn().transpose(1, 2).float(), got.float())
    ok, tol = attn_within(got, plain_fn())
    check(ok and e_lib <= 2e-2, f"B8 at {tag}: off its plain version "
          f"({tol}) or scaled_dot_product_attention by {e_lib:.3g}")
    lib = _program_ms(lib_fn, 2)
    log("programs", f"B8 at {tag}: device time a call by kernel "
        f"(torch.profiler, 5 calls): {launch_split(kern)}")
    prefill_attn.launches = saved          # the timings' launches
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + 2 * S * 4
    ops = 4 * H * D * live
    prog = _program_row(
        f"B8 prefill_attn at {tag}: bf16 q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} causal {cfg.causal} window {W} ({live} live "
        f"pairs; plain {plain:.4f} ms; library within {e_lib:.3g})", ms,
        launches, nbytes, ops, 989e12, lib, "kernel B8")
    return _kernel_row("prefill_attn", PREFILL_SOURCE,
                       "src/repro/models/attention.py:73", plain, prog)


def attn_program_times(cfg, dev, launches):
    """B8 at [serve_moe]'s prefill shape (B = 1, MOE_PROMPT tokens,
    mixtral's heads, window 4,096); the kernels-line row."""
    return b8_times(dev, cfg, 1, MOE_PROMPT, launches, "[serve_moe]'s prefill")


def attn_encode_times(dev, launches):
    """B8 at hubert-xlarge's encode shape (ENCODE_FRAMES, 16 heads of 80,
    bidirectional), logged."""
    b8_times(dev, _arch_cfg("hubert-xlarge"), *ENCODE_FRAMES, launches,
             "hubert's encode")


def ssd_program_times(dev, launches):
    """B9 at [serve_ssm]'s prefill shape (B = 1, SSM_PROMPT tokens, 64
    heads of 64, N = 128, chunk 256; xh, B and C in bf16 as the conv gives
    them, dt and log a in float32): device ms a call (CUDA-graph replays)
    beside its plain version.  Operations: the causal half of each
    chunk's dual form, the inter-chunk product and the chunk states, on
    the real rows; bytes the inputs, y and the state once.  Returns B9's
    kernels-line row with ``launches``, the prefill's."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
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
    saved = ssd_scan.launches
    kern = lambda: ssd_scan(xh, Bm, Cm, dt, a_log, chunk=cfg.ssm_chunk)
    plain_fn = lambda: ssd_scan_ref(xh, Bm, Cm, dt, a_log,
                                    chunk=cfg.ssm_chunk)
    ms = graph_ms(kern, 10) or cuda_ms(kern, 10, 2)
    plain = _program_ms(plain_fn)
    ok, ey, es, tol = ssd_within(*kern(), *plain_fn())
    check(ok, f"B9 at the prefill shape: y off by {ey:.3g}, state by "
          f"{es:.3g} ({tol})")
    log("programs", f"B9 at [serve_ssm]'s prefill: device time a call by "
        f"kernel (torch.profiler, 5 calls): {launch_split(kern)}")
    ssd_scan.launches = saved              # the timings' launches
    Q = min(cfg.ssm_chunk, S)
    ops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        pairs = q * (q + 1) // 2
        ops += B * (2 * N * pairs + 2 * H * pairs + 2 * H * P * pairs
                    + 4 * q * N * H * P)
    nbytes = (2 * (2 * xh.numel() + Bm.numel() + Cm.numel())
              + 4 * (dt.numel() + a_log.numel() + B * H * P * N))
    prog = _program_row(
        f"B9 ssd_scan bf16 xh {tuple(xh.shape)} N {N} chunk "
        f"{cfg.ssm_chunk} (plain {plain:.4f} ms; y within {ey:.3g}, state "
        f"within {es:.3g})", ms, launches, nbytes, ops, 67e12, None,
        "kernel B9")
    return _kernel_row("ssd_scan", SSD_SOURCE, "src/repro/models/ssm.py:87",
                       plain, prog)


def ssm_decode_inputs(cfg, B, dev, seed, gate=False):
    """Seeded arguments of one B14 call at ``cfg``'s widths and B rows, in
    bf16 with a float32 state; with ``gate`` every z is 64, so the output
    is exactly 64 y."""
    import numpy as np
    import torch
    from repro_torch.models.ssm import ssm_dims
    di, H, P, N = ssm_dims(cfg)
    w, C = cfg.ssm_conv_width, di + 2 * N
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    zxbcdt = torch.randn(B, 1, 2 * di + 2 * N + H, generator=g, device=dev)
    zxbcdt[..., -H:] = torch.rand(B, 1, H, generator=g, device=dev) * 12 - 6
    if gate:
        zxbcdt[..., :di] = 64.0
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa
    return (zxbcdt.to(bf), torch.randn(B, w - 1, C, generator=g,
                                       device=dev).to(bf),
            torch.randn(B, H, P, N, generator=g, device=dev),
            (torch.randn(w, C, generator=g, device=dev) / w ** 0.5).to(bf),
            (torch.randn(C, generator=g, device=dev) * 0.1).to(bf),
            f(rng.uniform(-1.0, 1.0, H)), f(rng.uniform(0.5, 1.5, H)),
            f(rng.uniform(-1.0, 1.0, H)))


def ssm_decode_call_bytes(cfg, B):
    """Bytes of one B14 call, each input read once and each output written
    once: per row the float32 state and the conv tail read and written, z,
    the conv inputs and dt read, the gated y written; per call the conv
    weights and bias (bf16) and the three per-head vectors (float32)."""
    from repro_torch.models.ssm import ssm_dims
    di, H, P, N = ssm_dims(cfg)
    w, C = cfg.ssm_conv_width, di + 2 * N
    row = 2 * H * P * N * 4 + 2 * (w - 1) * C * 2 + (di + C + H) * 2 + di * 2
    return B * row + (w * C + C) * 2 + 3 * H * 4


def ssm_decode_times(dev, launches=None):
    """B14 at [serve_ssm]'s decode shape (mamba2-1.3b, 256 rows) and at
    jamba's heads (SSM_DECODE_SHAPES), bf16, beside its plain version:
    the state and the conv cache bit-equal, y (over a gate of exactly 64)
    within one bf16 ulp of its largest |value|; device ms a call by
    CUDA-graph replay against the byte bound, the plain version's, and the
    split by launch (torch.profiler).  Returns the kernels-line row of the
    mamba2 shape, its launches ``launches`` (the engine run's)."""
    import torch
    from repro_torch.kernels.ssm_decode.ops import ssm_decode
    from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
    saved = ssm_decode.launches
    rows, worst = [], 0.0
    for arch, B in SSM_DECODE_SHAPES:
        cfg = _arch_cfg(arch)
        args = ssm_decode_inputs(cfg, B, dev, 14, gate=True)
        got, want = [t.clone() for t in args], [t.clone() for t in args]
        out, out_p = ssm_decode(*got), ssm_decode_ref(*want)
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int32)  # noqa: E731
        check(torch.equal(bits(got[2]), bits(want[2])),
              f"B14 at {arch} x {B}: the state differs from the plain "
              f"version's in {int((got[2] != want[2]).sum())} elements")
        check(torch.equal(got[1].view(torch.int16), want[1].view(torch.int16)),
              f"B14 at {arch} x {B}: the conv cache differs from the plain "
              f"version's")
        y, y_p = out.float() / 64.0, out_p.float() / 64.0
        top = float(y_p.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        err = float((y - y_p).abs().max())
        off = int((y != y_p).sum())
        check(err <= ulp, f"B14 at {arch} x {B}: y off by {err:.3g}, more "
              f"than one bf16 ulp ({ulp:.3g}) of its largest |value|")
        worst = max(worst, err)
        del got, want, out, out_p
        args = ssm_decode_inputs(cfg, B, dev, 15)
        kern = lambda: ssm_decode(*args)  # noqa: E731
        plain = [t.clone() for t in args]
        plain_fn = lambda: ssm_decode_ref(*plain)  # noqa: E731
        ms = graph_ms(kern, 10) or cuda_ms(kern, 10, 2)
        plain_ms = _program_ms(plain_fn)
        nbytes = ssm_decode_call_bytes(cfg, B)
        split = launch_split(kern)
        log("programs", f"B14 at {arch} x {B} rows: state and conv cache "
            f"bit-equal to the plain version, y within {err:.3g} (one bf16 "
            f"ulp {ulp:.3g}; {off} of {y.numel()} elements off by one); by "
            f"launch (torch.profiler, 5 calls): {split}")
        ops = 5 * B * args[2][0].numel()
        rows.append(_program_row(
            f"B14 ssm_decode bf16 {arch} B {B} state {tuple(args[2].shape)} "
            f"(plain {plain_ms:.4f} ms)", ms, launches, nbytes, ops, 67e12,
            None, "kernel B14") | {"plain": plain_ms})
        del args, plain
        torch.cuda.empty_cache()
    ssm_decode.launches = saved              # the timings' launches
    row = _kernel_row("ssm_decode", SSM_DECODE_SOURCE,
                      "src/repro/models/ssm.py:197", rows[0]["plain"],
                      rows[0])
    row["max_abs_err"] = worst
    return row


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
        optim = _optim_counters()
        _reset(optim)
        losses, walls = _branchy_train_steps(net, x, y, BRANCHY_TRAIN_STEPS,
                                             1e-3)
        peak = torch.cuda.max_memory_allocated()
        b13 = optim[1].launches
        check(b13 == BRANCHY_TRAIN_STEPS and optim[0].launches == 0,
              f"[branchy_train] B12 / B13 launched {optim[0].launches} / "
              f"{b13} times in {BRANCHY_TRAIN_STEPS} steps")
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
            f"max_memory_allocated {peak} B; B13 launches {b13} (one a "
            f"step over the {sum(1 for _ in net.parameters())} leaves; no "
            f"clip here: no B12)")
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
    """Parameters of the tree ``init_model`` builds for ``cfg``, counted on
    its meta twin ``params_shapes`` (nothing allocated).  This counts the
    real tree: ``launch.flops.param_count`` is the reference's formula,
    which leaves out the q / k norms (2 head_dim a layer) and the SSM conv
    bias (d_inner + 2N a layer), so for qwen3-4b it gives 4,066,045,440
    against this 4,066,051,200.  [train]'s bound stays on this count."""
    from repro_torch.models import transformer as TT
    from repro_torch.runtime.steps import params_shapes
    return TT.param_count(params_shapes(cfg))


def _tree_specs(tree, prefix=()):
    """{path: (shape, dtype, device type)} of a tree of dicts and
    NamedTuples of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_specs(v, prefix + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_tree_specs(getattr(tree, k), prefix + (k,)))
        return out
    return {"/".join(prefix): (tuple(tree.shape), tree.dtype,
                               tree.device.type)}


def _same_tree(a, meta, what):
    """The meta tree of a shapes function (``params_shapes``,
    ``cache_shape_dtypes``, ``train_state_shapes``) equals the tree built
    on the card (``a``, its ``_tree_specs``) leaf for leaf, in path, shape
    and dtype; the number of leaves."""
    b = _tree_specs(meta)
    check(sorted(a) == sorted(b), f"{what}: paths differ: "
          f"{sorted(set(a) ^ set(b))[:6]}")
    for path, (shape, dtype, device) in a.items():
        check(b[path][:2] == (shape, dtype), f"{what}: {path} is "
              f"{shape} {dtype} on the card, {b[path][:2]} on meta")
        check(b[path][2] == "meta" and device == "cuda",
              f"{what}: {path} on {device} / {b[path][2]}")
    return len(a)


def _analytic_line(cfg, B, S, kind, ms, tree_params):
    """The port's analytic cost and roofline (``launch.analytic`` +
    ``launch.roofline.analyze`` with the H100 table) of one ``kind`` step
    of ``cfg`` at (B, S) on one card, beside the measured ``ms``, with
    ``model_flops`` and both parameter counts.  Printed, never held
    against the hand bounds: the two methods count different things."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.analytic import analytic_cost
    from repro_torch.launch.flops import param_count
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.roofline import analyze, model_flops
    shape = ShapeSpec(f"{kind}_{B}x{S}", S, B, kind)
    acost = analytic_cost(cfg, shape, 1, {})
    rl = analyze(cfg.name, shape.name, "1card", 1, {}, None, "",
                 model_flops(cfg, shape), HW, analytic=acost)
    bound = max(rl.t_compute, rl.t_memory) * 1e3
    return (f"analytic roofline of one {kind} step at B = {B}, S = {S} on "
            f"one card (launch.analytic, H100 989 TFLOP/s, 3.35 TB/s): "
            f"{rl.flops_per_chip:.6g} FLOP, {rl.bytes_per_chip:.6g} B, "
            f"t_compute {rl.t_compute * 1e3:.4f} ms, t_memory "
            f"{rl.t_memory * 1e3:.4f} ms, bottleneck {rl.bottleneck}; "
            f"model_flops {rl.model_flops_total:.6g} (MODEL/analytic "
            f"{rl.useful_flops_ratio:.3f}); measured {ms:.3f} ms = "
            f"{ms / bound:.2f}x the analytic bound; parameters: "
            f"launch.flops.param_count {param_count(cfg)}, the built tree "
            f"{tree_params}")


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
    from repro_torch.runtime import train_loop
    from repro_torch.runtime.steps import train_state_shapes
    from repro_torch.runtime.train_loop import train
    gc.collect()
    torch.cuda.empty_cache()
    restore = _tf32_on()
    built, last = {}, {}
    make_state = train_loop.init_train_state
    make_step = train_loop.build_train_step
    b11 = _b11_counters()
    optim = _optim_counters()

    def recorded(cfg_, **kw):          # the state train() builds, as shapes
        state = make_state(cfg_, **kw)
        built["state"] = _tree_specs(state)
        return state

    def kept(cfg_):                    # the last step's state, for the split
        fn = make_step(cfg_)

        def step(state, batch):
            new, metrics = fn(state, batch)
            last.update(step=fn, state=new, batch=batch)
            return new, metrics
        return step

    train_loop.init_train_state = recorded
    train_loop.build_train_step = kept
    try:
        for periods in (None, 24, 12):
            cfg = _arch_cfg(TRAIN_ARCH, periods, remat="full")
            last.clear()
            _reset(b11 + optim)
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
        train_loop.init_train_state = make_state
        train_loop.build_train_step = make_step
        restore()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {c.__name__: c.launches for c in b11}
    ce_calls = 1 + len(cfg.exit_layer_list)
    check(all(launches.values()), f"[train] B11 launches {launches}")
    log("train", f"B11 launches over the {TRAIN_STEPS} steps (counters reset "
        f"before them): {launches}; {ce_calls} loss calls a step (the final "
        f"head and {ce_calls - 1} exits sharing it), each K1 + combine, then "
        f"K2 and K3 for dh and dW a backward pass")
    check(launches["linear_ce_forward"] == ce_calls * TRAIN_STEPS,
          f"[train] B11 forward launched {launches['linear_ce_forward']} "
          f"times, not {ce_calls} a step")
    optim_launches = tuple(c.launches for c in optim)
    check(optim_launches == (TRAIN_STEPS, TRAIN_STEPS), f"[train] B12 / B13 "
          f"launched {optim_launches} times in {TRAIN_STEPS} steps, not once "
          f"a step each")
    log("train", f"B12 / B13 launches over the {TRAIN_STEPS} steps "
        f"(counters reset before them): {optim_launches[0]} / "
        f"{optim_launches[1]}, one each a step over the whole tree")
    restore = _tf32_on()
    try:
        split = profile_train_step(last["step"], last["state"],
                                   last["batch"], launches)
        optim_rows = optim_program_times(last["state"], dev, optim_launches)
    finally:
        restore()
        last.clear()
    n_state = _same_tree(built["state"], train_state_shapes(cfg),
                         "[train] train_state_shapes")
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
    log("train", f"train_state_shapes == the state train() built "
        f"({n_state} leaves: parameters, AdamW moments, step), in path, "
        f"shape and dtype")
    log("train", _analytic_line(cfg, TRAIN_BATCH, TRAIN_SEQ, "train", ms, N))
    return dict(ms=ms, bound_ms=bound, tokens_s=tokens / (ms * 1e-3),
                peak=peak, ce_calls=ce_calls,
                b11_launches=launches["linear_ce_forward"], split=split,
                optim_rows=optim_rows)


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
    from repro_torch.kernels.moe_ffn.ops import moe_ffn
    from repro_torch.kernels.prefill_attn.ops import prefill_attn
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.models import transformer as TT
    from repro_torch.runtime import steps as S
    from repro_torch.runtime.train_loop import batch_to, train
    restore = _tf32_on()
    kernels = (prefill_attn, ssd_scan, moe_ffn) + _b11_counters() + \
        _optim_counters()
    _reset(kernels)
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
        launched = {c.__name__: c.launches for c in kernels}
        check(all(launched.values()), f"[train_parity] B8 / B9 / B10 / B11 "
              f"/ B12 / B13 launches {launched}")
        n_steps = 3 * len(TRAIN_PARITY)
        check(launched["global_norm_scale"] == launched["adamw_update"]
              == n_steps, f"[train_parity] B12 / B13 launches "
              f"{launched}, not once a CUDA step")
        log("train_parity", f"kernel launches over the three models' "
            f"loss_fn and 3 steps each (counters reset before them): "
            f"{launched}; B8's / B9's / B10's backward is the plain "
            f"versions', B11's its own kernels (float32: the CUDA-core "
            f"tiles, with the global TF32 flags on); B12 and B13 once a "
            f"step on CUDA (the CPU path's steps run their plain versions "
            f"and count none)")
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
    return launched


def _b11_counters():
    from repro_torch.kernels.linear_ce import ops as LO
    return (LO.linear_ce_forward, LO.linear_ce_dlogits, LO.linear_ce_gemm)


def ce_inputs(case, N, d, V, vocab, tied, dtype, dev, seed):
    """Seeded h [N, d], head [d, V] (a table's transpose if tied) and
    labels [N] int64 of a B11 case: a label in the last live column at
    row 0, -1 at 30% of the rows ("unlabelled") or at all ("all_...")."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((N, d), generator=gen, device=dev).to(dtype)
    w = (torch.randn((d, V), generator=gen, device=dev)
         * (3 / d ** 0.5)).to(dtype)
    if tied:
        w = w.T.contiguous().T
    labels = rng.integers(0, vocab, N)
    if case == "unlabelled":
        labels[rng.uniform(size=N) < 0.3] = -1
    if case == "all_unlabelled":
        labels[:] = -1
    labels[0] = -1 if case == "all_unlabelled" else vocab - 1
    return h, w, torch.as_tensor(labels, dtype=torch.int64, device=dev)


def ce_shards(h, w, labels, vocab, ranks, g, dl_bytes):
    """B11 on a head split over ``ranks`` equal column shards, the ranks
    one after another on this card, as ``layers._linear_ce_local`` runs
    them: each rank's K1 partials (a first pass collects them: the gather),
    the combine of all of them (every rank's lse and stats must be the
    same bits), each rank's K2 and K3 on its columns with the combined lse
    -> (stats, loss, lse, dh summed over the ranks in float32, dW [d, V]).
    A rank's untied shard is a dense copy of its columns, as a rank holds
    it; the tied table's rows are dense as they lie."""
    import torch
    from repro_torch.kernels.linear_ce import ops as LO
    width = w.shape[1] // ranks
    cols = [(r * width, w[:, r * width:(r + 1) * width])
            for r in range(ranks)]
    cols = [(c, x if LO._stored(x) else x.contiguous()) for c, x in cols]
    parts = []
    for col0, wr in cols:
        LO.linear_ce_forward(h, wr, labels, vocab, LO.plan_for(h, wr, 0),
                             col0=col0, gather=lambda p: parts.append(p) or p)
    every = lambda p: torch.cat(parts, dim=1)
    fwd = [LO.linear_ce_forward(h, wr, labels, vocab, LO.plan_for(h, wr, 0),
                                col0=col0, gather=every)
           for col0, wr in cols]
    check(all(torch.equal(a, b) for f in fwd[1:] for a, b in
              zip(f, fwd[0])), "[kernels_ce] the ranks' combines differ")
    stats, loss, lse = fwd[0]
    scale = g / torch.clamp(stats[1], min=1.0)
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dws = []
    for col0, wr in cols:
        dhr, dwr = LO._backward(h, wr, labels, lse, scale, vocab,
                                LO.plan_for(h, wr, dl_bytes), True, True,
                                col0)
        dh += dhr.float()
        dws.append(dwr)
    return stats, loss, lse, dh, torch.cat(dws, dim=1)


def phase_kernels_ce(dev):
    """[kernels_ce]: B11 (K1 + combine, then K2 and K3 for dh and dW, a pass
    of rows at a time) against its plain version (``linear_ce/ref.py``) on
    the card at CE_CHECK_CASES in float32 and bf16, at CE_WIDE_CASES and,
    on a vocab-sharded head (``ce_shards``), at CE_SHARD_CASES:
    the loss within a relative 1e-5 (float32) / 1e-4 (bf16), lse within
    the same of max|lse|, dh and dW within 1e-5 / 2^-6 of max|plain|, dW
    exactly 0 on the padded columns, a loss and gradients of exactly 0
    when every label is -1, and the same bits on a repeat (a sharded
    head: dh, the sum of the ranks' rounded shares, within 2^-6 too).  The
    launches here are the checks', not a path's: the counters are put
    back.  Returns the largest abs error at [train]'s shape (loss, lse, dh,
    dW)."""
    import gc
    import torch
    from repro_torch.kernels.linear_ce import ops as LO
    from repro_torch.kernels.linear_ce.ref import (linear_ce_bwd_ref,
                                                   linear_ce_fwd_ref)
    counters = _b11_counters()
    saved = [c.launches for c in counters]
    cases = [(c, dt, None) for c in CE_CHECK_CASES
             for dt in ("float32", "bfloat16")] + [
        (c, dt, None) for c, dt in CE_WIDE_CASES] + [
        ((case, N, d, V, vocab, tied, -1.5, None), dtype, ranks)
        for case, N, d, V, vocab, tied, ranks, dtype in CE_SHARD_CASES]
    train_err = None
    t0 = time.perf_counter()
    for (case, N, d, V, vocab, tied, g, rows), dtype, ranks in cases:
        dt = getattr(torch, dtype)
        h, w, labels = ce_inputs(case, N, d, V, vocab, tied, dt, dev, N + V)
        if ranks:
            # a label in every rank's first column
            labels[1:ranks + 1] = torch.arange(ranks, device=dev) * (
                V // ranks)
            labels.clamp_(max=vocab - 1)
        plan = LO.plan_for(h, w, (rows or N) * V * dt.itemsize)
        gt = torch.full((), g, device=dev)
        runs = []
        for _ in range(2):
            if ranks:
                runs.append(ce_shards(h, w, labels, vocab, ranks, gt,
                                      N * V * dt.itemsize))
                continue
            stats, loss, lse = LO.linear_ce_forward(h, w, labels, vocab, plan)
            scale = gt / torch.clamp(stats[1], min=1.0)
            dh, dw = LO._backward(h, w, labels, lse, scale, vocab, plan,
                                  True, True)
            runs.append((stats, loss, lse, dh, dw))
        torch.cuda.synchronize()
        what = f"[kernels_ce] {case} {dtype} N={N} d={d} V={V}"
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"{what}: a repeat differs")
        stats, loss, lse, dh, dw = runs[1]
        del runs
        tot, cnt, lse_p = linear_ce_fwd_ref(h, w, labels, vocab)
        dh_p, dw_p = linear_ce_bwd_ref(h, w, labels, lse_p,
                                       gt / torch.clamp(cnt, min=1.0), vocab)
        check((dh.dtype == dt or ranks) and dw.dtype == dt and
              dh.shape == h.shape and dw.shape == w.shape,
              f"{what}: gradient dtype or shape")
        check(float(stats[1]) == float(cnt), f"{what}: count")
        check(not bool(dw[:, vocab:].any()), f"{what}: dW not 0 on the "
              f"padded columns")
        want = float(tot) / max(float(cnt), 1.0)
        errs = (abs(float(loss) - want),
                float((lse - lse_p).abs().max()),
                float((dh.float() - dh_p.float()).abs().max()),
                float((dw.float() - dw_p.float()).abs().max()))
        if case == "all_unlabelled":
            check(float(loss) == 0.0 and not bool(dh.any())
                  and not bool(dw.any()), f"{what}: not all zeros")
        else:
            rel = 1e-5 if dtype == "float32" else 1e-4
            tol = 1e-5 if dtype == "float32" else 2.0 ** -6
            check(errs[0] <= rel * abs(want), f"{what}: loss {float(loss)} "
                  f"vs {want}")
            check(errs[1] <= rel * float(lse_p.abs().max()),
                  f"{what}: lse off by {errs[1]:.3g}")
            for e, ref, name in ((errs[2], dh_p, "dh"), (errs[3], dw_p, "dW")):
                lim = tol * float(ref.float().abs().max())
                check(e <= lim, f"{what}: {name} off by {e:.3g} (> {lim:.3g})")
        if case == "train":
            train_err = max(errs)
        log("kernels_ce", f"{case} {dtype} N={N} d={d} V_pad={V} "
            f"vocab={vocab} {'tied' if tied else 'untied'} g={g}"
            f"{f' over {ranks} vocab shards' if ranks else ''}: "
            f"{-(-N // plan.pass_rows)} pass(es) of {plan.pass_rows} rows, "
            f"{plan.n_split} vocab splits, dh split {plan.dh_split}; loss "
            f"{float(loss):.7g} vs plain {want:.7g}; abs errors loss "
            f"{errs[0]:.3g}, lse {errs[1]:.3g}, dh {errs[2]:.3g} (max|dh| "
            f"{float(dh_p.float().abs().max()):.3g}), dW {errs[3]:.3g} "
            f"(max|dW| {float(dw_p.float().abs().max()):.3g}); repeat "
            f"bit-identical")
        del h, w, labels, dh, dw, dh_p, dw_p, lse_p
        gc.collect()
        torch.cuda.empty_cache()
    for c, n in zip(counters, saved):
        c.launches = n
    log("kernels_ce", f"{len(cases)} cases in {time.perf_counter() - t0:.1f} "
        f"s")
    return train_err


def _b11_kind(name):
    """B11's kernel behind a device event's name (K1, combine, K2, K3 dh,
    K3 dW), or None."""
    name = name.replace("(anonymous namespace)::", "")
    if "lce_" not in name:
        return None
    if "combine" in name:
        return "combine"
    mode = name.split("kernel<", 1)[1][:8] if "kernel<" in name else ""
    return {"0": "K1", "1": "K2"}.get(mode[:1]) or (
        "K3 dW" if mode.startswith("2, true") else
        "K3 dh" if mode.startswith("2, false") else "K3")


def b11_split(fn, reps=3):
    """Device ms a call of each of B11's kernels in ``fn`` (torch.profiler
    over ``reps`` calls, each between device syncs in a range of its own),
    with, from the same calls, "other" (every other device kernel and copy
    of the call: the autograd scalars, the split sum's zeroed arrivals),
    "busy" (all of them) and "span" (the first kernel's start to the last
    one's end), or None where the profiler records none."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as tp:
        for _ in range(reps):
            with torch.profiler.record_function("b11_call"):
                fn()
                torch.cuda.synchronize()
    events = tp.events()
    calls = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "b11_call" and e.device_type == DeviceType.CPU)
    ms, ends = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU or e.name == "b11_call":
            continue
        at = next((i for i, (a, b) in enumerate(calls)
                   if a <= e.time_range.start <= b), None)
        if at is None:
            continue
        kind = _b11_kind(e.name) or "other"
        t = e.time_range.elapsed_us() / 1e3
        ms[kind] = ms.get(kind, 0.0) + t
        ms["busy"] = ms.get("busy", 0.0) + t
        lo, hi = ends.get(at, (e.time_range.start, e.time_range.end))
        ends[at] = (min(lo, e.time_range.start), max(hi, e.time_range.end))
    if not any(k not in ("other", "busy") for k in ms):
        return None
    ms["span"] = sum(b - a for a, b in ends.values()) / 1e3
    return {k: v / reps for k, v in sorted(ms.items())}


#: kernel families of the [train] split, by device kernel name
_FAMILIES = (("B11", ("lce_",)), ("B8", ("prefill_attn", "tile_map")),
             ("products", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
             ("copies", ("Memcpy", "Memset")))


def profile_train_step(step, state, batch, launches_before):
    """One [train] step after the timed ones under torch.profiler, split by
    range (the forward + backward, the gradient clip: B12's call, AdamW's
    update: B13's call; each wrapped in a record_function range between
    device syncs, so a device event belongs to the range its start falls
    in) and, inside the forward + backward, by kernel family (products,
    B8, B11, copies, the rest).  Logs device ms a step by family, B11's
    share, and the launches of B11 (K1 kernels), B12 (its chunk pass) and
    B13 the profiler saw against the counters'."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.kernels.adamw import ops as AO
    from repro_torch.kernels.linear_ce import ops as LO
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as S
    names = ("forward+backward", "clip", "AdamW")
    where = ((S, "value_and_grad"), (adamw, "global_norm_scale"),
             (adamw, "adamw_update"))
    orig = tuple(getattr(m, n) for m, n in where)

    def ranged(name, fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            with torch.profiler.record_function(f"train_split:{name}"):
                out = fn(*a, **k)
                torch.cuda.synchronize()
            return out
        return inner

    for (m, n), name, f in zip(where, names, orig):
        setattr(m, n, ranged(name, f))
    n0 = LO.linear_ce_forward.launches
    n_opt = (AO.global_norm_scale.launches, AO.adamw_update.launches)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as tp:
            _, m = step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for (m, n), f in zip(where, orig):
            setattr(m, n, f)
    counted = LO.linear_ce_forward.launches - n0
    opt_counted = (AO.global_norm_scale.launches - n_opt[0],
                   AO.adamw_update.launches - n_opt[1])
    events = tp.events()
    spans = {e.name.split(":", 1)[1]: (e.time_range.start, e.time_range.end)
             for e in events if e.name.startswith("train_split:")
             and e.device_type == DeviceType.CPU}
    dev_ev = [e for e in events if e.device_type != DeviceType.CPU
              and not e.name.startswith("train_split:")]
    if not dev_ev or len(spans) != 3:
        log("train", f"split of one step: not measured (torch.profiler saw "
            f"{len(dev_ev)} device events, ranges {sorted(spans)}); B11 "
            f"launches by the counter {counted}")
        return None
    ms = {k: 0.0 for k in ("B11", "B8", "products", "copies", "rest",
                           "clip", "AdamW", "outside")}
    b11 = {}
    k1_seen = 0
    opt_seen = {"clip": 0, "AdamW": 0}
    for e in dev_ev:
        t = e.time_range.elapsed_us() / 1e3
        at = next((n for n, (a, b) in spans.items() if a <= e.time_range.start
                   <= b), "outside")
        if at in ("clip", "AdamW", "outside"):
            ms[at] += t
            if at in opt_seen and ("norm_partials_kernel" in e.name
                                   or "adamw_kernel" in e.name):
                opt_seen[at] += 1
            continue
        fam = next((f for f, keys in _FAMILIES
                    if any(k in e.name for k in keys)), "rest")
        ms[fam] += t
        if fam == "B11":
            kind = _b11_kind(e.name)
            b11[kind] = b11.get(kind, 0.0) + t
            k1_seen += kind == "K1"
    total = sum(ms.values())
    log("train", f"split of one step after the timed ones (torch.profiler, "
        f"device syncs at the range boundaries; wall {wall:.3f} ms): device "
        f"ms " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + f"; total {total:.4f}; B11 {ms['B11']:.4f} ms = "
        f"{ms['B11'] / total:.1%} of the device time (by kernel: "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(b11.items()))
        + f"); B11 forward launches the profiler saw {k1_seen}, the "
        f"counter's {counted}"
        + ("" if k1_seen == counted else " (the profiler dropped events)")
        + f"; the clip range is B12's call, the AdamW range B13's: B12 / "
        f"B13 launches the profiler saw {opt_seen['clip']} / "
        f"{opt_seen['AdamW']}, the counters' {opt_counted[0]} / "
        f"{opt_counted[1]}")
    check(opt_counted == (1, 1), f"[train] the profiled step launched B12 / "
          f"B13 {opt_counted} times")
    return dict(ms=ms, total=total, wall=wall, b11=b11, seen=k1_seen,
                counted=counted)


def b11_kernels_alone(h, w, labels, vocab):
    """Device ms of each of B11's kernels at a call's shapes, each alone by
    graph replay through its wrapper (K1 without the combine through its C
    entry point), for a process where torch.profiler records nothing."""
    import torch
    from repro_torch.kernels._build import launch
    from repro_torch.kernels.linear_ce import ops as LO
    N, d = h.shape
    V = w.shape[1]
    plan = LO.plan_for(h, w, N * V * h.element_size())
    stats, loss, lse = LO.linear_ce_forward(h, w, labels, vocab, plan)
    scale = (1.0 / torch.clamp(stats[1], min=1.0)).reshape(())
    part = torch.empty((3, plan.n_split, N), dtype=torch.float32,
                       device=h.device)
    dl = torch.empty((N, V), dtype=h.dtype, device=h.device)
    LO.linear_ce_dlogits(h, w, labels, lse, scale, vocab, out=dl)
    dh, dw = torch.empty_like(h), torch.empty_like(w)
    k1 = lambda: launch("linear_ce_fwd_bf16", h.device, h.data_ptr(),
                        w.data_ptr(), labels.data_ptr(), part.data_ptr(),
                        None, stats.data_ptr(), loss.data_ptr(), N, d, V,
                        vocab, 0, 1, plan.n_split)
    combine = lambda: launch("linear_ce_combine", h.device, part.data_ptr(),
                             labels.data_ptr(), lse.data_ptr(),
                             stats.data_ptr(), loss.data_ptr(), N,
                             plan.n_split)
    fns = {"K1": k1, "combine": combine,
           "K2": lambda: LO.linear_ce_dlogits(h, w, labels, lse, scale,
                                              vocab, out=dl),
           "K3 dh": lambda: LO.linear_ce_gemm(dl, w.t(), out=dh,
                                              split=plan.dh_split),
           "K3 dW": lambda: LO.linear_ce_gemm(h.t(), dl, out=dw)}
    return {k: graph_ms(f, 3) or cuda_ms(f, 3, 1) for k, f in fns.items()}


def ce_program_times(dev, calls):
    """B11 (``chunked_cross_entropy`` on CUDA: forward plus backward) at
    [train]'s shape (qwen3-4b: B = 4, S = 512, d = 2,560, V_pad = 153,600,
    bf16 hiddens and head, chunk 256): device ms a call by CUDA-graph
    replay and by CUDA events, by kernel (torch.profiler; where it records
    nothing, each kernel alone by graph replay), against the
    bound of its 6 B S d V FLOP at 989 TFLOP/s (forward 2, backward 4; K2's
    recompute of the logits is the implementation's) and of its bytes; the
    plain version (``linear_ce/ref.py``, float32 logits), the parent's
    chunked program (``layers._chunked_cross_entropy`` on the same CUDA
    tensors) and the library route (two calls: cuBLAS ``mm(out_dtype=
    float32)`` over all rows, then ``F.cross_entropy``, forward and
    backward) beside it, and each call's max_memory_allocated.  Returns the
    kernels-line row (``calls``: B11's calls on [train])."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.linear_ce.ref import (linear_ce_bwd_ref,
                                                   linear_ce_fwd_ref)
    from repro_torch.models import layers as L
    counters = _b11_counters()
    saved = [c.launches for c in counters]
    cfg = _arch_cfg(TRAIN_ARCH)
    B, Sq, d, V = TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, cfg.padded_vocab
    vocab = cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((B, Sq, d), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    w = (torch.randn((d, V), generator=gen, device=dev) / d ** 0.5).to(
        torch.bfloat16).requires_grad_(True)
    labels = torch.as_tensor(np.random.default_rng(0).integers(
        0, vocab, (B, Sq)), device=dev)

    def fwd_bwd(fn=L.chunked_cross_entropy):
        loss = fn(h, w, labels, vocab)
        return torch.autograd.grad(loss, (h, w))

    h2, lab2 = h.detach().reshape(B * Sq, d), labels.reshape(-1)

    def plain():
        tot, cnt, lse = linear_ce_fwd_ref(h2, w.detach(), lab2, vocab)
        return linear_ce_bwd_ref(h2, w.detach(), lab2, lse,
                                 1.0 / torch.clamp(cnt, min=1.0), vocab)

    def library():
        logits = L._MatmulF32.apply(h.reshape(B * Sq, d), w, False)
        loss = F.cross_entropy(logits[:, :vocab], labels.reshape(-1),
                               ignore_index=-1)
        return torch.autograd.grad(loss, (h, w))

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    ms_graph = graph_ms(fwd_bwd, 3)
    ms_events = cuda_ms(fwd_bwd, 5, 2)
    kinds = b11_split(fwd_bwd)
    how = "torch.profiler, the calls of the split above"
    if kinds is None:
        # torch.profiler drops events in a long process: each kernel alone
        kinds = b11_kernels_alone(h2, w.detach(), lab2, vocab)
        how = ("each kernel alone by graph replay: torch.profiler saw no "
               "device events")
    split = f"{how}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                   kinds.items())
    # each product of the call (K1, K2, K3 dh, K3 dW: 2 B S d V FLOP)
    # against its bound at 989 TFLOP/s
    prod = 2 * B * Sq * d * V
    for k in ("K1", "K2", "K3 dh", "K3 dW"):
        log("programs", f"B11 {k} at [train]'s call: {kinds[k]:.4f} ms "
            f"({how}), bound {prod / 989e12 * 1e3:.4f} ms, "
            f"{prod / kinds[k] / 1e9:.1f} TFLOP/s, "
            f"{prod / 989e12 * 1e3 / kinds[k]:.1%} of the bf16 peak")
    ms = ms_graph if ms_graph is not None else ms_events
    plain_ms = _program_ms(plain)
    chunked = lambda: fwd_bwd(L._chunked_cross_entropy)
    chunked_ms = _program_ms(chunked)
    lib_ms = _program_ms(library)
    mem = {k: peak(f) for k, f in (("B11", fwd_bwd), ("chunked", chunked),
                                   ("library", library), ("plain", plain))}
    for c, n in zip(counters, saved):
        c.launches = n
    nbytes = 2 * (h.numel() + w.numel()) * 2 + labels.numel() * 8
    row = _program_row(
        f"B11 linear_ce bf16 [B S, d, V_pad] = {[B * Sq, d, V]} (forward + "
        f"backward; CUDA events {ms_events:.4f} ms, graph "
        + ("not measured" if ms_graph is None else f"{ms_graph:.4f} ms")
        + f"; by kernel: {split}; plain version {plain_ms:.4f} ms, the "
        f"parent's chunked program {chunked_ms:.4f} ms, library route "
        f"(two calls: mm(out_dtype=float32) + F.cross_entropy) "
        f"{lib_ms:.4f} ms)", ms, calls, nbytes, 6 * B * Sq * d * V, 989e12,
        None, "kernel B11")
    log("programs", f"B11 at [B, S, d, V_pad] = {[B, Sq, d, V]}: "
        f"max_memory_allocated above the inputs a call: "
        + ", ".join(f"{k} {v} B" for k, v in mem.items())
        + f" (the full float32 logits would be {B * Sq * V * 4} B)")
    return _kernel_row("linear_ce", CE_SOURCE,
                       "src/repro/models/layers.py:131", plain_ms, row)


# ---------------------------------------------------------------------------
# The optimizer programs: B12 and B13
# ---------------------------------------------------------------------------

def _optim_counters():
    from repro_torch.kernels.adamw import ops as AO
    return (AO.global_norm_scale, AO.adamw_update)


def _optim_leaves(dts, offsets, dev, seed):
    """{p, g, m, v: [leaf]} at ADAMW_CHECK_SHAPES, seeded, in dtypes ``dts``
    (p, g, m and v); each tensor starts ``offsets[...]`` elements into a
    larger buffer.  A few gradients are 40 times the rest."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = {k: [] for k in "pgmv"}
    for i, shape in enumerate(ADAMW_CHECK_SHAPES):
        n = int(np.prod(shape))
        for j, (k, lo) in enumerate(zip("pgmv", (-1.0, -3.0, -0.1, 0.0))):
            x = rng.uniform(lo, abs(lo) + 0.01, n + 8)
            if k == "g":
                x[rng.integers(0, n + 8, max(1, n // 50))] *= 40.0
            buf = torch.as_tensor(x, dtype=torch.float32, device=dev).to(
                dts[min(j, 2)])
            off = offsets[(i + j) % len(offsets)]
            out[k].append(buf[off:off + n].view(shape))
    return out


def _bits(t):
    import torch
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def phase_kernels_adamw(dev):
    """[kernels_adamw]: B13 against its plain version (``adamw/ref.py``) on
    the card for every dtype instantiation (p, g and the moments each
    float32 or bf16), at ADAMW_OFFSETS and with and without the folded
    clip, 2 steps of the cosine schedule: p, m and v bit-equal, the
    gradients unwritten.  B12 in float32 and bf16 at ADAMW_OFFSETS: the
    same bits on a repeat and through the DTensor route's leaf sums, the
    norm within ADAMW_NORM_RTOL of the plain version and of a float64
    sum, the scale the plain formula on its norm.  The counters are put
    back.  Returns (B12's largest abs error of the norm against the plain
    version, B13's largest abs error of p, m and v)."""
    import itertools
    import torch
    from repro_torch.kernels.adamw import ops as AO
    from repro_torch.kernels.adamw.ref import adamw_update_ref, global_norm_ref
    from repro_torch.optim import AdamW, cosine_schedule
    counters = _optim_counters()
    saved = [c.launches for c in counters]
    opt = AdamW(lr=1e-2, weight_decay=0.1, schedule=cosine_schedule(1, 4))
    dts = (torch.float32, torch.bfloat16)
    t0 = time.perf_counter()
    n13, err13 = 0, 0.0
    for dt_p, dt_g, dt_m in itertools.product(dts, repeat=3):
        for offsets in ADAMW_OFFSETS:
            for clip in (False, True):
                a = _optim_leaves((dt_p, dt_g, dt_m), offsets, dev, n13)
                b = {k: [x.clone() for x in v] for k, v in a.items()}
                scale = torch.tensor(0.37, device=dev) if clip else None
                for i in range(2):
                    sc = opt.scalars(torch.tensor(i + 1, dtype=torch.int32,
                                                  device=dev))
                    AO.adamw_update(a["g"], a["m"], a["v"], a["p"], *sc,
                                    opt.consts(), scale)
                    adamw_update_ref(b["g"], b["m"], b["v"], b["p"], *sc,
                                     opt.consts(), scale)
                torch.cuda.synchronize()
                what = (f"[kernels_adamw] B13 p {dt_p} g {dt_g} moments "
                        f"{dt_m} offsets {offsets} clip {clip}")
                for k in "pmvg":
                    check(all(torch.equal(_bits(x), _bits(y))
                              for x, y in zip(a[k], b[k])),
                          f"{what}: {k} differs from the plain version")
                err13 = max([err13] + [
                    float((x.float() - y.float()).abs().max())
                    for k in "pmv" for x, y in zip(a[k], b[k])])
                n13 += 1
    err12 = 0.0
    for dt in dts:
        for offsets in ADAMW_OFFSETS:
            g = _optim_leaves((dt,) * 3, offsets, dev, 100)["g"]
            runs = [AO.global_norm_scale(g, 1.0) for _ in range(2)]
            runs.append(AO.global_norm_scale(g, 1.0, lambda i, v: v.clone()))
            want, want_s = global_norm_ref(g, 1.0)
            f64 = float(sum((x.double() ** 2).sum() for x in g)) ** 0.5
            torch.cuda.synchronize()
            what = f"[kernels_adamw] B12 {dt} offsets {offsets}"
            n, s = runs[0]
            check(all(torch.equal(_bits(n), _bits(r[0])) and
                      torch.equal(_bits(s), _bits(r[1])) for r in runs),
                  f"{what}: a repeat or the leaf-sum route differs")
            for ref, name in ((float(want), "plain"), (f64, "float64")):
                check(abs(float(n) - ref) <= ADAMW_NORM_RTOL * ref,
                      f"{what}: norm {float(n)!r} vs {name} {ref!r}")
            scale = torch.clamp(torch.full((), 1.0, device=dev)
                                / (n + 1e-9), max=1.0)
            check(torch.equal(_bits(s), _bits(scale)), f"{what}: scale")
            err12 = max(err12, abs(float(n) - float(want)))
            log("kernels_adamw", f"B12 {dt} offsets {offsets}, "
                f"{sum(x.numel() for x in g)} elements in "
                f"{len(g)} leaves: norm {float(n)!r}, plain "
                f"{float(want)!r}, float64 {f64!r} (relative "
                f"{abs(float(n) - f64) / f64:.3g}); scale {float(s)!r} "
                f"(plain {float(want_s)!r}); repeat and leaf-sum route "
                f"bit-identical")
    for c, n in zip(counters, saved):
        c.launches = n
    log("kernels_adamw", f"B13 bit-equal to its plain version in {n13} "
        f"cases (8 dtype instantiations x {len(ADAMW_OFFSETS)} layouts x "
        f"clip on / off, 2 steps, {len(ADAMW_CHECK_SHAPES)} leaves of 1 to "
        f"{max(math.prod(s) for s in ADAMW_CHECK_SHAPES)} elements), the "
        f"gradients unwritten; {time.perf_counter() - t0:.1f} s")
    return err12, err13


def optim_program_times(state, dev, calls):
    """B12 and B13 at [train]'s tree (the last step's parameters and
    moments, gradients drawn from a seed in the parameters' dtype), by
    CUDA events with the host queuing ahead (``queued_ms``: a call builds
    its chunk table on the host and cannot be captured into a graph), in
    turns with their plain versions and the library yardsticks (CUDA-graph
    replays): ``torch._foreach_norm`` (float32 leaf
    norms) and the sum of their squares for B12; ``torch._fused_adamw_``
    for B13, which takes one dtype for a leaf's tensors (it refuses
    float32 moments beside bf16 parameters), so it is timed beside B13
    with the moments cast to bf16 (the tree's f32 moments are released
    for that: this consumes ``state``'s moments).  Bounds: each byte
    read once and written once at 3.35 TB/s; 2 float32 operations an
    element for B12, 17 for B13 at 67 TFLOP/s.  Returns the kernels-line
    rows (``calls``: (B12, B13) launches on [train])."""
    import torch
    from repro_torch.kernels.adamw import ops as AO
    from repro_torch.kernels.adamw.ref import adamw_update_ref, global_norm_ref
    from repro_torch.optim.adamw import pieces, tree_leaves
    from repro_torch.runtime.steps import make_optimizer
    counters = _optim_counters()
    saved = [c.launches for c in counters]
    opt = make_optimizer(_arch_cfg(TRAIN_ARCH))
    ps = tree_leaves(state["params"])
    ms, vs = tree_leaves(state["opt"].mu), tree_leaves(state["opt"].nu)
    gen = torch.Generator(device=dev).manual_seed(1)
    gs = [(torch.randn(p.shape, generator=gen, device=dev) * 1e-3).to(
        p.dtype) for p in ps]
    N = sum(p.numel() for p in ps)
    sc = opt.scalars(state["opt"].step + 1)
    consts = opt.consts()
    _, scale = AO.global_norm_scale(gs, 1.0)
    # B13 against its plain version on this tree, a leaf at a time (the
    # plain version on clones of the leaf's m, v and p): every bit
    t0 = time.perf_counter()
    err13 = 0.0
    for g, m, v, p in zip(gs, ms, vs, ps):
        want = [x.clone() for x in (m, v, p)]
        AO.adamw_update([g], [m], [v], [p], *sc, consts, scale)
        adamw_update_ref([g], *([x] for x in want), *sc, consts, scale)
        for x, y, k in zip((m, v, p), want, "mvp"):
            check(torch.equal(_bits(x), _bits(y)), f"[programs] B13 at "
                  f"[train]'s tree: {k} of the {tuple(p.shape)} leaf "
                  f"differs from the plain version")
            for px, py in zip(pieces(x), pieces(y)):
                err13 = max(err13, float((px.float() - py.float()).abs()
                                         .max()))
        del want
    log("programs", f"B13 bit-equal to its plain version at [train]'s "
        f"tree, leaf by leaf ({len(ps)} leaves, scale {float(scale)!r}): "
        f"max |kernel - plain| {err13!r} over p, m and v; "
        f"{time.perf_counter() - t0:.1f} s")

    def b12():
        return AO.global_norm_scale(gs, 1.0)

    def b13():
        AO.adamw_update(gs, ms, vs, ps, *sc, consts, scale)

    def lib12():
        norms = torch._foreach_norm(gs, 2, dtype=torch.float32)
        return torch.stack(norms).square().sum().sqrt()

    host = {}

    def turns(kernel, plain, lib):
        k1, host[kernel] = queued_ms(kernel, 5)
        p = _program_ms(plain)
        li = _program_ms(lib) if lib else None
        k2, _ = queued_ms(kernel, 5)
        return (k1 + k2) / 2, k1, k2, p, li

    ev12 = cuda_ms(b12, 5, 2)
    ms12, a12, c12, plain12, lib12_ms = turns(
        b12, lambda: global_norm_ref(gs, 1.0), lib12)
    n_k, _ = b12()
    n_p, _ = global_norm_ref(gs, 1.0)
    n_l = lib12()
    err12 = abs(float(n_k) - float(n_p))
    rel = err12 / float(n_p)
    check(rel <= ADAMW_NORM_RTOL, f"[programs] B12 at [train]'s tree: norm "
          f"{float(n_k)!r} vs plain {float(n_p)!r}")
    ev13 = cuda_ms(b13, 3, 1)
    ms13, a13, c13, plain13, _ = turns(
        b13, lambda: adamw_update_ref(gs, ms, vs, ps, *sc, consts, scale),
        None)
    bytes12 = sum(g.numel() * g.element_size() for g in gs)
    bytes13 = sum(x.numel() * x.element_size() * k for xs, k in (
        (ps, 2), (gs, 1), (ms, 2), (vs, 2)) for x in xs)
    try:
        steps = [torch.zeros((), device=dev) for _ in ps]
        torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=3e-4, beta1=0.9,
                            beta2=0.95, weight_decay=0.1, eps=1e-8,
                            amsgrad=False, maximize=False)
        torch.cuda.synchronize()
        mixed = "runs on the tree as it is (not timed here)"
    except RuntimeError as e:
        mixed = f"refuses the tree as it is ({str(e)[:90]})"
    # B13 and the library at bf16 moments: the state's float32 moments go
    state["opt"].mu.clear()
    state["opt"].nu.clear()
    for xs in (ms, vs):
        for i in range(len(xs)):
            xs[i] = xs[i].to(torch.bfloat16)
    steps = [torch.ones((), device=dev) for _ in ps]

    def b13_bf16():
        AO.adamw_update(gs, ms, vs, ps, *sc, consts, scale)

    def fused():
        torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=3e-4, beta1=0.9,
                            beta2=0.95, weight_decay=0.1, eps=1e-8,
                            amsgrad=False, maximize=False)

    ms16, k16a, k16b, lib16, _ = turns(b13_bf16, fused, None)
    bytes16 = sum(x.numel() * x.element_size() * k for xs, k in (
        (ps, 2), (gs, 1), (ms, 2), (vs, 2)) for x in xs)
    for c, n in zip(counters, saved):
        c.launches = n
    row12 = _program_row(
        f"B12 global norm and clip scale over [train]'s {len(gs)} bf16 "
        f"gradient leaves ({N} elements; CUDA events, calls back to back "
        f"{ev12:.4f} ms, queued ahead in turns {a12:.4f} / {c12:.4f} ms; "
        f"host {host[b12]:.4f} ms a call; plain version (a piece at a "
        f"time) {plain12:.4f} ms; library (torch._foreach_norm in float32 "
        f"+ the sum of squares) {lib12_ms:.4f} ms; norm {float(n_k)!r}, "
        f"plain {float(n_p)!r} (relative {rel:.3g}), library "
        f"{float(n_l)!r})", ms12, calls[0], bytes12, 2 * N,
        PEAK_OPS_PER_S["float32"], lib12_ms, "kernel B12")
    row13 = _program_row(
        f"B13 AdamW update with the clip folded in over [train]'s tree "
        f"(bf16 p and g, float32 m and v; CUDA events, calls back to back "
        f"{ev13:.4f} ms, queued ahead in turns {a13:.4f} / {c13:.4f} ms; "
        f"host {host[b13]:.4f} ms a call; plain version (a piece at a "
        f"time) {plain13:.4f} ms; torch._fused_adamw_ {mixed})", ms13,
        calls[1], bytes13, 17 * N, PEAK_OPS_PER_S["float32"], None,
        "kernel B13")
    log("programs", f"B13 at bf16 moments (all four tensors bf16, "
        f"{bytes16} B, bound {bytes16 / HBM_BYTES_PER_S * 1e3:.6f} ms): "
        f"queued ahead in turns {k16a:.4f} / {k16b:.4f} ms; torch._fused_adamw_ "
        f"on the same leaves (its own rounding) {lib16:.4f} ms")
    del gs, ms, vs, ps
    torch.cuda.empty_cache()
    rows = (_kernel_row("global_norm", ADAMW_SOURCE,
                        "src/repro/optim/adamw.py:73", plain12, row12),
            _kernel_row("adamw_update", ADAMW_SOURCE,
                        "src/repro/optim/adamw.py:51", plain13, row13))
    for row, err in zip(rows, (err12, err13)):
        row["max_abs_err"] = err
    return rows


# ---------------------------------------------------------------------------
# The dry run and the examples
# ---------------------------------------------------------------------------

def _build_tmp(prefix):
    import tempfile
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=prefix, dir=build))


def phase_dryrun():
    """Every cell of ``all_cells()`` through ``launch.dryrun.run_cell`` on
    both production meshes, baseline and optimized, into a temporary
    directory under ``build/``: nothing lands on the card
    (``torch.cuda.memory_allocated()`` is the same before and after); then
    ``launch.report.roofline_table`` over the cells of each mesh."""
    import shutil
    import torch
    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun, report
    out = _build_tmp("dryrun_")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mix = {}
    try:
        n = 0
        for multi_pod in (False, True):
            for optimized in (False, True):
                for arch, shape in all_cells():
                    r = dryrun.run_cell(arch, shape, multi_pod,
                                        optimized=optimized,
                                        tag="opt" if optimized else "",
                                        out_dir=out)
                    check(r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
                          and r["memory_per_chip_gb"] > 0
                          and all(math.isfinite(r[k]) for k in (
                              "t_compute", "t_memory", "t_collective")),
                          f"[dryrun] {arch} {shape}: {r}")
                    mix[r["bottleneck"]] = mix.get(r["bottleneck"], 0) + 1
                    n += 1
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        check(mem1 == mem0, f"[dryrun] memory_allocated {mem0} -> {mem1}")
        check(n == 4 * len(all_cells()), f"[dryrun] {n} cells")
        for mesh in ("pod16x16", "pod2x16x16"):
            cells = report.load_cells(mesh, directory=out)
            check(len(cells) == 2 * len(all_cells()),
                  f"[dryrun] {len(cells)} cells on {mesh}")
            log("dryrun", f"roofline table on {mesh} ({len(cells)} cells, "
                f"base and opt; mem/chip counts the step's arguments "
                f"only):\n" + report.roofline_table(cells))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log("dryrun", f"{n} cells ({len(all_cells())} cells x 2 meshes x base / "
        f"optimized) in {wall:.3f} s, nothing compiled; "
        f"memory_allocated {mem0} B before and after; bottleneck mix {mix}")
    return wall


EXAMPLE_RUNS = (("quickstart", []), ("multiapp_placement", []),
                ("serve_split", []),
                ("train_lm", ["--steps", "40", "--batch", "8", "--seq",
                              "128"]))


def phase_examples():
    """The four examples of ``examples_torch/`` on ``cuda:0`` (their
    default), each through its ``main``, which must return 0 (the exit
    code of ``python examples_torch/<name>.py``); ``train_lm`` trains the
    55.6M-parameter qwen3 config for 40 steps with checkpoints in a
    temporary directory under ``build/``, and its loss must fall."""
    import contextlib
    import importlib.util
    import io
    import re
    import shutil
    ckpt = _build_tmp("train_lm_")
    walls = {}
    try:
        for name, argv in EXAMPLE_RUNS:
            if name == "train_lm":
                argv = argv + ["--ckpt", str(ckpt)]
            spec = importlib.util.spec_from_file_location(
                f"example_{name}", ROOT / "examples_torch" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = mod.main(argv)
            except SystemExit as e:
                raise PhaseFailed(f"[examples] {name} exited: {e}\n"
                                  f"{buf.getvalue()}")
            walls[name] = time.perf_counter() - t0
            text = buf.getvalue()
            check(rc == 0, f"[examples] {name} returned {rc}:\n{text}")
            log("examples", f"{' '.join([name, *argv])}: exit 0 in "
                f"{walls[name]:.3f} s; its output:\n{text.rstrip()}")
            if name == "train_lm":
                m = re.search(r"loss: ([\d.]+) -> ([\d.]+)", text)
                check(m is not None and float(m.group(2))
                      < float(m.group(1)),
                      f"[examples] train_lm's loss did not fall:\n{text}")
            if name == "serve_split":
                check("FIN placement:" in text and "new placement:" in text,
                      f"[examples] serve_split did not re-place:\n{text}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log("examples", f"walls (s): {walls}")
    return walls


TIMES = ("chain", "dense", "kbest", "gate", "attn", "plan", "ingest",
         "serve", "prefill", "moe", "ce", "ssm")


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
    if "prefill" in which:
        attn_program_times(_arch_cfg(MOE_ARCH, MOE_PERIODS), dev, None)
        attn_encode_times(dev, None)
        ssd_program_times(dev, None)
    if "ssm" in which:
        ssm_decode_times(dev)
    if "ce" in which:
        ce_program_times(dev, None)
    if "moe" in which:
        import torch
        from repro_torch.models.moe import moe_init
        cfg = _arch_cfg(MOE_ARCH, MOE_PERIODS)
        layer = moe_init(torch.Generator(device=dev).manual_seed(0), cfg,
                         torch.bfloat16, dev)
        moe_ffn_times(layer, cfg, dev, (None, None))
        del layer
        torch.cuda.empty_cache()


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
    from repro_torch.kernels.moe_ffn.ops import moe_ffn
    from repro_torch.kernels.prefill_attn.ops import prefill_attn
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssm_decode.ops import ssm_decode
    dev = torch.device("cuda", 0)
    # float32 products in full float32: the f32 comparisons against the CPU
    # path ([serve_parity]) rest on it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = (banded_minplus_chain, banded_minplus_argmin,
                banded_minplus_chain_kbest, minplus_vecmat,
                minplus_vecmat_argmin, ee_gate, decode_attn,
                quant_signature_rows, prefill_attn, ssd_scan, moe_ffn,
                ssm_decode)

    if argv[:1] == ["--multihost-rank"] and len(argv) == 4:
        multihost_rank(int(argv[1]), int(argv[2]), argv[3])
        return 0
    if argv[:1] == ["--sharded-rank"] and len(argv) == 4:
        sharded_rank(int(argv[1]), int(argv[2]), argv[3])
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
    err_prefill = phase_kernels_prefill(dev)
    err_ce = phase_kernels_ce(dev)
    err_optim = phase_kernels_adamw(dev)
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
    prefill = phase_prefill(dev)
    phase_serve_parity_more(dev)
    # B8 and B9 at their prefills' shapes, with those prefills' launches
    b8_row = serve_moe["b8_row"]
    b9_row = ssd_program_times(dev,
                               serve_ssm["prefill_launches"]["ssd_scan"])
    b8_row["max_abs_err"] = err_prefill["prefill_attn"]
    b9_row["max_abs_err"] = err_prefill["ssd_scan"]
    # B14 at the served decode shape, with [serve_ssm]'s engine launches
    b14_row = ssm_decode_times(dev, launches_ssm["ssm_decode"])
    attn_encode_times(dev, prefill["encode_launches"]["prefill_attn"])
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
    launches_tp = phase_train_parity(dev)
    walls["train_parity"], t0 = time.perf_counter() - t0, time.perf_counter()
    check(launches_tp["linear_ce_forward"] > 0, "linear_ce: no launch on "
          "[train_parity]")
    ce_row = ce_program_times(dev, train_row["b11_launches"])
    ce_row["max_abs_err"] = err_ce
    walls["programs ce"], t0 = time.perf_counter() - t0, time.perf_counter()
    # the rest of the package: the dry run (sizing, specs, roofline,
    # report) and the four examples
    phase_dryrun()
    walls["dryrun"], t0 = time.perf_counter() - t0, time.perf_counter()
    phase_examples()
    walls["examples"], t0 = time.perf_counter() - t0, time.perf_counter()
    # sharded execution over a DeviceMesh: B7 on each rank's heads
    torch.cuda.empty_cache()
    sharded_row = phase_sharded()
    b11_sharded = sharded_row.pop("b11_launches")
    optim_sharded = sharded_row.pop("optim_launches")
    walls["sharded"] = time.perf_counter() - t0
    check(sharded_row["launches"] > 0, "decode_attn: no launch on [sharded]")
    rows.append(sharded_row)
    rows += [b8_row, b9_row, b14_row]
    # B10 at the engine's decode shape and the prefill's, with those paths'
    # calls
    for row in serve_moe["b10_rows"]:
        row["max_abs_err"] = serve_moe["b10_err"]
        check(row["launches"] > 0, "moe_ffn: no launch on [serve_moe]")
    rows += serve_moe["b10_rows"]
    # B11 at [train]'s call, with [train]'s calls; B12 and B13 at [train]'s
    # tree, with [train]'s launches, their errors the larger of that tree's
    # and [kernels_adamw]'s
    rows.append(ce_row)
    for row, err in zip(train_row["optim_rows"], err_optim):
        row["max_abs_err"] = max(row["max_abs_err"], err)
        check(row["launches"] > 0, f"{row['name']}: no launch on [train]")
    rows += train_row["optim_rows"]
    check(prefill["launches"]["moe_ffn"] > 0
          and launches_tp["moe_ffn"] > 0, "moe_ffn: no launch on [prefill] "
          "or [train_parity]")
    log("order", f"B8 / B9 / B10 launches: [serve_moe]'s prefill "
        f"{serve_moe['prefill_launches']['prefill_attn']} / - / "
        f"{serve_moe['prefill_launches']['moe_ffn']}, [serve_ssm]'s prefill "
        f"- / {serve_ssm['prefill_launches']['ssd_scan']} / -, [prefill] "
        f"{prefill['launches']['prefill_attn']} / "
        f"{prefill['launches']['ssd_scan']} / "
        f"{prefill['launches']['moe_ffn']}, hubert's encode "
        f"{prefill['encode_launches']['prefill_attn']} / - / -, "
        f"[train_parity] {launches_tp['prefill_attn']} / "
        f"{launches_tp['ssd_scan']} / {launches_tp['moe_ffn']}; B10 on "
        f"[serve_moe]'s engine run and decode {launches_moe['moe_ffn']}")
    log("order", f"B11 forward launches: [train] "
        f"{train_row['b11_launches']} ({train_row['ce_calls']} a step), "
        f"[train_parity] {launches_tp['linear_ce_forward']}, [sharded]'s "
        f"sharded step {b11_sharded} (on the ranks' shards)")
    log("order", f"B12 / B13 launches: [train] "
        + " / ".join(str(r["launches"]) for r in train_row["optim_rows"])
        + f" (one each a step), [train_parity] "
        f"{launches_tp['global_norm_scale']} / {launches_tp['adamw_update']}"
        f", [branchy_train] 0 / {BRANCHY_TRAIN_STEPS} (no clip there), "
        f"[sharded]'s sharded step {optim_sharded[0]} / {optim_sharded[1]}")
    log("order", f"B6 launches on [branchy]: {launches_branchy}; phase "
        f"walls (s): " + ", ".join(f"[{k}] {v:.1f}" for k, v in walls.items())
        + f"; since the start {time.perf_counter() - T_START:.1f}")
    log("order", f"launches on [serve_ssm]: B6 {launches_ssm['ee_gate']}, "
        f"B7 {launches_ssm['decode_attn']}, B1 "
        f"{launches_ssm['banded_minplus_chain']}; on [serve_moe]: B6 "
        f"{launches_moe['ee_gate']}, B7 {launches_moe['decode_attn']}, B1 "
        f"{launches_moe['banded_minplus_chain']}")
    # B5's launches on its path are Table VII layers, not the [times] shape
    def at_path(r):
        return table7_layer if r["name"] == "minplus_vecmat" else (
            r["ms"], r["bound_ms"])
    order = sorted(((r["launches"] * (at_path(r)[0] - at_path(r)[1]),
                     r["name"]) for r in rows), reverse=True)
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
    # again beside the numbers: a reader of the output's tail sees the card
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
