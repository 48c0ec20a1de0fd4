"""The port's hand-written CUDA kernels, solver, plan IR and serving engine
on the card.

Every test here needs a CUDA card and ``nvcc`` (the kernels have no CPU or
interpret mode) and skips, from a fixture, where there is none.  The file
imports only the port, so it also runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The (min,+) kernels must be bit-equal, distances and parents, to their
plain PyTorch versions on the same device (every candidate is one IEEE add,
the min does not depend on order, and the k-slot order is that of a stable
sort), and the solver and the plan IR on CUDA must equal their CPU path.
The dense (min,+) products (B5, and B4 with its argmin) are bit-equal to
their plain versions too, with a shared W and with a W per row, and the
dense engines and ``solve_many(backend="dense")`` on CUDA equal their CPU
path.  The fused ingest (B2) is byte-equal to its plain version, on rows built
to reach every edge of the quantizer, and a small ``Population`` on CUDA
equals its CPU path.  The exit gate (B6) holds conf to a relative 1e-5 (sums in another order)
and its argmax exactly; decode attention (B7) holds 2e-5 in float32 and
2e-2 in bf16 (its plain version rounds the probabilities to bf16 before
the PV product, the kernel keeps them in float32), with whole split ranges
dead, and gives the same bits on a repeat call.  The serving engine on
CUDA, in float32, must serve the tokens its CPU path serves.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch as T
from repro_torch.configs import get
from repro_torch.core.bellman_ford import kernel_inputs
from repro_torch.kernels.decode_attn.ops import (decode_attn, split_plan,
                                                 split_ranges)
from repro_torch.kernels.decode_attn.ref import decode_attn_ref
from repro_torch.kernels._build import sm_count
from repro_torch.kernels.ee_gate.ops import (ee_gate, gate_plan, gate_slices,
                                             quant_signature_divide,
                                             quant_signature_rows)
from repro_torch.kernels.ee_gate.population import QuantConsts
from repro_torch.kernels.ee_gate.ref import (ee_gate_ref,
                                             quant_signature_rows_ref)
from repro_torch.kernels.minplus import ops
from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                             banded_minplus_chain,
                                             banded_minplus_chain_history,
                                             banded_minplus_chain_kbest)
from repro_torch.kernels.minplus.ops import (minplus_matmat, minplus_vecmat,
                                             minplus_vecmat_argmin)
from repro_torch.kernels.minplus.ref import (banded_minplus_chain_kbest_ref,
                                             banded_minplus_chain_ref,
                                             banded_minplus_ref,
                                             minplus_argmin_ref, minplus_ref)

# (B, L, N, G+1): a single state, the solver's width, the reference kernel
# tests' widest N and deepest G+1
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
# (B, L, N, G+1, K) of the k-slot kernel: a single state, the solver's width
# at K = 4 and 32, and a wider node count at K = 32
KBEST_SHAPES = [(1, 1, 4, 4, 1), (64, 4, 5, 26, 4), (8, 2, 8, 11, 32),
                (4, 4, 5, 26, 32)]
# (case, B, L, N, G+1, K) of the k-slot merge's tie order: every candidate
# equal; integer energies (equal values inside one source's slots, beside
# the duplicated source node) at the solver's width, with K above the
# admissible pool, at N = 32, at B = 1, at a batch that is no multiple of
# the scenarios a block, and at odd G+1 and K (a layer chunk that is not
# 16-byte aligned: the scalar copy-out)
KBEST_TIE_CASES = [("equal", 6, 3, 5, 26, 8), ("runs", 16, 4, 5, 26, 4),
                   ("pool_below_k", 8, 2, 3, 7, 16), ("n32", 2, 2, 32, 9, 4),
                   ("b1", 1, 4, 5, 26, 4), ("ragged", 1000, 3, 3, 7, 4),
                   ("unaligned", 9, 3, 5, 11, 3)]

# (B, S, T) of the dense kernels: the reference kernel tests' shapes
# (tests/test_kernels.py), then S = 130 (N = 5, G+1 = 26) and S = 390
# (N = 15, G+1 = 26)
DENSE_SHAPES = [(1, 16, 16), (8, 128, 128), (3, 37, 65), (16, 300, 129),
                (2, 1, 257), (64, 130, 130), (4, 390, 390)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "or interpret mode")
    return torch.device("cuda", 0)


def _problem(B, L, N, Gp1, seed, dtype, device):
    """Seeded kernel inputs with pruned edges and a duplicated source node
    (ties)."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, N, Gp1))
    dist[rng.uniform(size=dist.shape) < 0.5] = np.inf
    E = rng.uniform(0, 5, (B, L, N, N))
    steep = rng.integers(0, Gp1, (B, L, N, N)).astype(np.float64)
    steep[rng.uniform(size=steep.shape) < 0.3] = np.inf
    E[:, :, 1], steep[:, :, 1], dist[:, 1] = E[:, :, 0], steep[:, :, 0], \
        dist[:, 0]
    Ek, st = kernel_inputs(torch.as_tensor(E, device=device),
                           torch.as_tensor(steep, device=device), dtype)
    return torch.as_tensor(dist, device=device).to(dtype), Ek, st


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lo", [None, 2])
@pytest.mark.parametrize("B,L,N,Gp1", CARD_SHAPES)
def test_kernel_bit_equal_to_plain_on_card(cuda_device, B, L, N, Gp1, lo,
                                           dtype):
    d, Ek, st = _problem(B, L, N, Gp1, B + L + N + Gp1, dtype, cuda_device)
    n0 = banded_minplus_chain.launches
    hist, par = banded_minplus_chain(d, Ek, st, lo=lo)
    assert banded_minplus_chain.launches == n0 + 1
    hist_p, par_p = banded_minplus_chain_ref(d, Ek, st, lo=lo)
    torch.cuda.synchronize()
    assert torch.equal(hist, hist_p) and torch.equal(par, par_p)
    n1 = banded_minplus_argmin.launches
    out, arg = banded_minplus_argmin(d[0], Ek[0, 0], st[0, 0], lo=lo)
    assert banded_minplus_argmin.launches == n1 + 1
    out_p, arg_p = banded_minplus_ref(d[0], Ek[0, 0], st[0, 0], lo=lo)
    assert torch.equal(out, out_p) and torch.equal(arg, arg_p)
    assert torch.equal(out, hist[0, 0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lo", [None, 2])
@pytest.mark.parametrize("case,B,L,N,Gp1", CHAIN_CASES)
def test_kernel_launch_plan_cases_bit_equal_on_card(cuda_device, case, B, L,
                                                    N, Gp1, lo, dtype):
    """B1 on each launch-plan case, and in its init-row mode (one launch,
    counted), bit-equal to the plain version."""
    spb, threads, blocks = ops.chain_plan(B, L, N, Gp1, dtype,
                                          sm_count(cuda_device))
    assert {"ragged": B % spb > 0, "b1": B == 1,
            "loop": -(-B // spb) > blocks,
            "unaligned": N * Gp1 * dtype.itemsize % 16 > 0,
            "layered": not ops.chain_whole(L, N, Gp1, dtype),
            "widest": ops.chain_threads(N, Gp1) > threads}[case]
    d, Ek, st = _problem(B, L, N, Gp1, B + L + N + Gp1, dtype, cuda_device)
    hist, par = banded_minplus_chain(d, Ek, st, lo=lo)
    hist_p, par_p = banded_minplus_chain_ref(d, Ek, st, lo=lo)
    n0 = banded_minplus_chain.launches
    full, par_h = banded_minplus_chain_history(d, Ek, st, lo=lo)
    assert banded_minplus_chain.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(hist, hist_p) and torch.equal(par, par_p)
    assert torch.equal(full, torch.cat([d[:, None], hist_p], dim=1))
    assert torch.equal(par_h, par_p)


def test_cuda_wrapper_raises_instead_of_falling_back(cuda_device):
    d, Ek, st = _problem(2, 2, 5, 6, 0, torch.float64, cuda_device)
    n0 = banded_minplus_chain.launches
    with pytest.raises(ValueError, match="contiguous"):
        banded_minplus_chain(d, Ek.transpose(2, 3), st)
    with pytest.raises(ValueError, match="float64 or float32"):
        banded_minplus_chain(d, Ek.float(), st)
    assert banded_minplus_chain.launches == n0


@pytest.mark.parametrize("backend", ["minplus", "f32"])
def test_solve_many_on_card_equals_cpu_path(cuda_device, backend):
    ps, ns, rs = T.sweep_scenarios(deltas_ms=(1.5, 5.0, 12.0),
                                   uplinks_bps=(0.3e9, 1e9), n_extra_edge=2)
    n0 = banded_minplus_chain.launches
    got = T.solve_many(ps, ns, rs, gamma=25, backend=backend,
                       device=cuda_device)
    assert banded_minplus_chain.launches > n0
    want = T.solve_many(ps, ns, rs, gamma=25, backend=backend, device="cpu")
    for g, w in zip(got, want):
        assert g.found == w.found
        assert {k: v for k, v in g.meta.items() if k != "batch_time"} == \
            {k: v for k, v in w.meta.items() if k != "batch_time"}
        if w.found:
            assert g.config == w.config and g.eval == w.eval


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lo", [None, 2])
@pytest.mark.parametrize("B,L,N,Gp1,K", KBEST_SHAPES)
def test_kbest_kernel_bit_equal_to_plain_on_card(cuda_device, B, L, N, Gp1,
                                                 K, lo, dtype):
    d, Ek, st = _problem(B, L, N, Gp1, B + L + N + Gp1 + K, dtype,
                         cuda_device)
    n0 = banded_minplus_chain_kbest.launches
    got = banded_minplus_chain_kbest(d, Ek, st, K, lo=lo)
    assert banded_minplus_chain_kbest.launches == n0 + 1
    want = banded_minplus_chain_kbest_ref(d, Ek, st, K, lo=lo)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tie_problem(case, B, L, N, Gp1, seed, dtype, device):
    """B3 inputs whose pools tie: ``"equal"`` makes every candidate of a
    layer equal; the other cases have integer energies."""
    if case != "equal":
        rng = np.random.default_rng(seed)
        dist = np.floor(rng.uniform(0, 4, (B, N, Gp1)))
        dist[rng.uniform(size=dist.shape) < 0.5] = np.inf
        E = np.floor(rng.uniform(0, 3, (B, L, N, N)))
        steep = rng.integers(0, Gp1, (B, L, N, N)).astype(np.float64)
        steep[rng.uniform(size=steep.shape) < 0.3] = np.inf
        E[:, :, 1], steep[:, :, 1], dist[:, 1] = E[:, :, 0], \
            steep[:, :, 0], dist[:, 0]
    else:
        dist = np.full((B, N, Gp1), 2.0)
        E, steep = np.ones((B, L, N, N)), np.zeros((B, L, N, N))
    Ek, st = kernel_inputs(torch.as_tensor(E, device=device),
                           torch.as_tensor(steep, device=device), dtype)
    return torch.as_tensor(dist, device=device).to(dtype), Ek, st


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lo", [None, 2])
@pytest.mark.parametrize("case,B,L,N,Gp1,K", KBEST_TIE_CASES)
def test_kbest_kernel_tie_order_bit_equal_on_card(cuda_device, case, B, L,
                                                  N, Gp1, K, lo, dtype):
    spb, _ = ops.kbest_plan(B, N, Gp1, K, dtype, sm_count(cuda_device))
    assert {"ragged": B % spb > 0, "unaligned": N * Gp1 * K % 4 > 0,
            "pool_below_k": N < K}.get(case, True)
    d, Ek, st = _tie_problem(case, B, L, N, Gp1, B + L + N + K, dtype,
                             cuda_device)
    got = banded_minplus_chain_kbest(d, Ek, st, K, lo=lo)
    want = banded_minplus_chain_kbest_ref(d, Ek, st, K, lo=lo)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    h = got[0]
    assert bool((torch.isfinite(h[..., 1:]) & (h[..., 1:] == h[..., :-1]))
                .any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kbest_kernel_at_one_slot_equals_chain_kernel(cuda_device, dtype):
    d, Ek, st = _problem(64, 4, 5, 26, 3, dtype, cuda_device)
    hist, pn, pk = banded_minplus_chain_kbest(d, Ek, st, 1)
    h1, p1 = banded_minplus_chain(d, Ek, st)
    assert torch.equal(hist[..., 0], h1) and torch.equal(pn[..., 0], p1)
    assert torch.equal(pk[..., 0], torch.where(p1 >= 0, 0, -1).int())


def test_kbest_kernel_raises_beyond_shared_memory(cuda_device):
    d, Ek, st = _problem(2, 2, 5, 26, 0, torch.float64, cuda_device)
    K = 1
    while ops.kbest_smem_bytes(5, 26, K, torch.float64) <= ops.MAX_SMEM_BYTES:
        K += 1
    n0 = banded_minplus_chain_kbest.launches
    with pytest.raises(ValueError, match="shared memory"):
        banded_minplus_chain_kbest(d, Ek, st, K)
    assert banded_minplus_chain_kbest.launches == n0


@pytest.mark.parametrize("backend", ["minplus", "f32"])
def test_kbest_solve_many_on_card_equals_cpu_path(cuda_device, backend):
    ps, ns, rs = T.sweep_scenarios(deltas_ms=(1.5, 5.0), uplinks_bps=(0.3e9,
                                                                     1e9),
                                   n_extra_edge=2)
    n0 = banded_minplus_chain_kbest.launches
    got = T.solve_many(ps, ns, rs, gamma=10, n_best=4, backend=backend,
                       device=cuda_device)
    assert banded_minplus_chain_kbest.launches > n0
    want = T.solve_many(ps, ns, rs, gamma=10, n_best=4, backend=backend,
                        device="cpu")
    for g, w in zip(got, want):
        assert g.found == w.found
        if w.found:
            assert g.config == w.config and g.eval == w.eval


@pytest.mark.parametrize("n_best", [1, 4])
def test_plan_deltas_on_card_equal_cpu_path(cuda_device, n_best):
    nw = T.paper_scenario(n_extra_edge=2)
    pf = T.paper_profile("h2")
    req = T.AppRequirements(0.55, 5e-3)
    plans = [T.Plan(nw, pf, req, n_best=n_best, device=dev)
             for dev in (cuda_device, "cpu")]
    rng = np.random.default_rng(2)
    for t in range(8):
        bps = float(rng.uniform(0.3, 1.0)) * 1e9
        for p in plans:
            if t % 4 == 3:
                p.update_slice(0.8)
            elif t % 4 == 2:
                p.update_backhaul(1.3)
            else:
                p.update_uplink(bps)
        got, want = (p.solve() for p in plans)
        assert got.config == want.config and got.eval == want.eval
        assert dataclasses.asdict(plans[0].stats) == \
            dataclasses.asdict(plans[1].stats)
    for f in ("C", "T", "E", "TT", "mask", "init_T", "init_E", "init_mask"):
        assert torch.equal(getattr(plans[0].ext, f).cpu(),
                           getattr(plans[1].ext, f))


@pytest.mark.parametrize("tail", [0, 1664])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,V", [(1, 128), (5, 5000), (4, 153600),
                                 (16, 50304)])
def test_ee_gate_kernel_matches_plain_on_card(cuda_device, B, V, dtype,
                                              tail):
    x = np.random.default_rng(B + V).normal(size=(B, V)) * 4
    if tail:
        x[:, V - tail:] = -np.inf
    x = torch.as_tensor(x, dtype=torch.float32, device=cuda_device).to(dtype)
    n0 = ee_gate.launches
    conf, arg = ee_gate(x)
    assert ee_gate.launches == n0 + 1
    conf_p, arg_p = ee_gate_ref(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(conf, conf_p, rtol=1e-5, atol=0)
    assert torch.equal(arg, arg_p)


def test_ee_gate_kernel_ties_keep_the_first_index(cuda_device):
    x = torch.full((3, 4096), -5.0, device=cuda_device)
    x[0, [3000, 77]] = 20.0
    x[1, [2049, 2048]] = 7.0
    x[2] = -float("inf")
    conf, arg = ee_gate(x)
    assert arg.tolist() == [77, 2048, 0]
    assert float(conf[2]) == 1 / 4096


def _gate_rows(B, V, P, seed):
    """Rows for the split gate: seeded logits with first-max ties on both
    sides of the first slice boundary (row 0), at that boundary and the
    row's end (row 1), across every boundary (row 2), and an all -inf row
    (the last); the other rows are plain."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,V", [(4, 153600), (3, 4097), (1, 4097),
                                 (3, 2047), (3, 2048), (3, 2049), (4, 5000),
                                 (200, 4097), (3, 9)])
def test_ee_gate_split_kernel_on_card(cuda_device, B, V, dtype):
    """The redesigned B6 splits a row over P blocks (gate_plan): V below,
    at and above one block's 2,048 elements, V = 4097 (rows not 16-byte
    aligned), B above the SM count (P = 1); ties on both sides of a slice
    boundary keep the lower index, an all -inf row gives conf 1/V and
    index 0; conf within 1e-5 relative of the plain version, the argmax
    exact, and a repeat call gives the same bits."""
    P = gate_plan(B, V, sm_count(cuda_device))
    x, want = _gate_rows(B, V, P, B + V)
    x = torch.as_tensor(x, dtype=torch.float32, device=cuda_device).to(dtype)
    conf, arg = ee_gate(x)
    again = ee_gate(x)
    conf_p, arg_p = ee_gate_ref(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(conf, conf_p, rtol=1e-5, atol=0)
    assert torch.equal(arg, arg_p)
    assert torch.equal(conf, again[0]) and torch.equal(arg, again[1])
    assert all(int(arg[r]) == a for r, a in want.items())
    assert float(conf[B - 1]) == pytest.approx(1 / V, rel=1e-6)


def _attn_inputs(B, H, KV, D, T, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                            device=device).to(dtype)
            for s in ((B, H, D), (B, T, KV, D), (B, T, KV, D))]


def _attn_close(q, k, v, cache_pos, pos, window=0):
    """B7 within 2e-5 (float32) / 2e-2 (bf16) of its plain version, one
    launch, and the same bits on a repeat call."""
    n0 = decode_attn.launches
    got = decode_attn(q, k, v, cache_pos, pos, window=window)
    assert decode_attn.launches == n0 + 1
    want = decode_attn_ref(q, k, v, cache_pos, pos, window=window)
    again = decode_attn(q, k, v, cache_pos, pos, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,D,T", [(1, 4, 4, 32, 128), (2, 8, 2, 64, 256),
                                        (1, 8, 1, 64, 300), (3, 4, 2, 16, 64),
                                        (4, 32, 8, 80, 256),
                                        (4, 32, 8, 80, 8192),
                                        (4, 32, 8, 80, 4097)])
def test_decode_attn_kernel_matches_plain_on_card(cuda_device, B, H, KV, D,
                                                  T, dtype, window):
    q, k, v = _attn_inputs(B, H, KV, D, T, dtype, cuda_device, B + H + T)
    cache_pos = torch.arange(T, dtype=torch.int32, device=cuda_device)
    cache_pos[T - T // 4:] = -1                 # empty ring slots
    pos = T - T // 4 - 3                        # and future ones
    _attn_close(q, k, v, cache_pos, pos, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", ["first", "second", "last", "future", "dead"])
@pytest.mark.parametrize("B,H,KV,D,T", [(1, 32, 8, 80, 4097),
                                        (4, 32, 8, 80, 4097),
                                        (1, 8, 2, 64, 1000)])
def test_decode_attn_kernel_with_a_dead_split_range_on_card(
        cuda_device, B, H, KV, D, T, mask, dtype):
    """A whole split range empty (cache_pos -1: the first, the second or
    the last block's), the last range in the future (beyond pos), or no
    live slot at all (the uniform average)."""
    P = split_plan(B, KV, T, D, torch.empty((), dtype=dtype).element_size())
    assert P > 1
    ranges = split_ranges(T, P)
    q, k, v = _attn_inputs(B, H, KV, D, T, dtype, cuda_device, T + P)
    cache_pos = torch.arange(T, dtype=torch.int32, device=cuda_device)
    pos = T - 1
    if mask == "dead":
        cache_pos[:] = -1
    elif mask == "future":
        pos = ranges[-1][0] - 1
    else:
        lo, hi = ranges[{"first": 0, "second": 1, "last": -1}[mask]]
        cache_pos[lo:hi] = -1
    _attn_close(q, k, v, cache_pos, pos)


def test_decode_attn_kernel_refuses_rows_it_cannot_load(cuda_device):
    kv = torch.zeros(1, 16, 2, 8, device=cuda_device)
    cp = torch.arange(16, dtype=torch.int32, device=cuda_device)
    n7 = decode_attn.launches
    with pytest.raises(ValueError, match="16-byte words"):   # 6 * 4 = 24 B
        decode_attn(torch.zeros(1, 4, 6, device=cuda_device),
                    kv[..., :6].contiguous(), kv[..., :6].contiguous(), cp, 3)
    shifted = torch.zeros(kv.numel() + 1, device=cuda_device)[1:].view(
        kv.shape)
    with pytest.raises(ValueError, match="aligned"):
        decode_attn(torch.zeros(1, 4, 8, device=cuda_device), shifted, kv,
                    cp, 3)
    assert decode_attn.launches == n7


def test_serving_kernel_wrappers_refuse_bad_inputs(cuda_device):
    x = torch.zeros(4, 64, dtype=torch.float64, device=cuda_device)
    q = torch.zeros(1, 4, 8, device=cuda_device)
    kv = torch.zeros(1, 16, 2, 8, device=cuda_device)
    cp = torch.arange(16, dtype=torch.int32, device=cuda_device)
    n6, n7 = ee_gate.launches, decode_attn.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ee_gate(x)
    with pytest.raises(ValueError, match="contiguous"):
        ee_gate(x.float().t())
    with pytest.raises(ValueError, match="share"):
        decode_attn(q, kv.bfloat16(), kv, cp, 3)
    with pytest.raises(ValueError, match="int32"):
        decode_attn(q, kv, kv, cp.long(), 3)
    assert (ee_gate.launches, decode_attn.launches) == (n6, n7)


def test_serve_engine_on_card_equals_cpu_path(cuda_device):
    """The reduced qwen3-4b in float32 through the engine with a placement:
    tokens, exits and EngineStats equal on CUDA and the CPU path, with B6
    launched 2 and B7 2 times per decode step (one exit, two layers)."""
    from repro_torch.models import transformer as TT
    from repro_torch.runtime.serve_engine import SplitServeEngine
    cfg = get("qwen3-4b", reduced=True)
    params = TT.init_model(cfg, seed=3, device=cuda_device)
    runs = []
    for dev, p in ((cuda_device, params), ("cpu", TT.tree_to(params, "cpu"))):
        eng = SplitServeEngine(cfg, p, batch_size=4, cache_len=32,
                               thresholds=[0.05], network=T.paper_scenario(),
                               profile=T.paper_profile("h2"),
                               req=T.AppRequirements(0.5, 8e-3), device=dev)
        reqs = [eng.submit([1 + i % 7, 2, 3], 5) for i in range(6)]
        n6, n7 = ee_gate.launches, decode_attn.launches
        eng.run(max_steps=100)
        runs.append(([(r.tokens, r.exits_taken) for r in reqs],
                     dataclasses.asdict(eng.stats),
                     ee_gate.launches - n6, decode_attn.launches - n7))
    (tok_g, st_g, n6, n7), (tok_c, st_c, _, _) = runs
    assert tok_g == tok_c and st_g == st_c
    assert n6 == 2 * st_g["steps"] and n7 == 2 * st_g["steps"]


def _close_trees(a, b, tol=1e-4):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _close_trees(a[k], b[k], tol)
        return
    torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b", "arctic-480b",
                                  "hubert-xlarge"])
def test_full_sequence_entry_points_on_card_equal_cpu_path(cuda_device,
                                                           arch):
    """The reduced SSM, MoE, hybrid and encoder-only models in float32:
    forward_train, prefill (logits and caches; mixtral's prompt wraps its
    16-slot window) and three decode steps on CUDA within 1e-4 of the CPU
    path, with B7 launched once per attention layer a step."""
    from repro_torch.models import transformer as TT
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(arch, reduced=True)
    params = TT.init_model(cfg, seed=5, device=cuda_device)
    cpu = TT.tree_to(params, "cpu")
    B, S = 2, 24
    rng = np.random.default_rng(2)
    if cfg.frontend == "audio":
        batch = {"frames": torch.from_numpy(
            rng.normal(size=(B, S, cfg.d_model)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S + 3)).astype(np.int64))}
    on = lambda b, d: {k: v[:, :S].to(d) for k, v in b.items()}
    _close_trees(TT.forward_train(params, cfg, on(batch, cuda_device)),
                 TT.forward_train(cpu, cfg, on(batch, "cpu")))
    if not cfg.has_decoder:
        return
    lg, cg = TT.prefill(params, cfg, on(batch, cuda_device), cache_len=32)
    lc, cc = TT.prefill(cpu, cfg, on(batch, "cpu"), cache_len=32)
    _close_trees({"l": lg, "c": cg}, {"l": lc, "c": cc})
    n_attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.pattern)
    for pos in range(S, S + 3):
        tok = batch["tokens"][:, pos:pos + 1]
        n7 = decode_attn.launches
        lg, cg, eg = TT.decode_step(params, cfg, tok.to(cuda_device), cg, pos)
        assert decode_attn.launches - n7 == n_attn
        lc, cc, ec = TT.decode_step(cpu, cfg, tok, cc, pos)
        _close_trees({"l": lg, "e": eg, "c": cg}, {"l": lc, "e": ec, "c": cc})


def _dense_problem(B, S, T, seed, dtype, device, per_row, density=0.6):
    """Seeded dense inputs with missing edges, a -inf and a NaN entry (both
    missing) and a duplicated source state (ties)."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, S))
    dist[rng.uniform(size=dist.shape) > 0.9] = np.inf
    W = rng.uniform(0, 5, (B, S, T) if per_row else (S, T))
    W[rng.uniform(size=W.shape) > density] = np.inf
    W.reshape(-1)[0] = -np.inf
    W.reshape(-1)[-1] = np.nan
    if S > 1:
        dist[:, 1] = dist[:, 0]
        W[..., 1, :] = W[..., 0, :]
    return (torch.as_tensor(dist, device=device).to(dtype),
            torch.as_tensor(W, device=device).to(dtype))


def _sparse_dense_problem(B, S, T, seed, dtype, device, per_row):
    """Seeded inputs whose dist is 90% +inf, with a row of no finite entry
    (row 0), a row whose only finite source is the last (row 1), -inf and
    NaN entries (row 2), and on every row a skipped source (dist -inf)
    that ties a kept one (same W row) and two kept sources that tie."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, S))
    dist[rng.uniform(size=dist.shape) < 0.9] = np.inf
    W = rng.uniform(0, 5, (B, S, T) if per_row else (S, T))
    W[rng.uniform(size=W.shape) > 0.6] = np.inf
    W[..., 3, :] = W[..., 5, :] = W[..., 4, :]
    dist[:, 3], dist[:, 4], dist[:, 5] = -np.inf, 1.0, 1.0
    dist[0] = np.inf
    dist[1] = np.inf
    dist[1, -1] = 2.0
    dist[2, ::3] = -np.inf
    dist[2, 1::3] = np.nan
    return (torch.as_tensor(dist, device=device).to(dtype),
            torch.as_tensor(W, device=device).to(dtype))


def _dense_bit_equal(d, W):
    n5, n4 = minplus_vecmat.launches, minplus_vecmat_argmin.launches
    out = minplus_vecmat(d, W)
    got, arg = minplus_vecmat_argmin(d, W)
    assert (minplus_vecmat.launches, minplus_vecmat_argmin.launches) == \
        (n5 + 1, n4 + 1)
    want, arg_p = minplus_argmin_ref(d, W)
    torch.cuda.synchronize()
    assert torch.equal(out, minplus_ref(d, W)) and torch.equal(out, want)
    assert torch.equal(got, want) and torch.equal(arg, arg_p)
    assert bool((arg >= 0).any())
    return arg


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,S,T", [(5, 37, 65), (64, 130, 130),
                                   (16, 300, 129), (8, 390, 390),
                                   (3, 6, 1100)])
def test_dense_kernels_bit_equal_on_sparse_dists_on_card(cuda_device, B, S, T,
                                                         dtype, per_row):
    """B4 walks only the sources some row reaches: rows with no finite
    source, with the last only, with -inf / NaN entries, and ties between
    a skipped and a kept source stay bit-equal (T = 1100 takes five
    target tiles)."""
    d, W = _sparse_dense_problem(B, S, T, B + S + T, dtype, cuda_device,
                                 per_row)
    arg = _dense_bit_equal(d, W)
    assert bool((arg[0] == -1).all())
    assert set(arg[1].unique().tolist()) <= {-1, S - 1}
    assert bool((arg[3:] != 3).all())


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,S,T", DENSE_SHAPES)
def test_dense_kernels_bit_equal_to_plain_on_card(cuda_device, B, S, T, dtype,
                                                  per_row):
    d, W = _dense_problem(B, S, T, B + S + T, dtype, cuda_device, per_row)
    _dense_bit_equal(d, W)


def _one_scenario_dist(S, seed, case):
    """A B = 1 dist as a Table VII layer gives it (about 10% reached), or:
    "first_slice_dead" (no live source in the first slice of the plan),
    "last_only" (only the last source live), "nonfinite" (-inf and NaN
    entries beside the finite ones)."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (1, S))
    dist[rng.uniform(size=dist.shape) < 0.9] = np.inf
    _, Q = ops.dense_plan(1, S, S, False, 132)
    if case == "first_slice_dead":
        dist[0, :-(-S // Q)] = np.inf
    elif case == "last_only":
        dist[:] = np.inf
        dist[0, -1] = 1.0
    elif case == "nonfinite":
        dist[0, ::5] = -np.inf
        dist[0, 1::7] = np.nan
    return dist


@pytest.mark.parametrize("case", ["layer", "first_slice_dead", "last_only",
                                  "nonfinite"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S", [165, 390, 397])
def test_dense_kernels_at_one_scenario_on_card(cuda_device, S, dtype, case):
    """B5 (and B4) at B = 1 and the Table VII layer shapes S = T = 165 and
    390 (and 397, not a multiple of a source slice): the sources split over
    a cluster and merged in slice order stay bit-equal to the plain
    version, with a slice of no live source, only the last source live,
    and -inf / NaN dists."""
    d = torch.as_tensor(_one_scenario_dist(S, S, case), device=cuda_device)
    W = torch.as_tensor(_dense_problem(1, S, S, S + 1, torch.float64, "cpu",
                                     False)[1].numpy(), device=cuda_device)
    d, W = d.to(dtype), W.to(dtype)
    per, Q = ops.dense_plan(1, S, S, False, sm_count(cuda_device))
    assert Q > 1
    arg = _dense_bit_equal(d, W)
    again = minplus_vecmat(d, W)
    assert torch.equal(again, minplus_ref(d, W))
    if case == "last_only":
        assert set(arg[0].unique().tolist()) <= {-1, S - 1}


def test_dense_kernel_reads_a_layer_of_a_stack_in_place(cuda_device):
    """A [B, L, S, T] stack's layer (batch stride L*S*T) and a shared W
    expanded to [B, S, T] (batch stride 0) give the plain results."""
    d, W = _dense_problem(16, 130, 130, 7, torch.float64, cuda_device, True)
    stack = torch.stack([W, W.flip(0), W.roll(1, 0)], dim=1)
    for l in range(3):
        got = minplus_vecmat_argmin(d, stack[:, l])
        want = minplus_argmin_ref(d, stack[:, l].contiguous())
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    shared = W[3]
    assert torch.equal(minplus_vecmat(d, shared.expand(16, 130, 130)),
                       minplus_ref(d, shared))
    assert torch.equal(minplus_matmat(d, shared), minplus_ref(d, shared))


def test_dense_wrapper_raises_instead_of_falling_back(cuda_device):
    d, W = _dense_problem(4, 32, 16, 1, torch.float64, cuda_device, False)
    n5, n4 = minplus_vecmat.launches, minplus_vecmat_argmin.launches
    with pytest.raises(ValueError, match="contiguous"):
        minplus_vecmat(d, W.t().contiguous().t())
    with pytest.raises(ValueError, match="float64 or float32"):
        minplus_vecmat_argmin(d, W.float())
    with pytest.raises(ValueError, match="W must be"):
        minplus_vecmat(d, W[:16])
    assert (minplus_vecmat.launches, minplus_vecmat_argmin.launches) == \
        (n5, n4)


@pytest.mark.parametrize("lam", [None, 4])
def test_dense_engines_on_card_equal_cpu_path(cuda_device, lam):
    """Graph tensors byte-equal, and every dense engine bit-equal, on CUDA
    and the CPU path."""
    from repro_torch.core import bellman_ford as bf
    from repro_torch.core.feasible_graph import batch_layer_tensors
    ps, ns, rs = T.sweep_scenarios(apps=("h2",), deltas_ms=(2.0, 8.0),
                                   uplinks_bps=(0.5e9, 1e9), n_extra_edge=2)
    runs = {}
    for where in (cuda_device, "cpu"):
        fgs = T.build_feasible_graphs(
            T.build_extended_graphs(ns, ps, rs, device=where), 10, lam=lam)
        Ws, init = batch_layer_tensors(fgs)
        n0 = minplus_vecmat_argmin.launches
        out = [Ws, init, *bf.batched_layered_relax_argmin(init, Ws),
               bf.batched_layered_relax_min(init, Ws),
               *bf.batched_layered_relax_kbest(init, Ws, 3),
               bf.layered_relax(init[0], Ws[0], "f32"),
               *bf.bellman_ford(Ws[0, 0], 0)]
        if where != "cpu":
            assert minplus_vecmat_argmin.launches > n0
        runs[str(where)] = [x.cpu() for x in out]
    for a, b in zip(runs[str(cuda_device)], runs["cpu"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n_best", [1, 3])
def test_dense_solve_many_on_card_equals_cpu_path(cuda_device, n_best):
    ps, ns, rs = T.sweep_scenarios(deltas_ms=(1.5, 5.0, 12.0),
                                   uplinks_bps=(0.3e9, 1e9), n_extra_edge=2)
    n0 = minplus_vecmat_argmin.launches
    got = T.solve_many(ps, ns, rs, gamma=25, backend="dense", n_best=n_best,
                       device=cuda_device)
    if n_best == 1:
        assert minplus_vecmat_argmin.launches > n0
    want = T.solve_many(ps, ns, rs, gamma=25, backend="dense", n_best=n_best,
                        device="cpu")
    banded = T.solve_many(ps, ns, rs, gamma=25, n_best=n_best,
                          device=cuda_device)
    for g, w, b in zip(got, want, banded):
        assert g.found == w.found == b.found
        assert {k: v for k, v in g.meta.items() if k != "batch_time"} == \
            {k: v for k, v in w.meta.items() if k != "batch_time"}
        if w.found:
            assert g.config == w.config == b.config
            assert g.eval == w.eval == b.eval


def test_dense_fin_all_exit_costs_on_card(cuda_device):
    nw = T.make_network(("mobile",) + ("edge",) * 5 + ("cloud",),
                        compute_frac=[1e-3] * 7)
    pf = T.synthetic_profile(6, 4, seed=0, ops_scale=5e7)
    req = T.AppRequirements(0.0, 20e-3)
    n0 = minplus_vecmat.launches
    dense = T.fin_all_exit_costs(nw, pf, req, gamma=10, device=cuda_device)
    assert minplus_vecmat.launches == n0 + pf.n_blocks - 1
    assert dense.tobytes() == T.fin_all_exit_costs(
        nw, pf, req, gamma=10, backend="banded", device=cuda_device).tobytes()
    assert dense.tobytes() == T.fin_all_exit_costs(
        nw, pf, req, gamma=10, device="cpu").tobytes()
    f32 = T.fin_all_exit_costs(nw, pf, req, gamma=10, backend="f32",
                               device=cuda_device)
    assert f32.tobytes() == T.fin_all_exit_costs(
        nw, pf, req, gamma=10, backend="f32", device="cpu").tobytes()


# ---------------------------------------------------------------------------
# the fused ingest (B2) and the population cohort
# ---------------------------------------------------------------------------

def _ingest_consts(app, device, modes=None, gamma=10, delta=None):
    """The constants bundle of one app's plan on the paper scenario with two
    extra edge nodes, on ``device``; and the source node."""
    nw = T.paper_scenario(n_extra_edge=2)
    req = T.AppRequirements(0.55, 5e-3)
    p = T.Plan(nw, T.paper_profile(app), req, gamma=gamma, device=device)
    return QuantConsts(p._bits_pack, p._C_pack, p._mask_pack, p._load_pack,
                       tuple(p._modes if modes is None else modes), gamma,
                       req.delta if delta is None else delta), \
        nw.source_node


# B2's fast path takes divide operands of +0 or in [2^-200, 2^200]: rates at
# and across those ends, subnormal, tiny and huge rates and the largest
# double; and deltas outside the domain, inside it at both ends, and huge
INGEST_EDGE_RATES = (5e-324, 1e-310, 2.2250738585072014e-308, 2.0 ** -200,
                     2.0 ** -200 * (1 - 2.0 ** -53), 2.0 ** 200,
                     2.0 ** 200 * (1 + 2.0 ** -52), 1e300,
                     1.7976931348623157e308)
INGEST_EDGE_DELTAS = (5e-324, 1e-200, 1e-55, 1e50, 1e300)


def _ingest_rows(c, Us, seed, src):
    """Seeded (Us, N) rates with rates aimed at integers and .5 ties of the
    scaled value (and one ulp either side), rates whose significand is all
    ones and powers of two, INGEST_EDGE_RATES, zeros, NaN, +-inf, negatives
    and rates below the loads."""
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


def _ingest_bundles(c):
    """The plan's bundle (both modes), the tighten loop's single-mode
    bundles at a Python delta_eff, synthetic packs with zero bits and zero
    C entries, and the plan's packs at INGEST_EDGE_DELTAS."""
    packs = (c.bits_pack, c.C_pack, c.mask_pack, c.load_pack)
    bits0 = c.bits_pack.clone()
    bits0[::3] = 0.0
    C0 = c.C_pack.clone()
    C0.view(-1)[1::4] = 0.0
    return ([c] + [QuantConsts(*packs, ("floor",), c.gamma,
                               c.delta * 0.85 ** r) for r in (1, 4)]
            + [QuantConsts(bits0, C0, c.mask_pack, c.load_pack, c.modes,
                           c.gamma, c.delta)]
            + [QuantConsts(*packs, c.modes, c.gamma, d)
               for d in INGEST_EDGE_DELTAS])


@pytest.mark.parametrize("Us", [0, 1, 4097, 100_003])
@pytest.mark.parametrize("app", ["h1", "h4", "h6"])
def test_quant_signature_kernel_byte_equal_on_card(cuda_device, app, Us):
    """Both modes of the plan's packs, the tighten loop's single-mode packs
    at a Python delta_eff, zero bits and C, and deltas at and beyond the
    fast path's domain, on rows with edge rates: the kernel's rows equal
    its plain version's on the card and on the CPU."""
    c, src = _ingest_consts(app, cuda_device)
    bundles = _ingest_bundles(c)
    vec = torch.as_tensor(_ingest_rows(c, Us, Us + len(app), src),
                          device=cuda_device)
    for b in bundles:
        args = (b.bits_pack, b.C_pack, b.mask_pack, b.load_pack, b.modes,
                b.gamma, b.delta)
        n = quant_signature_rows.launches
        got = quant_signature_rows(vec, *args)
        torch.cuda.synchronize()
        assert quant_signature_rows.launches == n + (Us > 0)
        assert got.shape == (Us, b.out_width) and got.dtype == torch.int16
        assert torch.equal(got, quant_signature_rows_ref(vec, *args))
        cpu = quant_signature_rows_ref(vec.cpu(), *(
            a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("gamma", [3, 10])
@pytest.mark.parametrize("modes", [("floor", "ceil"), ("round", "ceil"),
                                   ("round",), ("ceil", "floor")])
def test_quant_signature_kernel_modes_on_card(cuda_device, modes, gamma):
    """Synthetic packs with masked slots, zero C, large loads and values
    above gamma, every mode pair and gamma."""
    rng = np.random.default_rng(gamma)
    K2, N = 7, 6
    packs = [rng.uniform(1e3, 5e6, (K2, 1)), rng.uniform(0.0, 3e-3, (K2, N)),
             rng.random((K2, N)) > 0.2, rng.uniform(0.0, 6e8, (K2, 1))]
    packs[1][rng.random((K2, N)) < 0.1] = 0.0
    c = QuantConsts(*(torch.as_tensor(a, device=cuda_device) for a in packs),
                    modes, gamma, float(rng.uniform(2e-3, 12e-3)))
    vec = torch.as_tensor(_ingest_rows(c, 5000, 3, 0), device=cuda_device)
    args = (c.bits_pack, c.C_pack, c.mask_pack, c.load_pack, c.modes,
            c.gamma, c.delta)
    got = quant_signature_rows(vec, *args)
    want = quant_signature_rows_ref(vec, *args)
    assert torch.equal(got, want)
    assert bool((want == -1).any()) and bool((want > 0).any())


@pytest.mark.parametrize("K2,N", [(3, 1), (9, 41), (2, 400), (23, 15)])
def test_quant_signature_kernel_generic_shapes_on_card(cuda_device, K2, N):
    """The generic instantiation: one link column (64 rows a group), a group
    whose int16 run is not a multiple of 16 bytes (N = 41: 7 rows), more
    links a row than a block has threads (one row a group, threads loop),
    and the Table VII depth (K2 = 23, N = 15)."""
    rng = np.random.default_rng(K2 * 1000 + N)
    packs = [rng.uniform(1e3, 5e6, (K2, 1)), rng.uniform(0.0, 3e-3, (K2, N)),
             rng.random((K2, N)) > 0.2, rng.uniform(0.0, 6e8, (K2, 1))]
    c = QuantConsts(*(torch.as_tensor(a, device=cuda_device) for a in packs),
                    ("round", "ceil"), 10, float(rng.uniform(2e-3, 12e-3)))
    for Us in (1, 7, 3001):
        vec = torch.as_tensor(_ingest_rows(c, Us, Us, 0), device=cuda_device)
        args = (c.bits_pack, c.C_pack, c.mask_pack, c.load_pack, c.modes,
                c.gamma, c.delta)
        assert torch.equal(quant_signature_rows(vec, *args),
                           quant_signature_rows_ref(vec, *args))


def _divide_operands(n, seed):
    """Seeded float64 (a, b) pairs in B2's fast domain aimed at the divide's
    edges: significands all ones, powers of two, short and random
    significands, the domain's ends, zero dividends, and the ingest's own
    magnitudes."""
    rng = np.random.default_rng(seed)

    def draw(lo, hi):
        e = rng.integers(lo, hi + 1, n)
        kind = rng.integers(0, 5, n)
        m = np.where(kind == 0, 2.0 - 2.0 ** -52, np.where(
            kind == 1, 1.0, np.where(kind == 2, 1.0 + rng.integers(
                0, 2 ** 12, n) * 2.0 ** -12, 1.0 + rng.random(n))))
        return np.ldexp(m, e)

    a, b = draw(-199, 199), draw(-199, 199)
    near = rng.random(n) < 0.3
    a = np.where(near, draw(10, 23), a)
    b = np.where(near, draw(17, 33), b)
    ends = np.array([2.0 ** -200, 2.0 ** 200 * (1 - 2.0 ** -53)])
    a[rng.random(n) < 0.02] = 0.0
    a = np.where(rng.random(n) < 0.02, ends[rng.integers(0, 2, n)], a)
    b = np.where(rng.random(n) < 0.02, ends[rng.integers(0, 2, n)], b)
    return a, b


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_quant_signature_fast_divide_on_card(cuda_device, seed):
    """The kernel's fast-path divide (one correctly rounded reciprocal, a
    faithful product and a Markstein correction) equals IEEE division bit
    for bit, on the card and on the host."""
    a, b = _divide_operands(1 << 21, seed)
    n = quant_signature_divide.launches
    got = quant_signature_divide(torch.as_tensor(a, device=cuda_device),
                                 torch.as_tensor(b, device=cuda_device))
    assert quant_signature_divide.launches == n + 1
    card = torch.as_tensor(a, device=cuda_device) / torch.as_tensor(
        b, device=cuda_device)
    assert torch.equal(got.view(torch.int64), card.view(torch.int64))
    assert np.array_equal(got.cpu().numpy().view(np.int64),
                          (a / b).view(np.int64))


def test_quant_signature_wrapper_refuses_bad_inputs(cuda_device):
    c, _ = _ingest_consts("h1", cuda_device)
    args = [c.bits_pack, c.C_pack, c.mask_pack, c.load_pack, c.modes,
            c.gamma, c.delta]
    vec = torch.ones((4, 5), dtype=torch.float64, device=cuda_device)
    n = quant_signature_rows.launches
    with pytest.raises(ValueError, match="vec"):
        quant_signature_rows(vec.float(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        quant_signature_rows(torch.ones((5, 4), dtype=torch.float64,
                                        device=cuda_device).t(), *args)
    with pytest.raises(ValueError, match="mask"):
        quant_signature_rows(vec, args[0], args[1], args[2].double(),
                             *args[3:])
    with pytest.raises(ValueError, match="one or two"):
        quant_signature_rows(vec, *args[:4], ("floor", "ceil", "round"),
                             *args[5:])
    with pytest.raises(ValueError, match="gamma"):
        quant_signature_rows(vec, *args[:5], 40000, c.delta)
    with pytest.raises(ValueError, match="contiguous"):
        quant_signature_rows(vec, args[0].cpu(), *args[1:])
    assert quant_signature_rows.launches == n


def test_population_on_card_equals_cpu_path(cuda_device):
    """A small h1 cohort through AR(1) ticks, a failure, a slice and a
    backhaul repricing and a checkpoint round trip: incumbents, counters
    and state_dict bytes on CUDA equal the CPU path's, and the ticks
    launched B2 and B1."""
    nw = T.paper_scenario(n_extra_edge=2)
    pf = T.paper_profile("h1")
    req = T.AppRequirements(0.55, 5e-3)
    U = 2048
    pops = [T.Population(nw, pf, req, U, device=dev)
            for dev in (cuda_device, "cpu")]
    rng = np.random.default_rng(5)
    q = rng.uniform(0.3, 1.0, U)
    b2, b1 = quant_signature_rows.launches, banded_minplus_chain.launches

    def same():
        a, b = (p.state_dict() for p in pops)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and \
                a[k].tobytes() == b[k].tobytes(), k
        sa, sb = (dataclasses.asdict(p.stats) for p in pops)
        assert {k: v for k, v in sa.items() if not k.startswith("t_")} == \
            {k: v for k, v in sb.items() if not k.startswith("t_")}
        assert np.array_equal(pops[0].inc_found, pops[1].inc_found)

    for p in pops:
        p.attach_many(1e9 * q)
    same()
    for t in range(5):
        q = np.clip(0.65 + 0.95 * (q - 0.65) + rng.normal(0, 0.1, U),
                    0.3, 1.0)
        chs = [p.ingest(1e9 * q) for p in pops]
        assert np.array_equal(chs[0], chs[1])
        evs = [p.evaluate_incumbents() for p in pops]
        users = np.nonzero(chs[0] | ~evs[0][1])[0]
        for p in pops:
            if t == 2:
                p.mask_node(3, users=np.arange(0, U, 8))
            p.solve(users, build_solutions=False)
        same()
    for p in pops:
        p.update_slice(0.8)
        p.update_backhaul(0.9)
        p.solve(build_solutions=False)
    same()
    snaps = [p.state_dict() for p in pops]
    fresh = [T.Population(nw, pf, req, U, device=dev)
             for dev in (cuda_device, "cpu")]
    for p, d in zip(fresh, snaps):
        p.update_slice(0.8)
        p.update_backhaul(0.9)
        p.restore_state(d)
    pops = fresh
    same()
    assert quant_signature_rows.launches > b2
    assert banded_minplus_chain.launches > b1
    assert pops[0].h2d_bytes > 0 and pops[0].d2h_bytes > 0


def test_churn_orchestrator_on_card_equals_cpu_path(cuda_device):
    """[churn] at 3,000 users: ``population_cohorts(n_extra_edge=2)`` on the
    card through 3 AR(1) ``step_arrays`` ticks, a fresh CUDA twin through
    ``run_arrays(stream=True, stream_overlap="always")`` and the same ticks
    on the CPU path give equal reports (``t_*`` left out), incumbents,
    state counts and counters; the ticks launched B2 and B1.  The fading
    is the heavier one of ``benchmarks/bench_online.py``'s mesh row (mean
    0.5, sigma 0.15), so that at this size users re-solve and re-key."""
    U = 3000
    rng = np.random.default_rng(5)
    q = np.full(U, 0.5)
    draws = []
    for _ in range(3):
        q = np.clip(0.5 + 0.95 * (q - 0.5) + rng.normal(0, 0.15, U),
                    0.3, 1.0)
        draws.append(q.copy())
    b2, b1 = quant_signature_rows.launches, banded_minplus_chain.launches

    def orch(dev):
        return T.ChurnOrchestrator(population=T.population_cohorts(
            U, n_extra_edge=2, device=dev), hysteresis=0.05,
            stream_overlap="always")

    runs = []
    for dev, stream in ((cuda_device, False), (cuda_device, True),
                        ("cpu", False)):
        o = orch(dev)
        reps = (o.run_arrays(np.stack(draws), stream=True) if stream
                else [o.step_arrays(d) for d in draws])
        runs.append((o, [{k: v for k, v in dataclasses.asdict(r).items()
                          if not k.startswith("t_")} for r in reps]))
    (o0, r0) = runs[0]
    for o, r in runs[1:]:
        assert r == r0
        for a, b in zip(o0.pops, o.pops):
            for f in ("inc_found", "_inc_place", "_inc_exit", "_inc_energy"):
                assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
            assert a.n_states == b.n_states
            sa, sb = (dataclasses.asdict(p.stats) for p in (a, b))
            assert {k: v for k, v in sa.items() if not k.startswith("t_")} \
                == {k: v for k, v in sb.items() if not k.startswith("t_")}
    assert runs[1][0]._overlap_used
    assert quant_signature_rows.launches > b2
    assert banded_minplus_chain.launches > b1


# ---------------------------------------------------------------------------
# The branchy CNNs and the training path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,V", [(256, 10), (4096, 10), (133, 10), (7, 9),
                                 (200, 13)])
def test_ee_gate_kernel_at_branchy_shapes_on_card(cuda_device, B, V):
    """B6 at the branchy exits' [B, n_classes]: B above the SM count (one
    row a block) and rows 40 bytes apart, off the 16-byte grid (the
    kernel's scalar head and tail)."""
    assert gate_plan(B, V, sm_count(cuda_device)) >= 1
    x = torch.as_tensor(np.random.default_rng(B).normal(size=(B, V)) * 3,
                        dtype=torch.float32, device=cuda_device)
    n0 = ee_gate.launches
    conf, arg = ee_gate(x)
    assert ee_gate.launches == n0 + 1
    conf_p, arg_p = ee_gate_ref(x)
    torch.testing.assert_close(conf, conf_p, rtol=1e-5, atol=0)
    assert torch.equal(arg, arg_p)


@pytest.mark.parametrize("name,kw", [("b-lenet", {}),
                                     ("b-resnet", {"blocks_per_stage": 2}),
                                     ("b-alexnet", {})])
def test_branchy_forward_and_infer_on_card_equal_cpu_path(cuda_device, name,
                                                          kw):
    """The CNN forward on CUDA within 1e-4 x max|CPU| of the CPU path with
    the caller's TF32 flags turned ON (the model turns them off for its
    own convolutions and matmuls and puts them back), and ``infer``
    launching B6 once an exit."""
    from repro_torch.models.branchy import PAPER_MODELS
    net = PAPER_MODELS[name](**kw).init(seed=3, device=cuda_device)
    cpu = PAPER_MODELS[name](**kw).init(seed=3, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8,) + net.input_shape).astype(np.float32))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            lg, _ = net.apply(x.to(cuda_device))
            lc, _ = cpu.apply(x)
            assert torch.backends.cudnn.allow_tf32
            for b in lc:
                tol = 1e-4 * float(lc[b].abs().max())
                torch.testing.assert_close(lg[b].cpu(), lc[b], rtol=0,
                                           atol=tol)
            n0 = ee_gate.launches
            pg, eg = net.infer(x.to(cuda_device), [0.5] * 3)
            assert ee_gate.launches - n0 == len(net.exit_blocks())
            pc, ec = cpu.infer(x, [0.5] * 3)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    assert torch.equal(eg.cpu(), ec) and torch.equal(pg.cpu(), pc)


def test_train_step_on_card_equals_cpu_path(cuda_device):
    """Three train steps of the reduced qwen3-4b in float32 on CUDA within
    a relative 1e-4 of the CPU path."""
    from repro_torch.runtime import steps as S
    from repro_torch.runtime.train_loop import batch_to
    from repro_torch.data import LMStreamConfig, SyntheticLMStream
    cfg = get("qwen3-4b", reduced=True)
    sg = S.init_train_state(cfg, seed=1, device=cuda_device)
    sc = S.init_train_state(cfg, seed=1, device="cpu")
    for a, b in zip(S.tree_leaves(sg["params"]), S.tree_leaves(sc["params"])):
        b.copy_(a.cpu())
    step = S.build_train_step(cfg)
    stream = SyntheticLMStream(LMStreamConfig(cfg.vocab_size, 32, 4))
    for i in range(3):
        sg, mg = step(sg, batch_to(stream.batch(i), cuda_device))
        sc, mc = step(sc, batch_to(stream.batch(i), "cpu"))
        assert float(mg["loss"]) == pytest.approx(float(mc["loss"]),
                                                  rel=1e-4)
    for a, b in zip(S.tree_leaves(sg["params"]), S.tree_leaves(sc["params"])):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()) + 1e-7)
