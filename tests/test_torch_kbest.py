"""The k-slot banded chain of the PyTorch port (B3) vs the JAX package.

On the CPU the wrapper runs its plain PyTorch version, which must equal the
reference: in float64 bit for bit (distances, par_n, par_k) against the
numpy k-best engine ``batched_banded_relax_kbest``, and in float32 against
the Pallas k-slot kernel in interpret mode (tiny shapes: interpret mode is
slow).  At K = 1 it must equal the plain B1.  The card tests of the
hand-written kernel are in ``test_torch_cuda.py``; here a plain-Python
model of its merge loop is held to a stable sort of the pool, and its
launch plan to the card's limits.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from repro.core.bellman_ford import batched_banded_relax_kbest as ref_kbest
from repro.core.bellman_ford import (batched_banded_relax_kbest_pallas as
                                     ref_kbest_pallas)

from repro_torch.core import bellman_ford as bf
from repro_torch.kernels.minplus import ops
from repro_torch.kernels.minplus.ops import banded_minplus_chain_kbest
from repro_torch.kernels.minplus.ref import (banded_minplus_chain_kbest_ref,
                                             banded_minplus_chain_ref)

# (B, L, N, G) of the reference's kernel tests plus the solver's width
SHAPES = [(1, 1, 4, 3), (3, 4, 7, 10), (5, 2, 9, 25), (16, 4, 5, 25)]


def _problem(B, L, N, Gp1, seed, integer=False):
    """Seeded banded inputs with pruned edges, a duplicated source node and
    (``integer``) integer energies, so equal candidates are common."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, N, Gp1))
    E = rng.uniform(0, 5, (B, L, N, N))
    if integer:
        dist, E = np.floor(dist), np.floor(E)
    dist[rng.uniform(size=dist.shape) < 0.5] = np.inf
    steep = rng.integers(0, Gp1, (B, L, N, N)).astype(np.float64)
    steep[rng.uniform(size=steep.shape) < 0.3] = np.inf
    if N > 1:
        E[:, :, 1], steep[:, :, 1], dist[:, 1] = E[:, :, 0], steep[:, :, 0], \
            dist[:, 0]
    return dist, E, steep


def _port(dist, E, steep, K, lo, dtype=torch.float64):
    return bf.batched_banded_relax_kbest(
        torch.as_tensor(dist), torch.as_tensor(E), torch.as_tensor(steep), K,
        lo, dtype=dtype)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("lo", [None, 2])
@pytest.mark.parametrize("K", [1, 2, 4, 32])
@pytest.mark.parametrize("B,L,N,G", SHAPES)
def test_plain_f64_kbest_bit_equal_to_numpy_engine(B, L, N, G, K, lo,
                                                   integer):
    dist, E, steep = _problem(B, L, N, G + 1, B + L + N + G + K, integer)
    hist_r, pn_r, pk_r = ref_kbest(dist, E, steep, K, lo)
    hist, pn, pk = _port(dist, E, steep, K, lo)
    assert hist.dtype == torch.float64 and pn.dtype == torch.int32
    assert hist.numpy().tobytes() == hist_r.tobytes()
    np.testing.assert_array_equal(pn.numpy(), pn_r)
    np.testing.assert_array_equal(pk.numpy(), pk_r)


@pytest.mark.parametrize("B,L,N,Gp1,K,lo", [(2, 3, 5, 11, 4, None),
                                            (1, 2, 4, 4, 2, 2)])
def test_plain_f32_kbest_equal_to_pallas_interpret(B, L, N, Gp1, K, lo):
    """The reference's Pallas history keeps the float64 init grid at index
    0; every later layer is float32 adds in the same order."""
    dist, E, steep = _problem(B, L, N, Gp1, 40 + K, integer=(K == 2))
    hist_r, pn_r, pk_r = ref_kbest_pallas(dist, E, steep, K, lo)
    hist, pn, pk = _port(dist, E, steep, K, lo, torch.float32)
    assert hist.dtype == torch.float32
    assert hist[:, 1:].double().numpy().tobytes() == hist_r[:, 1:].tobytes()
    np.testing.assert_array_equal(pn.numpy(), pn_r)
    np.testing.assert_array_equal(pk.numpy(), pk_r)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lo", [None, 3])
def test_plain_kbest_at_one_slot_equals_plain_chain(dtype, lo):
    dist, E, steep = _problem(6, 4, 5, 26, 8, integer=True)
    Ek, st = bf.kernel_inputs(torch.as_tensor(E), torch.as_tensor(steep),
                              dtype)
    d = torch.as_tensor(dist).to(dtype)
    hist, pn, pk = banded_minplus_chain_kbest_ref(d, Ek, st, 1, lo=lo)
    h1, p1 = banded_minplus_chain_ref(d, Ek, st, lo=lo)
    assert torch.equal(hist[..., 0], h1) and torch.equal(pn[..., 0], p1)
    assert torch.equal(pk[..., 0], torch.where(p1 >= 0, 0, -1).int())


def test_kbest_slots_are_sorted_and_unused_slots_marked():
    dist, E, steep = _problem(4, 3, 5, 11, 2, integer=True)
    hist, pn, pk = _port(dist, E, steep, 8, None)
    h = hist[:, 1:]
    fin = torch.isfinite(h)
    assert bool((h[..., 1:] >= h[..., :-1]).all())   # ascending, inf last
    assert torch.equal(pn >= 0, fin) and torch.equal(pk >= 0, fin)
    assert bool((pk < 8).all()) and bool((pn < 5).all())


def test_single_block_kbest_returns_init_in_slot_zero():
    init = torch.full((3, 4, 6), float("inf"), dtype=torch.float64)
    init[:, 0, 2] = 1.5
    E = torch.zeros((3, 0, 4, 4), dtype=torch.float64)
    hist, pn, pk = bf.batched_banded_relax_kbest(init, E, E.clone(), 4)
    assert hist.shape == (3, 1, 4, 6, 4) and pn.shape == (3, 0, 4, 6, 4)
    assert torch.equal(hist[:, 0, ..., 0], init)
    assert bool(torch.isinf(hist[..., 1:]).all())


def test_cpu_kbest_wrapper_runs_plain_version_and_counts_nothing():
    dist, E, steep = _problem(2, 2, 3, 5, 1)
    Ek, st = bf.kernel_inputs(torch.as_tensor(E), torch.as_tensor(steep),
                              torch.float64)
    d = torch.as_tensor(dist)
    before = banded_minplus_chain_kbest.launches
    got = banded_minplus_chain_kbest(d, Ek, st, 3)
    want = banded_minplus_chain_kbest_ref(d, Ek, st, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert banded_minplus_chain_kbest.launches == before
    with pytest.raises(ValueError, match="K must be >= 1"):
        banded_minplus_chain_kbest(d, Ek, st, 0)


def _merge_model(runs, K):
    """The B3 kernel's merge loop (``merge_row`` in
    ``csrc/banded_minplus_kbest.cu``) in plain Python.  ``runs[n]`` holds
    source n's K candidates d[n, gs, k] + w (ascending, +inf tail), or is
    None for a source outside the band.  One head per run; at each of the K
    steps the head with the smallest candidate under a strict < in
    ascending n is written as (value, n, slot) and advanced one slot; once
    every head is spent the rest of the row is (inf, -1, -1)."""
    heads = [0] * len(runs)
    c = [math.inf if run is None else run[0] for run in runs]
    row = []
    for _ in range(K):
        best, bn = c[0], 0
        for n in range(1, len(runs)):
            if c[n] < best:
                best, bn = c[n], n
        if not best < math.inf:
            break
        k = heads[bn]
        row.append((best, bn, k))
        heads[bn] = k + 1
        c[bn] = runs[bn][k + 1] if k + 1 < K else math.inf
    return row + [(math.inf, -1, -1)] * (K - len(row))


@hs.composite
def _tied_runs(draw):
    """Up to 8 sources with K sorted integer slots and a +inf tail (the
    k-slot grid of one depth), each with an integer or +inf edge, or out
    of the band: every tie the merge must order."""
    K = draw(hs.integers(1, 8))
    runs = []
    for _ in range(draw(hs.integers(1, 8))):
        if draw(hs.booleans()) and draw(hs.booleans()):
            runs.append(None)
            continue
        finite = draw(hs.integers(0, K))
        slots = sorted(draw(hs.lists(hs.integers(0, 4), min_size=finite,
                                     max_size=finite)))
        w = draw(hs.sampled_from([0.0, 1.0, 2.0, math.inf]))
        runs.append((slots + [math.inf] * (K - finite), w))
    return K, runs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@settings(max_examples=300, deadline=None)
@given(case=_tied_runs())
def test_kernel_merge_model_equals_stable_sort_of_pool(case, dtype):
    K, sources = case
    runs = [None if src is None else
            [dtype(v) + dtype(src[1]) for v in src[0]] for src in sources]
    pool = [(v, n, k) for n, run in enumerate(runs) if run is not None
            for k, v in enumerate(run)]          # node-major, slot-minor
    want = sorted(pool, key=lambda x: x[0])[:K]   # Python's sort is stable
    want = [x if x[0] < math.inf else (math.inf, -1, -1) for x in want]
    want += [(math.inf, -1, -1)] * (K - len(want))
    assert _merge_model(runs, K) == want


@pytest.mark.parametrize("K", [1, 4, 32])
@pytest.mark.parametrize("Gp1", [1, 26, 256])
@pytest.mark.parametrize("N", [1, 5, 32])
def test_kbest_launch_plan_fits_the_card(N, Gp1, K):
    """Every launch of the plan fits a block's shared memory, covers every
    scenario and stays within the block's threads; a shape whose one
    scenario does not fit raises before launch."""
    for dtype in (torch.float64, torch.float32):
        per = ops.kbest_smem_bytes(N, Gp1, K, dtype)
        for B in (1, 7, 1000, 20480):
            if per > ops.MAX_SMEM_BYTES:
                with pytest.raises(ValueError, match="shared memory"):
                    ops.kbest_plan(B, N, Gp1, K, dtype)
                continue
            spb, threads = ops.kbest_plan(B, N, Gp1, K, dtype)
            assert 1 <= spb and spb * per <= ops.MAX_SMEM_BYTES
            assert -(-B // spb) * spb >= B > (-(-B // spb) - 1) * spb
            assert threads % 32 == 0 and threads <= ops.KBEST_THREADS <= 1024
            assert threads >= min(spb * N * Gp1, ops.KBEST_THREADS)


def test_kbest_launch_plan_refuses_k_beyond_packed_heads():
    with pytest.raises(ValueError, match="10 bits"):
        ops.kbest_plan(1, 1, 1, ops.KBEST_MAX_K + 1, torch.float64)
    assert ops.kbest_plan(1, 1, 1, ops.KBEST_MAX_K, torch.float32) == (1, 32)
