"""The dense flattened-state FIN path of the PyTorch port vs the JAX package.

Each test hands the same seeded numpy inputs to the reference and to the
port's CPU path.  Tolerances, stated per test:

  * the plain versions of B5 / B4 (and the ``ops`` wrappers on the CPU) in
    float32 against the Pallas kernels in interpret mode
    (``minplus_vecmat`` / ``minplus_vecmat_argmin`` / ``minplus_matmat``):
    values bit-equal and argmins identical -- both do one float32 add per
    candidate, the min does not depend on order, and both take the first
    occurrence; on sparse dists (90% +inf, -inf and NaN entries, ties
    between a skipped and a kept source) too, and in float64 against the
    reference's numpy engine with the missing entries made +inf;
  * the dense graph tensors: byte-equal;
  * the float64 dense engines against the reference's numpy ones:
    bit-equal (one IEEE add per candidate, first-occurrence argmin, a
    stable sort for k-best);
  * ``solve_fin`` / ``solve_many`` with ``dense`` / ``numpy`` / ``python``:
    identical Solutions (configuration, every ConfigEval field, meta apart
    from timings);
  * ``fin_all_exit_costs``: ``numpy`` and ``banded`` bit-equal to the
    reference's; ``f32`` within RELAX_RTOL_F32 of the reference's
    ``pallas``.

The card tests of the hand-written kernels are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import bellman_ford as rbf
from repro.core.extended_graph import build_extended_graphs as ref_exts
from repro.core.feasible_graph import batch_layer_tensors as ref_blt
from repro.core.feasible_graph import build_feasible_graphs as ref_fgs
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.core.scenarios import sweep_scenarios as ref_sweep
from repro.kernels.minplus import ops as rops

import repro_torch as T
from repro_torch.convert import (network_from, profile_from,
                                 requirements_from, scenarios_from)
from repro_torch.core import bellman_ford as bf
from repro_torch.core.extended_graph import build_extended_graphs
from repro_torch.core.feasible_graph import (batch_layer_tensors,
                                             build_feasible_graphs)
from repro_torch.core.tolerances import RELAX_RTOL_F32
from repro_torch.kernels.minplus import ops
from repro_torch.kernels.minplus.ref import minplus_argmin_ref, minplus_ref

from test_torch_fin import APPS, CPU, assert_same

# (B, S, T) of the reference's dense kernel tests (tests/test_kernels.py)
DENSE_SHAPES = [(1, 16, 16), (8, 128, 128), (3, 37, 65), (16, 300, 129),
                (2, 1, 257)]


def _dense_inputs(B, S, T, density, seed, special=True):
    """The reference test's inputs (uniform dist with 10% missing, W with
    ``1 - density`` missing), plus a -inf and a NaN entry (both missing)."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, S)).astype(np.float32)
    W = rng.uniform(0, 5, (S, T)).astype(np.float32)
    W[rng.uniform(size=W.shape) > density] = np.inf
    dist[rng.uniform(size=dist.shape) > 0.9] = np.inf
    if special:
        W[0, 0] = -np.inf
        dist[-1, -1] = np.nan
    return dist, W


def _same_bits(a: torch.Tensor, b: np.ndarray) -> bool:
    a = a.numpy()
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("density", [1.0, 0.4])
@pytest.mark.parametrize("B,S,T", DENSE_SHAPES)
def test_minplus_f32_bit_equal_to_pallas(B, S, T, density):
    dist, W = _dense_inputs(B, S, T, density, B * 1000 + S + T)
    want = np.asarray(rops.minplus_vecmat(jnp.asarray(dist), jnp.asarray(W)))
    d, w = torch.as_tensor(dist), torch.as_tensor(W)
    assert _same_bits(minplus_ref(d, w), want)
    assert _same_bits(ops.minplus_vecmat(d, w), want)
    # the per-row form with every row's matrix equal to W
    assert _same_bits(ops.minplus_vecmat(d, w.expand(B, S, T).clone()), want)


@pytest.mark.parametrize("density", [1.0, 0.4])
@pytest.mark.parametrize("B,S,T", DENSE_SHAPES)
def test_minplus_argmin_f32_bit_equal_to_pallas(B, S, T, density):
    dist, W = _dense_inputs(B, S, T, density, B * 999 + S + T)
    # a tie on every target: source 1 repeats source 0
    if S > 1:
        dist[:, 1], W[1] = dist[:, 0], W[0]
    out, arg = rops.minplus_vecmat_argmin(jnp.asarray(dist), jnp.asarray(W))
    out, arg = np.asarray(out), np.asarray(arg)
    d, w = torch.as_tensor(dist), torch.as_tensor(W)
    for got, got_arg in (minplus_argmin_ref(d, w),
                         ops.minplus_vecmat_argmin(d, w)):
        assert _same_bits(got, out) and _same_bits(got_arg, arg)
    assert (arg >= 0).any() and (arg[~np.isfinite(out)] == -1).all()


def test_minplus_matmat_equals_pallas_and_is_associative():
    rng = np.random.default_rng(7)
    A = rng.uniform(0, 5, (17, 33)).astype(np.float32)
    B = rng.uniform(0, 5, (33, 21)).astype(np.float32)
    B[rng.uniform(size=B.shape) < 0.3] = np.inf
    C = rng.uniform(0, 5, (21, 9)).astype(np.float32)
    want = np.asarray(rops.minplus_matmat(jnp.asarray(A), jnp.asarray(B)))
    a, b, c = (torch.as_tensor(x) for x in (A, B, C))
    ab = ops.minplus_matmat(a, b)
    assert _same_bits(ab, want)
    left = ops.minplus_matmat(ab, c)
    right = ops.minplus_matmat(a, ops.minplus_matmat(b, c))
    # tropical associativity: a different association order rounds
    # differently in float32, so compare to the reference test's 1e-5
    m = torch.isfinite(left)
    assert torch.equal(m, torch.isfinite(right))
    torch.testing.assert_close(left[m], right[m], rtol=1e-5, atol=0)
    ident = torch.full((33, 33), float("inf"))
    ident.fill_diagonal_(0.0)
    assert torch.equal(ops.minplus_matmat(a, ident), a)


def test_minplus_wrappers_raise_on_bad_inputs():
    d = torch.zeros(4, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64 or float32"):
        ops.minplus_vecmat(d, torch.zeros(8, 3, dtype=torch.float32))
    with pytest.raises(ValueError, match="W must be"):
        ops.minplus_vecmat_argmin(d, torch.zeros(7, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.minplus_vecmat(d, torch.zeros(3, 8, dtype=torch.float64).t())
    with pytest.raises(ValueError, match="S >= 1"):
        ops.minplus_vecmat(d[:, :0], torch.zeros(0, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="device"):
        ops.minplus_vecmat(d.to("meta"), torch.zeros(8, 3, device="meta",
                                                     dtype=torch.float64))


@pytest.mark.parametrize("B,S,T,shared", [(1, 165, 165, False),
                                          (1, 390, 390, False),
                                          (20480, 130, 130, False),
                                          (16, 300, 129, True),
                                          (64, 130, 130, True),
                                          (2, 1, 257, True),
                                          (4, 390, 390, True)])
def test_dense_plan_covers_the_sms(B, S, T, shared):
    """B5 / B4's launch plan: a Table VII layer (B = 1, S = T = 165 and
    390) covers at least half of the 132 SMs through source slices merged
    over a cluster of at most 16; a large batch keeps one block per (row
    group, target tile) and the whole source range (Q = 1: 160 threads a
    row at 20,480 x 130 x 130); no slice is empty."""
    per, Q = ops.dense_plan(B, S, T, shared, 132)
    tiles = -(-T // per)
    groups = -(-B // (ops.DENSE_SHARED_ROWS if shared else 1))
    assert 1 <= per <= ops.DENSE_MAX_THREADS and 1 <= Q <= 16
    slice_ = -(-S // Q)
    assert (Q - 1) * slice_ < S
    if B == 1:
        assert groups * tiles * Q >= 66
    if B == 20480:
        assert (per, Q) == (130, 1)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("B,S,T", [(1, 165, 165), (1, 390, 390),
                                   (4, 37, 65)])
def test_sliced_minplus_fold_equals_the_unsplit_product(B, S, T, per_row):
    """The kernel's split on the CPU: the plain product of each of the
    plan's source slices, folded in ascending slice order with a strict <,
    gives the unsplit values and first argmins bit for bit, with a tie
    between the last source of one slice and the first of the next."""
    _, Q = ops.dense_plan(B, S, T, not per_row and B > 1, 132)
    step = -(-S // Q)
    rng = np.random.default_rng(S + T)
    dist = rng.uniform(0, 10, (B, S))
    dist[rng.uniform(size=dist.shape) < 0.9] = np.inf
    dist[:, [step - 1, step]] = 0.5        # kept on both sides of a cut
    W = _tied_w((B, S, T) if per_row else (S, T), S * T)
    W[..., step, :] = W[..., step - 1, :]
    dist, W = torch.as_tensor(dist), torch.as_tensor(W)
    best = torch.full((B, T), float("inf"), dtype=dist.dtype)
    arg = torch.full((B, T), -1, dtype=torch.int32)
    for lo in range(0, S, step):
        v, a = minplus_argmin_ref(dist[:, lo:lo + step].contiguous(),
                                  W[..., lo:lo + step, :].contiguous())
        take = v < best
        best = torch.where(take, v, best)
        arg = torch.where(take, a + lo, arg)
    want, want_arg = minplus_argmin_ref(dist, W)
    assert Q > 1 and torch.equal(best, want) and torch.equal(arg, want_arg)
    assert bool((arg == step - 1).any()) and not bool((arg == step).any())
    assert torch.equal(minplus_ref(dist, W), want)


def _sparse_dist(B, S, seed, special=True):
    """A dist the solver's layers give B4: 90% +inf, a row with no finite
    entry (row 0), a row whose only finite source is the last (row 1); with
    ``special``, -inf and NaN entries (row 2) and, on every row, a skipped
    source 3 (dist -inf; +inf without ``special``) that ties the kept
    source 4 and a kept source 5 that ties source 4 too (their W rows are
    made equal by the caller)."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, S))
    dist[rng.uniform(size=dist.shape) < 0.9] = np.inf
    dist[:, 3] = -np.inf if special else np.inf
    dist[:, 4] = dist[:, 5] = 1.0
    dist[0] = np.inf
    dist[1] = np.inf
    dist[1, -1] = 2.0
    if special:
        dist[2, ::3] = -np.inf
        dist[2, 1::3] = np.nan
    return dist


def _tied_w(shape, seed):
    """W with 40% missing edges whose source rows 3, 4 and 5 are equal."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(0, 5, shape)
    W[rng.uniform(size=W.shape) > 0.6] = np.inf
    W[..., 3, :] = W[..., 5, :] = W[..., 4, :]
    return W


SPARSE_SHAPES = [(5, 37, 65), (16, 130, 130), (4, 300, 129)]


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("B,S,T", SPARSE_SHAPES)
def test_minplus_argmin_on_sparse_dist_equals_numpy_engine(B, S, T, per_row):
    """Float64, bit for bit: the plain B4 (and its wrapper) on a sparse
    dist with -inf / NaN entries equals the reference's numpy engine on the
    same dist with its missing entries made +inf; the skipped source 3
    never wins its tie, and the kept 4 beats its twin 5 (but on row 2,
    where 4 is NaN)."""
    dist = _sparse_dist(B, S, B + S + T)
    W = _tied_w((B, S, T) if per_row else (S, T), B * S + T)
    clean = np.where(np.isfinite(dist), dist, np.inf)
    d, w = torch.as_tensor(dist), torch.as_tensor(W)
    for out, arg in (minplus_argmin_ref(d, w),
                     ops.minplus_vecmat_argmin(d, w)):
        for b in range(B):
            want, want_arg = rbf.minplus_vecmat_np(clean[b],
                                                   W[b] if per_row else W)
            assert _same_bits(out[b], want)
            reached = np.isfinite(want)
            assert np.array_equal(arg[b].numpy()[reached], want_arg[reached])
            assert (arg[b].numpy()[~reached] == -1).all()
        assert (arg[0] == -1).all() and set(arg[1].tolist()) <= {-1, S - 1}
        rest = arg[[b for b in range(B) if b != 2]]   # row 2: 4 is NaN
        assert not (rest == 3).any() and not (rest == 5).any()


@pytest.mark.parametrize("B,S,T", SPARSE_SHAPES)
def test_minplus_argmin_on_sparse_dist_f32_bit_equal_to_pallas(B, S, T):
    """Float32 with the -inf / NaN entries as they are: the plain B4 equals
    the reference's Pallas kernel in interpret mode, values and argmins."""
    dist = _sparse_dist(B, S, B + S + T + 1).astype(np.float32)
    W = _tied_w((S, T), B + T).astype(np.float32)
    out, arg = rops.minplus_vecmat_argmin(jnp.asarray(dist), jnp.asarray(W))
    got, got_arg = minplus_argmin_ref(torch.as_tensor(dist),
                                      torch.as_tensor(W))
    assert _same_bits(got, np.asarray(out))
    assert _same_bits(got_arg, np.asarray(arg))


@pytest.mark.parametrize("B,L,S", [(6, 3, 37), (8, 2, 130)])
def test_batched_dense_engines_on_sparse_init_bit_equal(B, L, S):
    """The batched dense engines (B4's and B5's callers) from a sparse init
    equal the reference's numpy engines bit for bit, parents included."""
    init = _sparse_dist(B, S, B + L + S, special=False)
    Ws = np.ascontiguousarray(_tied_w((B, L, S, S), B * L + S))
    hist_r, par_r = rbf.batched_layered_relax_argmin(init, Ws, "numpy")
    hist, par = bf.batched_layered_relax_argmin(torch.as_tensor(init),
                                                torch.as_tensor(Ws))
    assert _same_bits(hist, hist_r)
    assert np.array_equal(par.numpy(), par_r)
    assert _same_bits(bf.batched_layered_relax_min(torch.as_tensor(init),
                                                   torch.as_tensor(Ws)),
                      rbf.batched_layered_relax_min(init, Ws))
    assert (par[0, 0] == -1).all()


# ---------------------------------------------------------------------------
# dense graph tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam", [None, 3])
@pytest.mark.parametrize("app", APPS)
def test_dense_graph_tensors_byte_equal(app, lam):
    ps, ns, rs = ref_sweep(apps=(app,), deltas_ms=(1.5, 6.0),
                           uplinks_bps=(0.4e9, 2e9), n_extra_edge=2)
    tp, tn, tr = scenarios_from(ps, ns, rs)
    for gamma in (5, 25):
        for q in ("floor", "ceil"):
            want = ref_fgs(ref_exts(ns, ps, rs), gamma, lam=lam, quantize=q)
            got = build_feasible_graphs(
                build_extended_graphs(tn, tp, tr, device=CPU), gamma, lam=lam,
                quantize=q)
            for w, g in zip(want, got):
                assert _same_bits(g.layer_matrices(), w.layer_matrices())
                assert _same_bits(g.init_vector(), w.init_vector())
                assert (g.n_vertices, g.n_edges) == (w.n_vertices, w.n_edges)
            Ws, init = batch_layer_tensors(got)
            Wr, ir = ref_blt(want)
            assert _same_bits(Ws, np.ascontiguousarray(Wr))
            assert _same_bits(init, ir)


def test_batch_layer_tensors_refuses_mixed_shapes():
    ps, ns, rs = T.sweep_scenarios(apps=("h1", "h5"), deltas_ms=(5.0,),
                                   uplinks_bps=(1e9,))
    fgs = T.build_feasible_graphs(T.build_extended_graphs(ns, ps, rs,
                                                          device=CPU), 10)
    with pytest.raises(ValueError, match="shape group"):
        batch_layer_tensors(fgs)


# ---------------------------------------------------------------------------
# dense engines (float64, bit-equal to the reference's numpy engines)
# ---------------------------------------------------------------------------

def _graph_stack(gamma=10, lam=None, apps=("h2",)):
    """Reference (Ws, init) of a sweep's same-shape group, and the port's
    tensors of the same bytes."""
    ps, ns, rs = ref_sweep(apps=apps, deltas_ms=(2.0, 8.0),
                           uplinks_bps=(0.5e9, 1e9), n_extra_edge=2)
    Ws, init = ref_blt(ref_fgs(ref_exts(ns, ps, rs), gamma, lam=lam))
    Ws = np.ascontiguousarray(Ws)
    return Ws, init, torch.as_tensor(Ws), torch.as_tensor(init)


@pytest.mark.parametrize("lam", [None, 4])
def test_batched_layered_relax_argmin_and_min_bit_equal(lam):
    Ws, init, tWs, tinit = _graph_stack(lam=lam)
    hist_r, par_r = rbf.batched_layered_relax_argmin(init, Ws, "numpy")
    hist, par = bf.batched_layered_relax_argmin(tinit, tWs)
    assert _same_bits(hist, hist_r)
    assert np.array_equal(par.numpy(), par_r) and par.dtype == torch.int32
    assert _same_bits(bf.batched_layered_relax_min(tinit, tWs),
                      rbf.batched_layered_relax_min(init, Ws))
    h1, p1 = bf.layered_relax_argmin(tinit[0], tWs[0], backend="dense")
    h1r, p1r = rbf.layered_relax_argmin(init[0], Ws[0])
    assert _same_bits(h1, h1r) and np.array_equal(p1.numpy(), p1r)


@pytest.mark.parametrize("backend", ["numpy", "dense"])
def test_layered_relax_bit_equal(backend):
    Ws, init, tWs, tinit = _graph_stack(gamma=25)
    for b in range(len(init)):
        assert _same_bits(bf.layered_relax(tinit[b], tWs[b], backend),
                          rbf.layered_relax(init[b], Ws[b], "numpy"))


def test_layered_relax_f32_equals_jnp_and_pallas():
    """Float32 relaxation: the reference's jnp and pallas engines do one
    float32 add per candidate too, so the values are equal bit for bit.
    (Its pallas histories keep the float64 init as row 0; the relaxation
    starts from its float32 cast, as the port's does.)"""
    Ws, init, tWs, tinit = _graph_stack(gamma=10)
    got = bf.layered_relax(tinit[0], tWs[0], "f32")
    assert got.dtype == torch.float32
    assert _same_bits(got, rbf.layered_relax(init[0], Ws[0], "jnp"))
    pallas = rbf.layered_relax(init[0], Ws[0], "pallas")
    assert np.array_equal(got[1:].double().numpy(), pallas[1:])
    hist, par = bf.batched_layered_relax_argmin(tinit[:2], tWs[:2], "f32")
    hr, pr = rbf.batched_layered_relax_argmin(init[:2], Ws[:2], "pallas")
    assert np.array_equal(hist[:, 1:].double().numpy(), hr[:, 1:])
    assert np.array_equal(hist[:, 0].numpy(), init[:2].astype(np.float32))
    assert np.array_equal(par.numpy(), pr)


@pytest.mark.parametrize("K", [1, 3])
def test_batched_layered_relax_kbest_bit_equal(K):
    Ws, init, tWs, tinit = _graph_stack(gamma=5, lam=3)
    want = rbf.batched_layered_relax_kbest(init, Ws, K)
    got = bf.batched_layered_relax_kbest(tinit, tWs, K)
    assert _same_bits(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), w) and g.dtype == torch.int32


def test_dense_engines_with_one_block_chain():
    init = torch.rand(3, 12, dtype=torch.float64)
    Ws = torch.zeros((3, 0, 12, 12), dtype=torch.float64)
    hist, par = bf.batched_layered_relax_argmin(init, Ws)
    assert torch.equal(hist[:, 0], init) and par.shape == (3, 0, 12)
    assert torch.equal(bf.batched_layered_relax_min(init, Ws)[:, 0], init)
    h, ps, pk = bf.batched_layered_relax_kbest(init, Ws, 2)
    assert h.shape == (3, 1, 12, 2) and ps.shape == pk.shape == (3, 0, 12, 2)
    with pytest.raises(ValueError, match="backend"):
        bf.layered_relax(init[0], Ws[0], "pallas")


@pytest.mark.parametrize("seed", range(4))
def test_minplus_vecmat_and_bellman_ford_bit_equal(seed):
    rng = np.random.default_rng(seed)
    S = 23
    W = rng.uniform(0, 5, (S, S))
    W[rng.uniform(size=W.shape) < 0.7] = np.inf
    W[:, 3] = W[:, 2]                     # ties between two targets
    dist = rng.uniform(0, 10, S)
    dist[rng.uniform(size=S) < 0.3] = np.inf
    out_r, arg_r = rbf.minplus_vecmat_np(dist, W)
    out, arg = bf.minplus_vecmat(torch.as_tensor(dist), torch.as_tensor(W))
    assert _same_bits(out, out_r)
    reached = np.isfinite(out_r)
    assert np.array_equal(arg.numpy()[reached], arg_r[reached])
    assert (arg.numpy()[~reached] == -1).all()
    for it in (None, 3):
        d_r, p_r = rbf.bellman_ford_np(W, seed, max_iters=it)
        d, p = bf.bellman_ford(torch.as_tensor(W), seed, max_iters=it)
        assert _same_bits(d, d_r) and np.array_equal(p.numpy(), p_r)


@pytest.mark.parametrize("lo", [None, 4])
def test_banded_parent_np_equal(lo):
    rng = np.random.default_rng(5)
    N, Gp1 = 5, 11
    dist = rng.uniform(0, 10, (N, Gp1))
    dist[rng.uniform(size=dist.shape) < 0.3] = np.inf
    E = rng.uniform(0, 5, (N, N))
    st = rng.integers(0, 4, (N, N)).astype(np.float64)
    st[rng.uniform(size=st.shape) < 0.2] = np.inf
    E[1], st[1], dist[1] = E[0], st[0], dist[0]          # ties
    for n in range(N):
        for g in range(Gp1):
            assert bf.banded_parent_np(dist, E, st, n, g, lo) == \
                rbf.banded_parent_np(dist, E, st, n, g, lo)


# ---------------------------------------------------------------------------
# the solver's dense / numpy / python backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", ["floor", "ceil"])
@pytest.mark.parametrize("n_best", [1, 3])
@pytest.mark.parametrize("backend", ["dense", "numpy", "python"])
def test_solve_many_matches_reference_backend(backend, n_best, quantize):
    ps, ns, rs = ref_sweep(deltas_ms=(2.0, 8.0), uplinks_bps=(1e9, 0.5e9),
                           n_extra_edge=2)
    tp, tn, tr = scenarios_from(ps, ns, rs)
    for gamma, lam in ((3, None), (10, 6)):
        want = R.solve_many(ps, ns, rs, gamma=gamma, lam=lam,
                            quantize=quantize, n_best=n_best, backend=backend)
        got = T.solve_many(tp, tn, tr, gamma=gamma, lam=lam,
                           quantize=quantize, n_best=n_best, backend=backend,
                           device=CPU)
        assert len(got) == len(want) == 24
        for w, g in zip(want, got):
            assert_same(w, g)


@pytest.mark.parametrize("backend", ["dense", "python"])
@pytest.mark.parametrize("app", APPS)
def test_solve_fin_matches_reference_backend(app, backend):
    ref_nw = ref_paper_scenario()
    nw = network_from(ref_nw)
    ref_pf = R.paper_profile(app)
    pf = profile_from(ref_pf)
    alpha = min(e.accuracy for e in ref_pf.exits)
    for gamma in (3, 10):
        for delta in (2e-3, 12e-3):
            for n_best in (1, 3):
                want = R.solve_fin(ref_nw, ref_pf, R.AppRequirements(alpha,
                                                                     delta),
                                   gamma=gamma, n_best=n_best,
                                   backend=backend)
                got = T.solve_fin(nw, pf, requirements_from(alpha, delta),
                                  gamma=gamma, n_best=n_best, backend=backend,
                                  device=CPU)
                assert_same(want, got)


@pytest.mark.parametrize("backend", ["dense", "python"])
def test_plan_solve_matches_reference_backend(backend):
    ref_nw = ref_paper_scenario(n_extra_edge=2)
    ref_pf = R.paper_profile("h3")
    ref_req = R.AppRequirements(0.55, 4e-3)
    want = R.Plan(ref_nw, ref_pf, ref_req, gamma=10, backend=backend)
    got = T.Plan(network_from(ref_nw), profile_from(ref_pf),
                 requirements_from(0.55, 4e-3), gamma=10, backend=backend,
                 device=CPU)
    assert_same(want.solve(), got.solve(), meta=False)
    want.update_uplink(0.3e9)
    got.update_uplink(0.3e9)
    assert_same(want.solve(), got.solve(), meta=False)


# ---------------------------------------------------------------------------
# fin_all_exit_costs: the Table VII scaling path
# ---------------------------------------------------------------------------

def _table7_small():
    tiers = ("mobile",) + ("edge",) * 5 + ("cloud",)
    ref = (R.make_network(tiers, compute_frac=[1e-3] * 7),
           R.synthetic_profile(6, 4, seed=0, ops_scale=5e7),
           R.AppRequirements(alpha=0.0, delta=20e-3))
    return ref, (network_from(ref[0]), profile_from(ref[1]),
                 requirements_from(0.0, 20e-3))


@pytest.mark.parametrize("backend", ["numpy", "banded"])
@pytest.mark.parametrize("gamma", [10, 25])
def test_fin_all_exit_costs_bit_equal(gamma, backend):
    ref, port = _table7_small()
    want = R.fin_all_exit_costs(*ref, gamma=gamma, backend=backend)
    got = T.fin_all_exit_costs(*port, gamma=gamma, backend=backend,
                               device=CPU)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == T.fin_all_exit_costs(*port, gamma=gamma,
                                                 device=CPU).tobytes()


def test_fin_all_exit_costs_f32_within_tolerance_of_pallas():
    ref, port = _table7_small()
    want = R.fin_all_exit_costs(*ref, gamma=10, backend="pallas")
    got = T.fin_all_exit_costs(*port, gamma=10, backend="f32", device=CPU)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=RELAX_RTOL_F32, atol=0)
    with pytest.raises(ValueError, match="backend"):
        T.fin_all_exit_costs(*port, gamma=10, backend="pallas", device=CPU)
