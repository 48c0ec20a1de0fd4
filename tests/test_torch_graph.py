"""Graph construction of the PyTorch port vs the JAX package's reference.

The port's extended-graph tensors (C/T/E/TT/mask/init_*), its feasible-
graph steepness and init depths, and its banded init grids must be byte
for byte equal to the reference's numpy arrays: for the six paper apps,
gamma in {3, 10, 25}, every quantizer, on the paper scenario and with two
extra edge nodes (N = 5).  The batched builders must equal the per-scenario
ones.  Everything runs on the CPU (``device="cpu"``).
"""
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.bellman_ford import _banded_gather_idx as ref_gather_idx
from repro.core.feasible_graph import (batch_banded_tensors as
                                       ref_batch_banded)
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.core.scenarios import sweep_scenarios as ref_sweep

import repro_torch as T
from repro_torch.convert import network_from, profile_from, scenarios_from
from repro_torch.core.bellman_ford import _banded_gather_idx
from repro_torch.core.feasible_graph import _quant_raw, batch_banded_tensors

APPS = ("h1", "h2", "h3", "h4", "h5", "h6")
EXT_FIELDS = ("C", "T", "E", "TT", "mask", "init_T", "init_E", "init_mask")
CPU = "cpu"


def _bytes_equal(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    got = got.cpu().numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


def _scenario(n_extra_edge):
    ref = ref_paper_scenario(n_extra_edge=n_extra_edge)
    return ref, network_from(ref)


@pytest.mark.parametrize("n_extra_edge", [0, 2])
@pytest.mark.parametrize("app", APPS)
def test_extended_graph_bytes_equal(app, n_extra_edge):
    ref_nw, nw = _scenario(n_extra_edge)
    ref_pf = R.paper_profile(app)
    for sigma in (1.0, 7.5):
        ref_req = R.AppRequirements(0.5, 5e-3, sigma)
        req = T.convert.requirements_from(0.5, 5e-3, sigma)
        want = R.build_extended_graph(ref_nw, ref_pf, ref_req)
        got = T.build_extended_graph(nw, profile_from(ref_pf), req, device=CPU)
        for f in EXT_FIELDS:
            _bytes_equal(getattr(got, f), getattr(want, f), f)
        for f in ("surv_in", "surv_out", "acc_seq"):
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f


@pytest.mark.parametrize("quantize", ["floor", "ceil", "round"])
@pytest.mark.parametrize("gamma", [3, 10, 25])
@pytest.mark.parametrize("n_extra_edge", [0, 2])
@pytest.mark.parametrize("app", APPS)
def test_feasible_graph_bytes_equal(app, n_extra_edge, gamma, quantize):
    ref_nw, nw = _scenario(n_extra_edge)
    ref_pf = R.paper_profile(app)
    pf = profile_from(ref_pf)
    for delta in (1e-3, 5e-3, 12e-3):
        ref_req = R.AppRequirements(0.5, delta)
        req = T.convert.requirements_from(0.5, delta)
        ref_ext = R.build_extended_graph(ref_nw, ref_pf, ref_req)
        ext = T.build_extended_graph(nw, pf, req, device=CPU)
        for d_eff in (None, 0.85 * delta):
            want = R.build_feasible_graph(ref_ext, gamma, quantize=quantize,
                                          delta_eff=d_eff)
            got = T.build_feasible_graph(ext, gamma, quantize=quantize,
                                         delta_eff=d_eff)
            _bytes_equal(got.steep, want.steep, "steep")
            _bytes_equal(got.init_depth, want.init_depth, "init_depth")
            _bytes_equal(got.init_grid(), want.init_grid(), "init_grid")
            assert got.delta_eff == want.delta_eff
            assert got.depth_window_lo == want.depth_window_lo


@pytest.mark.parametrize("lam", [None, 4])
def test_lambda_window_and_batched_banded_tensors(lam):
    ps, ns, rs = ref_sweep(apps=("h2", "h6"), deltas_ms=(2.0, 8.0),
                           n_extra_edge=2)
    tp, tn, tr = scenarios_from(ps, ns, rs)
    ref_fgs = R.build_feasible_graphs(R.build_extended_graphs(ns, ps, rs), 10,
                                      lam=lam)
    fgs = T.build_feasible_graphs(T.build_extended_graphs(tn, tp, tr,
                                                          device=CPU),
                                  10, lam=lam)
    for start in (0, 2):                 # one shape group each (h2 / h6)
        want = ref_batch_banded(ref_fgs[start:start + 2])
        got = batch_banded_tensors(fgs[start:start + 2])
        for g, w, what in zip(got, want, ("E", "steep", "init")):
            _bytes_equal(g, w, what)
        assert fgs[start].depth_window_lo == ref_fgs[start].depth_window_lo


def test_batched_extended_graphs_match_per_scenario():
    ps, ns, rs = ref_sweep(deltas_ms=(2.0, 5.0), uplinks_bps=(1e9, 0.5e9),
                           n_extra_edge=2)
    tp, tn, tr = scenarios_from(ps, ns, rs)
    exts = T.build_extended_graphs(tn, tp, tr, device=CPU)
    ref_exts = R.build_extended_graphs(ns, ps, rs)
    # duplicates (same network/profile/sigma) share one object, as in the
    # reference
    assert len({id(e) for e in exts}) == len({id(e) for e in ref_exts})
    assert len({id(e) for e in exts}) < len(exts)
    for pf, nw, rq, eb, er in zip(tp, tn, tr, exts, ref_exts):
        ea = T.build_extended_graph(nw, pf, rq, device=CPU)
        for f in EXT_FIELDS:
            assert torch.equal(getattr(ea, f), getattr(eb, f)), f
            _bytes_equal(getattr(eb, f), getattr(er, f), f)


def test_batched_feasible_graphs_match_per_scenario():
    ps, ns, rs = ref_sweep(apps=("h2", "h6"), deltas_ms=(2.0, 8.0))
    tp, tn, tr = scenarios_from(ps, ns, rs)
    exts = T.build_extended_graphs(tn, tp, tr, device=CPU)
    for quantize in ("floor", "ceil", "round"):
        fgs = T.build_feasible_graphs(exts, 10, quantize=quantize)
        for ext, fgb in zip(exts, fgs):
            fga = T.build_feasible_graph(ext, 10, quantize=quantize)
            assert torch.equal(fga.steep, fgb.steep)
            assert torch.equal(fga.init_depth, fgb.init_depth)
    # per-scenario delta_eff override (the tighten loop's path)
    fgs = T.build_feasible_graphs(exts[:2], 10, delta_effs=[1e-3, 3e-3])
    for fg, d in zip(fgs, (1e-3, 3e-3)):
        one = T.build_feasible_graph(fg.ext, 10, delta_eff=d)
        assert torch.equal(one.steep, fg.steep)


def test_quantizer_matches_numpy_incl_half_to_even_and_nonfinite():
    x = np.array([0.0, 0.5, 1.5, 2.5, 2.0 - 1e-13, 3.0 + 1e-13, 7.25,
                  np.inf, np.nan, 1e-300])
    from repro.core.feasible_graph import _quant as ref_quant
    from repro_torch.core.feasible_graph import _quant
    for mode in ("floor", "ceil", "round"):
        got = _quant(torch.as_tensor(x), mode).numpy()
        assert got.tobytes() == ref_quant(x, mode).tobytes(), mode
    with pytest.raises(ValueError, match="quantize"):
        _quant_raw(torch.as_tensor(x), "nearest")


@pytest.mark.parametrize("lo", [None, 3])
def test_gather_idx_matches_reference(lo):
    rng = np.random.default_rng(11)
    steep = rng.integers(0, 12, (2, 3, 5, 5)).astype(np.float64)
    steep[rng.uniform(size=steep.shape) < 0.3] = np.inf
    want = ref_gather_idx(steep, 11, lo)
    got = _banded_gather_idx(torch.as_tensor(steep), 11, lo)
    _bytes_equal(got, want, "idx")


def test_single_block_profile_graph():
    """A one-block chain has no transitions: empty E/steep, init grid only."""
    ref_pf = R.synthetic_profile(1, 1, seed=3)
    ref_nw, nw = _scenario(0)
    ref_req = R.AppRequirements(0.0, 5e-3)
    want = R.build_feasible_graph(R.build_extended_graph(ref_nw, ref_pf,
                                                         ref_req), 10)
    got = T.build_feasible_graph(
        T.build_extended_graph(nw, profile_from(ref_pf),
                               T.convert.requirements_from(0.0, 5e-3),
                               device=CPU), 10)
    _bytes_equal(got.steep, want.steep, "steep")
    _bytes_equal(got.init_grid(), want.init_grid(), "init_grid")


def test_invalid_gamma_and_lam_raise():
    ref_nw, nw = _scenario(0)
    ext = T.build_extended_graph(nw, profile_from(R.paper_profile("h6")),
                                 T.convert.requirements_from(0.5, 5e-3),
                                 device=CPU)
    with pytest.raises(ValueError, match="gamma"):
        T.build_feasible_graph(ext, 0)
    with pytest.raises(ValueError, match="lam"):
        T.build_feasible_graph(ext, 5, lam=6)
