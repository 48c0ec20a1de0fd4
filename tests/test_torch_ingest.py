"""The population tick's fused ingest (B2) of the PyTorch port vs the
reference's numpy oracle.

``quant_signature`` maps (Us, N) float64 bandwidth rows to the (Us,
M*(2L-1)*N) int16 signature rows a cohort keys on.  Its plain PyTorch
version (what the CPU path runs, and what the CUDA kernel is held to on
the card) and the port's numpy oracle must be byte-equal to the
reference's ``quant_signature_np`` on rows built to hit every edge: zero,
NaN, +-inf and negative bandwidths, masked link slots, loads above the
bandwidth, quantized values above gamma, values one ulp either side of an
integer and exact .5 ties (round mode), with both quantizer modes, with
the tighten loop's single-mode constants at a Python ``delta_eff``, and at
Us = 0, 1 and 4097.  The reference's jnp path is not run (it raises on the
installed jax).  Everything runs on the CPU.
"""
import ctypes

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.multiapp import PAPER_MULTIAPP_REQS
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.kernels.ee_gate.population import QuantConsts as RefConsts
from repro.kernels.ee_gate.population import \
    quant_signature_np as ref_signature_np

import repro_torch as T
from repro_torch.convert import network_from, profile_from, requirements_from
from repro_torch.kernels import _build
from repro_torch.kernels.ee_gate.ops import (quant_signature_divide,
                                             quant_signature_rows)
from repro_torch.kernels.ee_gate.population import (QuantConsts,
                                                    quant_signature,
                                                    quant_signature_np)
from repro_torch.kernels.ee_gate.ref import quant_signature_rows_ref

CPU = "cpu"
MODE_SETS = [("floor", "ceil"), ("round", "ceil"), ("ceil",), ("floor",),
             ("round",)]
# the CUDA kernel's fast path takes divide operands of +0 or in [2^-200,
# 2^200]: rates at and across those ends, subnormal, tiny and huge rates and
# the largest double; deltas outside the domain, inside it at both ends,
# and huge
EDGE_RATES = (5e-324, 1e-310, 2.2250738585072014e-308, 2.0 ** -200,
              2.0 ** -200 * (1 - 2.0 ** -53), 2.0 ** 200,
              2.0 ** 200 * (1 + 2.0 ** -52), 1e300, 1.7976931348623157e308)
EDGE_DELTAS = (5e-324, 1e-200, 1e-55, 1e50, 1e300)


def _plan_consts(app, modes=None, gamma=10, delta=None):
    """The reference's and the port's constants bundles of one app's plan on
    the paper scenario with two extra edge nodes (N = 5)."""
    nw = ref_paper_scenario(n_extra_edge=2)
    pf = R.paper_profile(app)
    req = PAPER_MULTIAPP_REQS[app]
    rp = R.Plan(nw, pf, req, gamma=gamma)
    tp = T.Plan(network_from(nw), profile_from(pf),
                requirements_from(req.alpha, req.delta, req.sigma),
                gamma=gamma, device=CPU)
    modes = tuple(rp._modes) if modes is None else tuple(modes)
    delta = req.delta if delta is None else delta
    ref = RefConsts(rp._bits_pack, rp._C_pack, rp._mask_pack, rp._load_pack,
                    modes, gamma, delta)
    got = QuantConsts(tp._bits_pack, tp._C_pack, tp._mask_pack,
                      tp._load_pack, modes, gamma, delta)
    return ref, got, nw.source_node


def _random_consts(seed, modes, gamma=10, K2=9, N=5):
    """Synthetic packs with masked slots and large loads, as numpy (for
    the reference) and tensors (for the port)."""
    rng = np.random.default_rng(seed)
    bits = rng.uniform(1e3, 5e6, (K2, 1))
    C = rng.uniform(0.0, 3e-3, (K2, N))
    C[rng.random(C.shape) < 0.1] = 0.0
    mask = rng.random((K2, N)) > 0.2
    load = rng.uniform(0.0, 6e8, (K2, 1))
    delta = float(rng.uniform(2e-3, 12e-3))
    ref = RefConsts(bits, C, mask, load, tuple(modes), gamma, delta)
    got = QuantConsts(*(torch.as_tensor(a) for a in (bits, C, mask, load)),
                      tuple(modes), gamma, delta)
    return ref, got


def _edge_rows(c: RefConsts, Us: int, seed: int, src: int = 0):
    """(Us, N) bandwidth rows: random rates, then rates aimed at integers
    and at .5 ties of the scaled value (and one ulp either side), rates
    whose significand is all ones and powers of two, EDGE_RATES, zeros,
    NaN, +-inf, negatives and rates below the load."""
    rng = np.random.default_rng(seed)
    N = c.C_pack.shape[1]
    K2 = c.C_pack.shape[0]
    vec = rng.uniform(0.05, 2.0, (Us, N)) * 1e9
    if Us == 0:
        return vec
    # bw at which slot (k, n) scales to exactly `target`:
    # (bits/bw + C) * gamma / delta = target
    k = rng.integers(0, K2, (Us, N))
    n = np.broadcast_to(np.arange(N), (Us, N))
    target = rng.integers(0, c.gamma + 2, (Us, N)) \
        + rng.choice([0.0, 0.5], (Us, N))
    denom = target * c.delta / c.gamma - c.C_pack[k, n]
    aimed = np.where(denom > 0, c.bits_pack[k, 0] / np.where(
        denom > 0, denom, 1.0), np.nan)
    step = rng.integers(-1, 2, (Us, N))
    aimed = np.where(step < 0, np.nextafter(aimed, 0.0),
                     np.where(step > 0, np.nextafter(aimed, np.inf), aimed))
    use = np.isfinite(aimed) & (aimed > 0) & (rng.random((Us, N)) < 0.5)
    vec = np.where(use, aimed, vec)
    erng = np.random.default_rng(seed + 1)
    pick = erng.random((Us, N))
    two_k = 2.0 ** erng.integers(10, 40, (Us, N))
    edge = np.array(EDGE_RATES)[erng.integers(0, len(EDGE_RATES), (Us, N))]
    vec = np.where(pick < 0.06, np.nextafter(two_k, 0.0), vec)
    vec = np.where((pick >= 0.06) & (pick < 0.08), two_k, vec)
    vec = np.where((pick >= 0.08) & (pick < 0.11), edge, vec)
    special = rng.random((Us, N))
    vec[special < 0.04] = 0.0
    vec[(special >= 0.04) & (special < 0.07)] = np.nan
    vec[(special >= 0.07) & (special < 0.09)] = -1e9
    vec[(special >= 0.09) & (special < 0.11)] = -np.inf
    vec[(special >= 0.11) & (special < 0.13)] = np.inf
    vec[(special >= 0.13) & (special < 0.18)] = 1e3       # below every load
    vec[:, src] = np.inf
    return vec


def _check(ref: RefConsts, got: QuantConsts, vec: np.ndarray):
    want = ref_signature_np(vec, ref)
    oracle = quant_signature_np(vec, got)
    plain = quant_signature(vec, got)
    assert isinstance(plain, torch.Tensor) and plain.dtype == torch.int16
    assert want.dtype == oracle.dtype == np.int16
    assert want.shape == (len(vec), got.out_width)
    assert want.tobytes() == oracle.tobytes()
    assert want.tobytes() == plain.numpy().tobytes()
    return want


@pytest.mark.parametrize("Us", [0, 1, 4097])
@pytest.mark.parametrize("app", ["h1", "h4", "h6"])
def test_plain_version_equals_reference_oracle(app, Us):
    ref, got, src = _plan_consts(app)
    want = _check(ref, got, _edge_rows(ref, Us, seed=Us, src=src))
    if Us > 1:
        # the rows reach both encodings and more than one level
        assert (want == -1).any() and len(np.unique(want)) > 3


@pytest.mark.parametrize("modes", MODE_SETS)
@pytest.mark.parametrize("gamma", [3, 10])
def test_every_mode_set_and_gamma_on_synthetic_packs(modes, gamma):
    """Masked slots, loads above the rate, scaled values above gamma and
    exact .5 ties, per mode and gamma."""
    ref, got = _random_consts(10 * MODE_SETS.index(modes) + gamma, modes,
                              gamma)
    want = _check(ref, got, _edge_rows(ref, 2000, seed=gamma))
    assert (want == -1).any() and (want >= 0).any()


def test_tighten_constants_at_a_python_delta_eff():
    """The tighten loop's single-mode bundle: the base packs at ``delta *
    0.85**r``, a Python float, for each round."""
    for app in ("h1", "h6"):
        base, _, src = _plan_consts(app)
        delta_eff = base.delta
        for r in range(1, 7):
            delta_eff *= 0.85
            ref, got, _ = _plan_consts(app, modes=("floor",),
                                       delta=float(delta_eff))
            _check(ref, got, _edge_rows(ref, 513, seed=r, src=src))


@pytest.mark.parametrize("delta", [None, *EDGE_DELTAS])
@pytest.mark.parametrize("app", ["h1", "h4", "h6"])
def test_zero_packs_and_edge_deltas(app, delta):
    """The plan's packs with every third bits entry and every fourth C entry
    zero, at the plan's delta and at EDGE_DELTAS, both modes, on edge
    rows."""
    ref, got, src = _plan_consts(app, delta=delta)
    bits = ref.bits_pack.copy()
    bits[::3] = 0.0
    C = ref.C_pack.copy()
    C.reshape(-1)[1::4] = 0.0
    ref = RefConsts(bits, C, ref.mask_pack, ref.load_pack, ref.modes,
                    ref.gamma, ref.delta)
    got = QuantConsts(torch.as_tensor(bits), torch.as_tensor(C),
                      got.mask_pack, got.load_pack, got.modes, got.gamma,
                      got.delta)
    for Us in (1, 4097):
        _check(ref, got, _edge_rows(ref, Us, seed=Us + 5, src=src))


def test_fast_divide_plain_version():
    """On the CPU the fast-path divide's wrapper is IEEE division; it takes
    no tensor of another device."""
    rng = np.random.default_rng(2)
    a, b = rng.uniform(1e3, 1e7, 64), rng.uniform(1e5, 1e10, 64)
    got = quant_signature_divide(torch.as_tensor(a), torch.as_tensor(b))
    assert got.numpy().tobytes() == (a / b).tobytes()
    with pytest.raises(ValueError, match="no fused-ingest kernel"):
        quant_signature_divide(torch.zeros(2, dtype=torch.float64,
                                           device="meta"),
                               torch.ones(2, dtype=torch.float64,
                                          device="meta"))


@pytest.mark.parametrize("app", ["h1", "h4", "h6"])
def test_out_width_is_the_written_width(app):
    """``out_width`` is M * (2L-1) * N: the bits and load packs are (2L-1, 1)
    columns, so the width comes from the C pack (the reference's property
    reads the column and gives M * (2L-1))."""
    ref, got, src = _plan_consts(app)
    L = R.paper_profile(app).n_blocks
    out = quant_signature(_edge_rows(ref, 7, seed=1, src=src), got)
    assert out.shape[1] == got.out_width == len(got.modes) * (2 * L - 1) * 5
    assert ref.out_width == len(got.modes) * (2 * L - 1)


def test_backends_and_device():
    ref, got, src = _plan_consts("h1")
    vec = _edge_rows(ref, 9, seed=3, src=src)
    with pytest.raises(ValueError, match="device"):
        quant_signature(vec, got, backend="jnp")
    with pytest.raises(ValueError, match="unknown"):
        quant_signature(vec, got, backend="pallas")
    assert got.device == torch.device("cpu")
    # a tensor on the numpy backend, a numpy array on the device backend
    a = quant_signature(torch.as_tensor(vec), got, backend="numpy")
    b = quant_signature(vec, got, backend="device")
    assert a.tobytes() == b.numpy().tobytes()
    with pytest.raises(ValueError, match="unknown quantize mode"):
        quant_signature_rows_ref(torch.as_tensor(vec), got.bits_pack,
                                 got.C_pack, got.mask_pack, got.load_pack,
                                 ("nearest",), 10, 5e-3)
    with pytest.raises(ValueError, match="no fused-ingest kernel"):
        quant_signature_rows(torch.zeros((2, 5), dtype=torch.float64,
                                         device="meta"), got.bits_pack,
                             got.C_pack, got.mask_pack, got.load_pack,
                             got.modes, 10, 5e-3)


def test_kernel_source_is_registered_exact_with_a_double_delta():
    """B2 is built from the checkout with ``-fmad=false`` and takes
    ``delta`` as a C double (so a Python float reaches it unrounded); the
    library is built at first launch, not at import."""
    src = [s for s in _build.SOURCES
           if s.path.as_posix() == "ee_gate/csrc/quant_signature.cu"]
    assert len(src) == 1 and src[0].flags == _build.EXACT_FLAGS
    assert (_build.KERNELS / src[0].path).is_file()
    args = src[0].entry_points["quant_signature"]
    assert args.count(ctypes.c_double) == 1 and args[-2] is ctypes.c_double
    assert args[-1] is ctypes.c_void_p
    names = [n for s in _build.SOURCES for n in s.entry_points]
    assert len(names) == len(set(names))
    assert _build._LIBRARY is None or torch.cuda.is_available()
