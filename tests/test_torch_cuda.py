"""The port's hand-written CUDA kernel and solver on the card.

Every test here needs a CUDA card and ``nvcc`` (the kernel has no CPU or
interpret mode) and skips, from a fixture, where there is none.  The file
imports only the port, so it also runs on a machine without JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel must be bit-equal, distances and parents, to its plain PyTorch
version on the same device (every candidate is one IEEE add and the min
does not depend on order), and the solver on CUDA must equal its CPU path.
"""
import numpy as np
import pytest
import torch

import repro_torch as T
from repro_torch.core.bellman_ford import kernel_inputs
from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                             banded_minplus_chain)
from repro_torch.kernels.minplus.ref import (banded_minplus_chain_ref,
                                             banded_minplus_ref)

# (B, L, N, G+1): a single state, the solver's width, the reference kernel
# tests' widest N and deepest G+1
CARD_SHAPES = [(1, 1, 4, 4), (64, 4, 5, 26), (8, 2, 23, 26), (4, 4, 8, 131)]

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
