"""Banded minplus kernels of the PyTorch port (B1 chain, B1u one layer).

On the CPU the wrappers run their plain PyTorch versions, which must equal
the reference: float64 distances and parents bit for bit against the
float64 numpy engine (``batched_banded_relax_minarg``), float32 ones against
the jnp engine and, on one tiny case, the Pallas chain kernel in interpret
mode.  B1's launch plan (``chain_plan``) must fit the card at every shape
the wrapper takes, with the shared memory the kernel source states, and a
plain-Python model of the kernel's copy split must cover every run.  The
card tests of the hand-written kernel are in ``test_torch_cuda.py``, which
does not import the JAX package.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.bellman_ford import (batched_banded_relax_argmin as
                                     ref_relax_argmin)
from repro.core.bellman_ford import (batched_banded_relax_minarg as
                                     ref_relax_minarg)

from repro_torch.core import bellman_ford as bf
from repro_torch.kernels.minplus import ops
from repro_torch.kernels.minplus.ops import (banded_minplus_argmin,
                                             banded_minplus_chain,
                                             banded_minplus_chain_history)
from repro_torch.kernels.minplus.ref import (banded_minplus_chain_ref,
                                             banded_minplus_ref)

# (B, L, N, G) of the reference's kernel tests (tests/test_kernels.py)
CHAIN_SHAPES = [(1, 1, 4, 3), (3, 4, 7, 10), (5, 2, 9, 25)]
LAYER_SHAPES = [(4, 3), (16, 10), (23, 25), (8, 130)]


def _problem(B, L, N, Gp1, seed, tie=True):
    """Seeded banded inputs: float steep with inf = pruned, as the graphs
    store it, plus a duplicated source row so ties are exercised."""
    rng = np.random.default_rng(seed)
    dist = rng.uniform(0, 10, (B, N, Gp1))
    dist[rng.uniform(size=dist.shape) < 0.5] = np.inf
    E = rng.uniform(0, 5, (B, L, N, N))
    steep = rng.integers(0, Gp1, (B, L, N, N)).astype(np.float64)
    steep[rng.uniform(size=steep.shape) < 0.3] = np.inf
    if tie and N > 1:
        E[:, :, 1] = E[:, :, 0]
        steep[:, :, 1] = steep[:, :, 0]
        dist[:, 1] = dist[:, 0]
    return dist, E, steep


def _kernel_form(dist, E, steep, dtype):
    Ek, st = bf.kernel_inputs(torch.as_tensor(E), torch.as_tensor(steep),
                              dtype)
    return torch.as_tensor(dist).to(dtype), Ek, st


@pytest.mark.parametrize("lo", [None, 2])
@pytest.mark.parametrize("B,L,N,G", CHAIN_SHAPES + [(64, 4, 5, 25)])
def test_plain_f64_chain_bit_equal_to_numpy_engine(B, L, N, G, lo):
    dist, E, steep = _problem(B, L, N, G + 1, B * 1000 + L * 100 + N * 10 + G)
    hist_r, par_r = ref_relax_minarg(dist, E, steep, lo)
    hist, par = bf.batched_banded_relax_minarg(
        torch.as_tensor(dist), torch.as_tensor(E), torch.as_tensor(steep), lo)
    assert hist.dtype == torch.float64 and par.dtype == torch.int32
    assert hist.numpy().tobytes() == hist_r.tobytes()
    np.testing.assert_array_equal(par.numpy(), par_r)


@pytest.mark.parametrize("lo", [None, 5])
@pytest.mark.parametrize("N,G", LAYER_SHAPES)
def test_plain_f64_layer_bit_equal_to_numpy_engine(N, G, lo):
    dist, E, steep = _problem(1, 1, N, G + 1, N * 100 + G)
    hist_r, par_r = ref_relax_minarg(dist, E, steep, lo)
    d, Ek, st = _kernel_form(dist, E, steep, torch.float64)
    out, arg = banded_minplus_argmin(d[0], Ek[0, 0], st[0, 0], lo=lo)
    assert out.numpy().tobytes() == hist_r[0, 1].tobytes()
    np.testing.assert_array_equal(arg.numpy(), par_r[0, 0])


@pytest.mark.parametrize("lo", [None, 2])
@pytest.mark.parametrize("B,L,N,G", CHAIN_SHAPES)
def test_plain_f32_chain_equal_to_jnp_engine(B, L, N, G, lo):
    dist, E, steep = _problem(B, L, N, G + 1, 7 + B + L + N + G)
    hist_r, par_r = ref_relax_argmin(dist, E, steep, lo, backend="jnp")
    hist, par = bf.batched_banded_relax_argmin(
        torch.as_tensor(dist), torch.as_tensor(E), torch.as_tensor(steep), lo,
        dtype=torch.float32)
    assert hist.dtype == torch.float32
    assert hist.double().numpy().tobytes() == hist_r.tobytes()
    np.testing.assert_array_equal(par.numpy(), par_r)


@pytest.mark.parametrize("lo", [None, 2])
def test_plain_f32_chain_equal_to_pallas_interpret(lo):
    """One tiny case against the Pallas chain kernel (interpret mode is
    slow): the reference's pallas history keeps the float64 init grid."""
    dist, E, steep = _problem(2, 3, 5, 11, 99)
    hist_r, par_r = ref_relax_argmin(dist, E, steep, lo, backend="pallas")
    hist, par = bf.batched_banded_relax_argmin(
        torch.as_tensor(dist), torch.as_tensor(E), torch.as_tensor(steep), lo,
        dtype=torch.float32)
    assert hist[:, 1:].double().numpy().tobytes() == hist_r[:, 1:].tobytes()
    np.testing.assert_array_equal(par.numpy(), par_r)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lo", [None, 2])
def test_layer_equals_one_layer_of_chain(dtype, lo):
    dist, E, steep = _problem(3, 4, 7, 11, 5)
    d, Ek, st = _kernel_form(dist, E, steep, dtype)
    hist, par = banded_minplus_chain(d, Ek, st, lo=lo)
    for b in range(3):
        cur = d[b]
        for l in range(4):
            out, arg = banded_minplus_argmin(cur, Ek[b, l], st[b, l], lo=lo)
            assert torch.equal(out, hist[b, l]) and torch.equal(arg, par[b, l])
            cur = out


def test_single_block_chain_returns_init_only():
    init = torch.full((3, 4, 6), float("inf"), dtype=torch.float64)
    init[:, 0, 2] = 1.5
    E = torch.zeros((3, 0, 4, 4), dtype=torch.float64)
    hist, par = bf.batched_banded_relax_argmin(init, E, E.clone())
    assert hist.shape == (3, 1, 4, 6) and par.shape == (3, 0, 4, 6)
    assert torch.equal(hist[:, 0], init)


def test_kernel_inputs_mask_before_cast():
    E = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=torch.float64)
    steep = torch.tensor([[0.0, float("inf")], [2.0, -0.0]],
                         dtype=torch.float64)
    Ek, st = bf.kernel_inputs(E, steep, torch.float32)
    assert st.dtype == torch.int32 and st.tolist() == [[0, 0], [2, 0]]
    assert Ek.dtype == torch.float32
    assert Ek.tolist() == [[1.0, float("inf")], [3.0, 4.0]]


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    dist, E, steep = _problem(2, 2, 3, 5, 1)
    d, Ek, st = _kernel_form(dist, E, steep, torch.float64)
    before = (banded_minplus_chain.launches, banded_minplus_argmin.launches)
    got = banded_minplus_chain(d, Ek, st)
    want = banded_minplus_chain_ref(d, Ek, st)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    full, par = banded_minplus_chain_history(d, Ek, st)
    assert torch.equal(full, torch.cat([d[:, None], want[0]], dim=1))
    assert torch.equal(par, want[1])
    got1 = banded_minplus_argmin(d[0], Ek[0, 0], st[0, 0])
    want1 = banded_minplus_ref(d[0], Ek[0, 0], st[0, 0])
    assert all(torch.equal(g, w) for g, w in zip(got1, want1))
    assert (banded_minplus_chain.launches,
            banded_minplus_argmin.launches) == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "st_dtype", "width",
                                 "contiguous"])
def test_launch_validation_raises(bad):
    """The launch path checks its inputs before touching the library."""
    B, L, N, Gp1 = 2, 2, 3, 5
    dist = torch.zeros((B, N, Gp1), dtype=torch.float64)
    E = torch.zeros((B, L, N, N), dtype=torch.float64)
    st = torch.zeros((B, L, N, N), dtype=torch.int32)
    if bad == "shape":
        E = E[:, :, :2]
    elif bad == "dtype":
        E = E.float()
    elif bad == "st_dtype":
        st = st.long()
    elif bad == "width":
        dist = torch.zeros((B, ops.MAX_NODES + 1, Gp1), dtype=torch.float64)
        E = torch.zeros((B, L, ops.MAX_NODES + 1, ops.MAX_NODES + 1),
                        dtype=torch.float64)
        st = torch.zeros(E.shape, dtype=torch.int32)
    elif bad == "contiguous":
        E = E.transpose(2, 3)
    with pytest.raises(ValueError):
        ops._launch_chain(dist, E, st, None)


def test_relax_chunk_bytes_env_validation(monkeypatch):
    monkeypatch.delenv("REPRO_RELAX_CHUNK_BYTES", raising=False)
    assert bf.relax_chunk_bytes() == bf._RELAX_CHUNK_BYTES_DEFAULT
    monkeypatch.setenv("REPRO_RELAX_CHUNK_BYTES", "")
    assert bf.relax_chunk_bytes() == bf._RELAX_CHUNK_BYTES_DEFAULT
    monkeypatch.setenv("REPRO_RELAX_CHUNK_BYTES", "65536")
    assert bf.relax_chunk_bytes() == 65536
    for bad in ("abc", "4MB", "1.5e6"):
        monkeypatch.setenv("REPRO_RELAX_CHUNK_BYTES", bad)
        with pytest.raises(ValueError, match="REPRO_RELAX_CHUNK_BYTES"):
            bf.relax_chunk_bytes()
    for bad in ("0", "-4194304"):
        monkeypatch.setenv("REPRO_RELAX_CHUNK_BYTES", bad)
        with pytest.raises(ValueError, match="positive"):
            bf.relax_chunk_bytes()


def test_relax_chunk_rows(monkeypatch):
    monkeypatch.setenv("REPRO_RELAX_CHUNK_BYTES", "1000")
    assert bf.relax_chunk_rows(100) == 10
    assert bf.relax_chunk_rows(999) == 1
    assert bf.relax_chunk_rows(10_000) == 1
    for bad in (0, -8):
        with pytest.raises(ValueError, match="bytes_per_row"):
            bf.relax_chunk_rows(bad)
        with pytest.raises(ValueError, match="bytes_per_row"):
            bf.device_chunk_rows(bad)
    assert bf.device_chunk_rows(bf.DEVICE_RELAX_BUDGET_BYTES + 1) == 1



# ---------------------------------------------------------------------------
# B1's launch plan and copy split
# ---------------------------------------------------------------------------

KERNEL_SOURCE = (Path(ops.__file__).parent / "csrc" / "banded_minplus.cu")


@pytest.mark.parametrize("L", [1, 4, 8, 64])
@pytest.mark.parametrize("Gp1", [1, 26, 256])
@pytest.mark.parametrize("N", [1, 5, 32])
def test_chain_launch_plan_fits_the_card(N, Gp1, L):
    """Every launch of the plan fits a block's shared memory and 1,024
    threads, takes at least one scenario a group (exactly one through the
    per-layer ring), and launches no more blocks than groups; whole warps
    cover the group's nodes and depths up to the block's threads."""
    tps = ops.chain_threads(N, Gp1)
    assert tps // N * ops.CHAIN_DEPTHS >= Gp1  # every depth has a thread
    for dtype in (torch.float64, torch.float32):
        whole = ops.chain_whole(L, N, Gp1, dtype)
        for B in (1, 7, 1000, 20480, 1 << 20):
            spb, threads, blocks = ops.chain_plan(B, L, N, Gp1, dtype)
            assert spb >= 1 and (whole or spb == 1)
            assert ops.chain_smem_bytes(spb, L, N, Gp1, dtype, whole) \
                <= ops.MAX_SMEM_BYTES
            assert threads % 32 == 0 and threads <= ops.CHAIN_THREADS <= 1024
            assert threads >= min(spb * tps, ops.CHAIN_THREADS)
            assert threads - spb * tps < 32 or threads == ops.CHAIN_THREADS
            assert 1 <= blocks <= -(-B // spb)


def test_chain_launch_plan_at_the_solver_widths():
    """20,480 rows at N = 5, G+1 = 26, L = 4: two depths a thread make 65
    threads a scenario, seven scenarios a group fill 15 warps (455 of 480
    threads), and the persistent grid holds fewer blocks than groups, so
    each block walks several."""
    assert ops.CHAIN_DEPTHS == 2 and ops.chain_threads(5, 26) == 65
    for dtype in (torch.float64, torch.float32):
        spb, threads, blocks = ops.chain_plan(20480, 4, 5, 26, dtype)
        assert (spb, threads) == (7, 480)
        assert 132 <= blocks < -(-20480 // 7)
    assert ops.chain_plan(1, 1, 5, 26, torch.float64) == (1, 96, 1)
    assert not ops.chain_whole(1, 32, 256, torch.float64)
    assert ops.chain_whole(1, 32, 256, torch.float32)


def test_chain_depths_match_the_kernel_source():
    src = KERNEL_SOURCE.read_text()
    assert re.search(r"constexpr int kDepths = (\d+);", src).group(1) == \
        str(ops.CHAIN_DEPTHS)


def _source_smem_formula():
    """The kernel source's ``chain_smem_bytes`` as a Python function."""
    src = KERNEL_SOURCE.read_text()
    body = re.search(r"long long chain_smem_bytes\((.*?)\n}", src, re.S)
    whole, ring = re.search(r"if \(whole\)\s*return (.*?);\s*return (.*?);",
                            body.group(1), re.S).groups()

    def pad16(x):
        return ((x + 15) & ~15) + 16

    def formula(spb, L, N, Gp1, item, is_whole):
        env = dict(spb=spb, L=L, N=N, Gp1=Gp1, item=item, states=N * Gp1,
                   nn=N * N, pad16=pad16)
        return eval(f"({whole if is_whole else ring})",
                    {"__builtins__": {}}, env)
    return formula


def test_chain_smem_formula_matches_the_kernel_source():
    formula = _source_smem_formula()
    for spb in (1, 2, 3, 7):
        for L in (1, 4, 64):
            for N, Gp1 in ((1, 1), (5, 26), (5, 11), (32, 256)):
                for dtype, item in ((torch.float64, 8), (torch.float32, 4)):
                    for whole in (True, False):
                        assert ops.chain_smem_bytes(spb, L, N, Gp1, dtype,
                                                    whole) == \
                            formula(spb, L, N, Gp1, item, whole)


def _pieces(ps, n):
    """Plain-Python model of the kernel's ``Pieces``: the (offset, width)
    of each copy of an n-byte run whose source and destination both start
    at address phase ps (mod 16)."""
    head = min((16 - ps) & 15, n)
    nh, nb = head // 4, (n - head) // 16
    nt = (n - head - 16 * nb) // 4
    return ([(4 * i, 4) for i in range(nh)]
            + [(head + 16 * i, 16) for i in range(nb)]
            + [(head + 16 * nb + 4 * i, 4) for i in range(nt)])


@pytest.mark.parametrize("ps", [0, 4, 8, 12])
def test_copy_split_model_covers_every_run(ps):
    """Each byte of a run is copied once, a 16-byte piece starts 16-byte
    aligned, and at most three 4-byte words sit at each end."""
    for n in range(4, 200, 4):
        pieces = _pieces(ps, n)
        covered = [o + k for o, w in pieces for k in range(w)]
        assert covered == list(range(n))
        words = [o for o, w in pieces if w == 4]
        for o, w in pieces:
            if w == 16:
                assert (ps + o) % 16 == 0
        assert sum(o < 16 - ps for o in words) <= 3
        assert len(words) <= 6
