"""The two prefill kernels' plain versions, their autograd Functions and
their kernel-arithmetic mirrors vs the JAX package, on the CPU.

B8 (``kernels/prefill_attn``) computes the reference's
``chunked_attention`` and B9 (``kernels/ssd_scan``) its ``_ssd_scan``.
The same inputs, drawn from a seed with numpy, go through the reference
function and the port's:

* ``ref.py`` of each kernel equals the reference on the grids of
  ``tests/test_torch_prefill.py`` and ``tests/test_torch_ssm.py`` (float32
  within rtol = atol = 1e-4; B8's bf16 bit-equal), B8 also on rows with no
  live key (the reference weighs every key 1 there, the padded slots too);
* the mirrors of the kernels' arithmetic (B8's two tile maps, which skip
  tiles masked for every row and the mask of tiles live for every row,
  and its online softmax over key tiles with -inf masks and dead-row
  fix-up; B9's three
  passes over chunks with a short last chunk and no padded copy) equal the
  reference on the same grids and on unsorted positions with -1 slots;
* the autograd Functions' gradients equal direct autograd of the plain
  versions bit for bit, and ``jax.grad`` of the reference programs within
  1e-5 of each gradient's largest magnitude (q, k, v; xh, B, C, dt,
  a_log, through y and the final state): a float32 gradient element is a
  sum of terms up to that size, summed in another order by XLA, so an
  element that cancels can be off by a few of its ulps;
* both ``_build.SOURCES`` entries exist with their entry points and
  argument types, and the wrappers take the plain version on the CPU
  without counting a launch and raise on any other device.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s [kernels_prefill]).
"""
import ast
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import attention as RA
from repro.models import ssm as RS

from repro_torch.kernels import _build
from repro_torch.kernels.prefill_attn import ops as AO
from repro_torch.kernels.prefill_attn.ref import (packed_tile_positions,
                                                  prefill_attn_ref,
                                                  prefill_attn_tiled_ref,
                                                  tile_map_ref)
from repro_torch.kernels.ssd_scan import ops as SO
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_passes_ref,
                                              ssd_scan_ref)
from repro_torch.models import attention as TA
from repro_torch.models import ssm as TS

TOL = 1e-4
GRAD_TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _attn_inputs(seed, B, Sq, Sk, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D))]


def _attn_both(fn, q, k, v, q_pos, k_pos, **kw):
    """(the reference's output, the port function's) on numpy inputs."""
    want = RA.chunked_attention(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                                **kw)
    got = fn(*map(torch.from_numpy, (q, k, v, q_pos, k_pos)), **kw)
    return got, want


# the reference's grid (tests/test_attention.py, test_torch_prefill.py)
ATTN_GRID = [(causal, window, S, chunk)
             for causal, window in [(True, 0), (True, 7), (False, 0)]
             for S, chunk in [(16, 4), (16, 16), (13, 4), (33, 8)]]


def _mirror(fn):
    """The plain version, the float32 kernel's mirror (tiles of 4 query
    positions) or the bf16 kernel's (tiles of 8 packed (position, head)
    rows), all over key tiles of 4."""
    if fn == "ref":
        return prefill_attn_ref
    if fn == "tiled":
        return lambda *a, **kw: prefill_attn_tiled_ref(*a, q_tile=4,
                                                       k_tile=4, **kw)
    return lambda *a, **kw: prefill_attn_tiled_ref(*a, k_tile=4,
                                                   packed_rows=8, **kw)


@pytest.mark.parametrize("fn", ["ref", "tiled", "packed"])
@pytest.mark.parametrize("causal,window,S,chunk", ATTN_GRID)
def test_prefill_attn_plain_and_mirror_match_reference(fn, causal, window,
                                                       S, chunk):
    q, k, v = _attn_inputs(S * chunk + window, 2, S, S, 4, 2, 8)
    pos = np.arange(S, dtype=np.int32)
    f = _mirror(fn)
    got, want = _attn_both(f, q, k, v, pos, pos, causal=causal,
                           window=window, chunk=chunk)
    _close(got, want)


#: (case, Sq, Sk, causal, window, chunk): keys at -1 and a window far
#: behind (the first chunks masked for every row); queries before every key
#: (causal: dead rows beside live ones); every key slot empty (all rows
#: dead); unsorted key positions with -1 slots and a ragged Sk
MASK_CASES = [("masked_chunks", 6, 24, True, 5, 4),
              ("dead_rows", 12, 20, True, 0, 8),
              ("all_dead", 5, 11, False, 0, 4),
              ("unsorted", 9, 23, True, 6, 8)]


def _mask_positions(case, Sq, Sk, seed):
    rng = np.random.default_rng(seed)
    k_pos = np.arange(Sk, dtype=np.int32)
    q_pos = np.arange(Sk - Sq, Sk, dtype=np.int32)
    if case == "masked_chunks":
        k_pos[:4] = -1
    elif case == "dead_rows":
        k_pos = k_pos + 6                   # q positions 8.. see keys 6..
        q_pos = np.arange(Sq, dtype=np.int32)
    elif case == "all_dead":
        k_pos[:] = -1
    else:
        k_pos = rng.permutation(k_pos).astype(np.int32)
        k_pos[rng.choice(Sk, 5, replace=False)] = -1
    return q_pos, k_pos


@pytest.mark.parametrize("fn", ["ref", "tiled", "packed"])
@pytest.mark.parametrize("case,Sq,Sk,causal,window,chunk", MASK_CASES)
def test_prefill_attn_masks_and_dead_rows_match_reference(
        fn, case, Sq, Sk, causal, window, chunk):
    """Fully masked leading chunks, dead rows (no live key anywhere: every
    key weighs 1 and the output is the sum of v over ceil(Sk / chunk) *
    chunk), unsorted and empty key slots."""
    q, k, v = _attn_inputs(Sq + Sk, 1, Sq, Sk, 4, 1, 8)
    q_pos, k_pos = _mask_positions(case, Sq, Sk, Sq * Sk)
    f = _mirror(fn)
    got, want = _attn_both(f, q, k, v, q_pos, k_pos, causal=causal,
                           window=window, chunk=chunk)
    _close(got, want)
    if case in ("dead_rows", "all_dead"):
        dead = np.asarray(want)[0, 0, 0]      # row 0 has no live key
        n_pad = -(-Sk // chunk) * chunk
        np.testing.assert_allclose(dead, v[0].sum(0)[0] / n_pad, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
@pytest.mark.parametrize("S,chunk", [(16, 4), (33, 8)])
def test_prefill_attn_plain_bf16_is_bit_equal_to_reference(causal, window,
                                                           S, chunk):
    """bf16: the plain version is the reference's arithmetic op by op (the
    probabilities rounded to bf16 before the PV product)."""
    rng = np.random.default_rng(S * chunk + window + 1)
    qkv = [jnp.asarray(rng.normal(size=s).astype(np.float32)
                       ).astype(jnp.bfloat16)
           for s in ((2, S, 4, 8), (2, S, 2, 8), (2, S, 2, 8))]
    pos = np.arange(S, dtype=np.int32)
    want = RA.chunked_attention(*qkv, jnp.asarray(pos), jnp.asarray(pos),
                                causal=causal, window=window, chunk=chunk)
    got = prefill_attn_ref(
        *(torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in qkv), torch.from_numpy(pos), torch.from_numpy(pos),
        causal=causal, window=window, chunk=chunk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


#: (B, S, H, KV, D, causal, window, chunk) of the bf16 kernel's mirror at
#: its own tiles (128 packed (position, head) rows, 128-key tiles): G = 6
#: at D = 80 (21 positions a tile), G = 48 (2 positions a tile, windowed),
#: G = 1 (hubert's layout, bidirectional, two sequences), G = 4 with a
#: window of one key tile; no S is a multiple of 128 or of a tile's
#: positions
PACKED_CASES = [(1, 200, 48, 8, 80, True, 0, 64),
                (1, 151, 48, 1, 16, True, 40, 32),
                (2, 130, 16, 16, 80, False, 0, 32),
                (1, 300, 24, 6, 16, True, 128, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window,chunk", PACKED_CASES)
def test_prefill_attn_packed_mirror_matches_reference(B, S, H, KV, D, causal,
                                                      window, chunk, dtype):
    """The bf16 kernel's arithmetic at its own tiles against the
    reference: float32 within rtol = atol = 1e-4; bf16 (the probabilities
    of a 128-key tile rounded, the reference's those of a chunk) within
    2^-6 of the largest |output|, the card's tolerance for the kernel."""
    q, k, v = _attn_inputs(S + H + D, B, S, S, H, KV, D)
    pos = np.arange(S, dtype=np.int32)
    kw = dict(causal=causal, window=window, chunk=chunk)
    if dtype == "float32":
        got, want = _attn_both(
            lambda *a, **k_: prefill_attn_tiled_ref(
                *a, k_tile=AO.KEY_TILE[torch.bfloat16],
                packed_rows=AO.PACKED_ROWS, **k_), q, k, v, pos, pos, **kw)
        _close(got, want)
        return
    qkv = [a.astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(RA.chunked_attention(
        *map(jnp.asarray, qkv), jnp.asarray(pos), jnp.asarray(pos),
        **kw).astype(jnp.float32))
    got = prefill_attn_tiled_ref(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        torch.from_numpy(pos), torch.from_numpy(pos),
        k_tile=AO.KEY_TILE[torch.bfloat16], packed_rows=AO.PACKED_ROWS, **kw)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy() - want).max()) <= \
        2.0 ** -6 * float(np.abs(want).max())


def test_packed_tiles_hold_whole_positions():
    """A bf16 tile's 128 rows hold whole positions of G heads: 21 at
    mixtral's G = 6, 2 at granite's G = 48, 128 at G = 1, one position of
    128 heads past G = 128."""
    assert [packed_tile_positions(G) for G in (1, 4, 6, 8, 48, 200)] == \
        [128, 32, 21, 16, 2, 1]
    assert AO.smem_bytes(80, torch.bfloat16) == \
        AO.smem_bytes(128, torch.bfloat16) <= AO.MAX_SMEM_BYTES
    assert AO.smem_bytes(64, torch.bfloat16) < AO.smem_bytes(80,
                                                              torch.bfloat16)
    assert AO.tile_map_words(4608, 4608, torch.bfloat16) == 0
    assert AO.tile_map_words(4608, 4608, torch.float32) == 2 * 72 * 5


@pytest.mark.parametrize("case,Sq,Sk,causal,window,chunk", MASK_CASES)
def test_tile_maps_never_drop_a_live_key_nor_skip_a_mask(
        case, Sq, Sk, causal, window, chunk):
    """Every (query, key) pair the mask keeps lies in a key tile the first
    map keeps for its query tile, and every pair of a tile the second map
    marks whole is live, at tiles of 4, at the float32 kernel's 64 / 32
    and at the bf16 kernel's positions of G = 6 and 48 / 128 keys."""
    q_pos, k_pos = map(torch.from_numpy, _mask_positions(case, Sq, Sk, 1))
    live = (k_pos[None] >= 0) & (~torch.tensor(causal)
                                 | (k_pos[None] <= q_pos[:, None]))
    if window > 0:
        live &= k_pos[None] > q_pos[:, None] - window
    n_whole = 0
    for qt_size, kt_size in ((4, 4), (64, 64), (64, 32),
                             (packed_tile_positions(6), 128),
                             (packed_tile_positions(48), 128)):
        tiles, whole = tile_map_ref(q_pos, k_pos, causal, window, qt_size,
                                    kt_size)
        i, j = torch.nonzero(live, as_tuple=True)
        assert bool(tiles[i // qt_size, j // kt_size].all())
        for qt, kt in torch.nonzero(whole).tolist():
            block = live[qt * qt_size:(qt + 1) * qt_size,
                         kt * kt_size:(kt + 1) * kt_size]
            assert block.shape[1] == kt_size and bool(block.all())
            n_whole += 1
        assert not bool((whole & ~tiles).any())
    if case == "masked_chunks":      # a window far behind: tiles skipped
        assert not bool(tile_map_ref(q_pos, k_pos, causal, window, 4,
                                     4)[0].all())
    if case == "all_dead":
        assert n_whole == 0
    # a causal square: the key tiles below the diagonal are whole
    pos = torch.arange(16, dtype=torch.int32)
    assert torch.equal(tile_map_ref(pos, pos, True, 0, 4, 4)[1],
                       torch.ones(4, 4, dtype=torch.bool).tril(-1))


def _ssd_cfgs(**over):
    from repro_torch.configs.base import ArchConfig, LayerSpec
    ref = dataclasses.replace(ref_get("mamba2-1.3b", reduced=True), **over)
    kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    kw["pattern"] = tuple(LayerSpec(s.kind, s.mlp) for s in ref.pattern)
    return ref, ArchConfig(**kw)


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    a_log = -rng.uniform(0.01, 1.0, (B, S, H)).astype(np.float32) * dt
    return xh, Bm, Cm, dt, a_log


@pytest.mark.parametrize("fn", ["ref", "passes"])
@pytest.mark.parametrize("chunk", [4, 8, 64])
@pytest.mark.parametrize("S", [16, 19, 21])
def test_ssd_scan_plain_and_mirror_match_reference(fn, chunk, S):
    """y and the final state across chunk sizes, S a chunk multiple,
    ragged (the reference pads, the mirror runs a short last chunk) and
    shorter than one chunk (the grid of tests/test_torch_ssm.py)."""
    ref_cfg, _ = _ssd_cfgs(ssm_chunk=chunk)
    _, H, P, N = RS.ssm_dims(ref_cfg)
    args = _ssd_inputs(chunk * S, 2, S, H, P, N)
    y_r, st_r = RS._ssd_scan(ref_cfg, *map(jnp.asarray, args))
    f = ssd_scan_ref if fn == "ref" else ssd_scan_passes_ref
    y_t, st_t = f(*map(torch.from_numpy, args), chunk=chunk)
    assert tuple(y_t.shape) == y_r.shape and st_t.dtype == torch.float32
    _close(y_t, y_r)
    _close(st_t, st_r)


def test_ssd_scan_mirror_bf16_matches_plain():
    """bf16 x, B and C: the three passes round y once, as the plain
    version, within 2^-7 of its largest |y|."""
    args = list(map(torch.from_numpy, _ssd_inputs(5, 2, 21, 4, 16, 16)))
    args[:3] = [t.bfloat16() for t in args[:3]]
    y_p, st_p = ssd_scan_ref(*args, chunk=8)
    y_m, st_m = ssd_scan_passes_ref(*args, chunk=8)
    assert y_m.dtype == torch.bfloat16
    tol = 2.0 ** -7 * float(y_p.float().abs().max())
    assert float((y_m.float() - y_p.float()).abs().max()) <= tol
    _close(st_m, st_p)


def _grad_close(got, want):
    """max |got - want| <= GRAD_TOL * max |want|."""
    got, want = got.numpy(), np.asarray(want)
    assert float(np.abs(got - want).max()) <= \
        GRAD_TOL * float(np.abs(want).max())


def _grads(fn, inputs, weights):
    """d/d inputs of sum(w * out) over each output of ``fn``."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * w).sum() for o, w in zip(outs, weights))
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("causal,window,S,chunk",
                         [(True, 0, 16, 4), (True, 7, 13, 4),
                          (False, 0, 33, 8)])
def test_prefill_attention_grads_equal_plain_and_reference(causal, window,
                                                           S, chunk):
    q, k, v = _attn_inputs(S + chunk, 2, S, S, 4, 2, 8)
    pos = np.arange(S, dtype=np.int32)
    w = np.random.default_rng(S).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, chunk=chunk)
    tp = torch.from_numpy(pos)
    inputs = list(map(torch.from_numpy, (q, k, v)))
    got = _grads(lambda a, b, c: AO.prefill_attention(a, b, c, tp, tp, **kw),
                 inputs, [torch.from_numpy(w)])
    plain = _grads(lambda a, b, c: prefill_attn_ref(a, b, c, tp, tp, **kw),
                   inputs, [torch.from_numpy(w)])
    via_model = _grads(
        lambda a, b, c: TA.chunked_attention(a, b, c, tp, tp, **kw), inputs,
        [torch.from_numpy(w)])
    jp = jnp.asarray(pos)
    want = jax.grad(lambda a, b, c: jnp.sum(RA.chunked_attention(
        a, b, c, jp, jp, **kw) * w), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for g, p, m, r in zip(got, plain, via_model, want):
        assert torch.equal(g, p) and torch.equal(m, p)
        _grad_close(g, r)


@pytest.mark.parametrize("chunk,S", [(4, 16), (8, 21), (64, 19)])
def test_ssd_scan_grads_equal_plain_and_reference(chunk, S):
    """Gradients of every input through y and through the final state."""
    ref_cfg, cfg = _ssd_cfgs(ssm_chunk=chunk)
    _, H, P, N = RS.ssm_dims(ref_cfg)
    args = _ssd_inputs(chunk + S, 2, S, H, P, N)
    rng = np.random.default_rng(S)
    wy = rng.normal(size=(2, S, H, P)).astype(np.float32)
    ws = rng.normal(size=(2, H, P, N)).astype(np.float32)
    weights = [torch.from_numpy(wy), torch.from_numpy(ws)]
    inputs = list(map(torch.from_numpy, args))
    got = _grads(lambda *a: SO.ssd_scan_fn(*a, chunk=chunk), inputs,
                 weights)
    plain = _grads(lambda *a: ssd_scan_ref(*a, chunk=chunk), inputs,
                   weights)
    via_model = _grads(lambda *a: TS._ssd_scan(cfg, *a), inputs, weights)

    def loss(*a):
        y, st = RS._ssd_scan(ref_cfg, *a)
        return jnp.sum(y * wy) + jnp.sum(st * ws)
    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    for g, p, m, r in zip(got, plain, via_model, want):
        assert torch.equal(g, p) and torch.equal(m, p)
        _grad_close(g, r)


def test_prefill_kernel_sources_and_entry_points():
    """Both sources exist, built with the default flags, with their C
    entry points and ctypes argument types (pointers, ints, the stream)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    want = {"prefill_attn/csrc/prefill_attn.cu":
            ({"prefill_attn_f32", "prefill_attn_bf16"}, [P] * 7 + [I] * 9),
            "ssd_scan/csrc/ssd_scan.cu":
            ({"ssd_scan_f32", "ssd_scan_bf16"}, [P] * 11 + [I] * 6)}
    for path, (names, args) in want.items():
        src = [s for s in _build.SOURCES if str(s.path) == path]
        assert len(src) == 1 and src[0].flags == ()
        assert (_build.KERNELS / src[0].path).is_file()
        assert set(src[0].entry_points) == names
        for types in src[0].entry_points.values():
            assert types == args + [P]
    assert AO._ENTRY[torch.bfloat16] == "prefill_attn_bf16"
    assert SO._ENTRY[torch.float32] == "ssd_scan_f32"


def test_prefill_wrappers_take_the_plain_version_on_the_cpu_only():
    q, k, v = map(torch.from_numpy, _attn_inputs(0, 1, 8, 8, 4, 2, 16))
    pos = torch.arange(8, dtype=torch.int32)
    ssd = list(map(torch.from_numpy, _ssd_inputs(0, 1, 8, 2, 16, 16)))
    n8, n9 = AO.prefill_attn.launches, SO.ssd_scan.launches
    assert torch.equal(
        AO.prefill_attn(q, k, v, pos, pos, causal=True, window=0, chunk=4),
        prefill_attn_ref(q, k, v, pos, pos, causal=True, window=0, chunk=4))
    y, st = SO.ssd_scan(*ssd, chunk=4)
    y_r, st_r = ssd_scan_ref(*ssd, chunk=4)
    assert torch.equal(y, y_r) and torch.equal(st, st_r)
    assert (AO.prefill_attn.launches, SO.ssd_scan.launches) == (n8, n9)
    meta = [t.to("meta") for t in (q, k, v, pos)]
    with pytest.raises(ValueError, match="no prefill attention kernel"):
        AO.prefill_attn(*meta, meta[3], causal=True, window=0, chunk=4)
    with pytest.raises(ValueError, match="no SSD scan kernel"):
        SO.ssd_scan(*(t.to("meta") for t in ssd), chunk=4)
    assert (AO.prefill_attn.launches, SO.ssd_scan.launches) == (n8, n9)


def test_prefill_kernel_packages_import_no_jax():
    forbidden = ("jax", "jaxlib", "repro")
    for pkg in ("prefill_attn", "ssd_scan"):
        for path in (_build.KERNELS / pkg).glob("*.py"):
            for node in ast.walk(ast.parse(path.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for n in names:
                    assert n.split(".")[0] not in forbidden, (path, n)
