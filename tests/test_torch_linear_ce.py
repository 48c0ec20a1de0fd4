"""The training loss kernel B11 (``kernels/linear_ce``) on the CPU.

* ``linear_ce/ref.py``, the kernel's plain version, against
  ``jax.value_and_grad`` of the reference's ``chunked_cross_entropy``
  (``repro/models/layers.py``) on the same numpy-seeded inputs: in float32
  the value within a relative 1e-6 and dh, dW within 1e-5 of their largest
  magnitude; in bf16 the value within 1e-5 and the gradients within 2^-6
  (the reference multiplies the float32 cotangent, the port its bf16
  rounding).  Cases: S ragged against ``chunk``, -1 labels and every label
  -1 (the loss and the gradients 0), a padded vocab tail (dW's padded
  columns exactly 0), the tied head (a table's transpose), a label in the
  last live column, and a cotangent g != 1.
* ``LinearCE`` on the CPU route equals today's chunked program
  (``chunked_cross_entropy`` on CPU tensors), value and gradients, and
  ``loss_fn`` is unchanged against the reference with no B11 launch.
* The backward's passes (``ops._backward``, run on the CPU through the
  wrappers' plain versions): several passes of rows, a ragged last pass,
  dW summed in float32 across passes, both head layouts, equal the
  single-pass plain version.
* A vocab-sharded head's ranks, run one after another through the
  wrappers' plain versions (each rank's columns from ``col0``, K1's
  partials gathered and combined, K2 and K3 on its columns): the loss and
  lse of the whole head, dh the sum of the ranks' and dW their columns,
  with a rank wholly in the padded tail and labels of every rank.
* The wrappers' plain versions (K2's dlogits, K3's product in each stored
  layout), their refusals, and the launch-plan mirror (``linear_ce_plan``:
  the vocab splits cover every tile once and fill the card at [train]'s
  shape, dh's K split, the pass rows against the plain program's chunk
  logits, shared memory) and the ``_build.SOURCES`` entry with the
  source's constants.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import layers as RLY
from repro.models import transformer as RT

from repro_torch.configs import get
from repro_torch.kernels import _build
from repro_torch.kernels.linear_ce import ops as LO
from repro_torch.kernels.linear_ce.ref import (
    HOPPER_SMS, MAX_SMEM_BYTES, dlogits_ref, linear_ce_bwd_ref,
    linear_ce_fwd_ref, linear_ce_plan, live_columns, smem_bytes,
    split_bounds)
from repro_torch.models import layers as PLY
from repro_torch.models import transformer as TT

F32, BF16 = torch.float32, torch.bfloat16
_COUNTERS = (LO.linear_ce_forward, LO.linear_ce_dlogits, LO.linear_ce_gemm)

# (case, B, S, d, V_pad, vocab, chunk, g): ragged S against chunk; -1
# labels; every label -1; a padded tail; the tied head; a label in the last
# live column; g != 1 (the last three on a padded tail too)
CASES = [("ragged", 2, 13, 16, 256, 256, 8, 1.0),
         ("unlabelled", 3, 9, 32, 512, 500, 4, 1.0),
         ("all_unlabelled", 2, 5, 16, 256, 250, 8, 1.0),
         ("padded", 1, 70, 64, 2048, 1999, 256, 1.0),
         ("tied", 2, 17, 48, 1024, 1000, 8, 1.0),
         ("last_live", 1, 1, 16, 256, 200, 256, 1.0),
         ("g", 5, 7, 24, 768, 700, 4, -2.5)]


def _inputs(case, B, S, d, V, vocab, seed=0):
    rng = np.random.default_rng(seed + len(case) + S)
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) / np.sqrt(d) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    if case == "unlabelled":
        labels[:, -3:] = -1
        labels[0, :2] = -1
    if case == "all_unlabelled":
        labels[:] = -1
    if case in ("last_live", "padded", "g"):
        labels.reshape(-1)[0] = vocab - 1
    return h, w, labels


def _bf16(a):
    """numpy float32 -> the nearest bf16 values, as float32 (both packages
    then hold the same bf16 numbers)."""
    return torch.from_numpy(a).to(BF16).to(F32).numpy()


def _reference(h, w, labels, vocab, chunk, g, dtype):
    """jax.value_and_grad of the reference's chunked_cross_entropy times g,
    in float32 or bf16 operands."""
    jd = jnp.float32 if dtype == F32 else jnp.bfloat16
    fn = lambda hh, ww: g * RLY.chunked_cross_entropy(
        hh, ww, jnp.asarray(labels), vocab, chunk=chunk)
    val, (gh, gw) = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(h, jd), jnp.asarray(w, jd))
    return (float(val), np.asarray(gh.astype(jnp.float32)),
            np.asarray(gw.astype(jnp.float32)))


def _port(h, w, labels, vocab, chunk, g, dtype, tied):
    """LinearCE on the CPU route: (value, dh [B, S, d], dW [d, V])."""
    B, S, d = h.shape
    ht = torch.from_numpy(h).to(dtype).requires_grad_(True)
    if tied:
        table = torch.from_numpy(np.ascontiguousarray(w.T)).to(dtype)
        table.requires_grad_(True)
        wt, leaf = table.T, table
    else:
        wt = leaf = torch.from_numpy(w).to(dtype).requires_grad_(True)
    loss = g * LO.linear_ce(ht.reshape(B * S, d), wt,
                            torch.from_numpy(labels).reshape(-1), vocab,
                            B * chunk * w.shape[1] * 4)
    gh, gw = torch.autograd.grad(loss, (ht, leaf))
    if tied:
        gw = gw.T
    return float(loss.detach()), gh.to(F32).numpy(), gw.to(F32).numpy()


def _within(got, want, rel):
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= rel * scale + 1e-30


@pytest.mark.parametrize("case,B,S,d,V,vocab,chunk,g", CASES)
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plain_version_matches_reference(case, B, S, d, V, vocab, chunk, g,
                                         dtype):
    h, w, labels = _inputs(case, B, S, d, V, vocab)
    if dtype == BF16:
        h, w = _bf16(h), _bf16(w)
    want, gh_r, gw_r = _reference(h, w, labels, vocab, chunk, g, dtype)
    counts = [c.launches for c in _COUNTERS]
    got, gh, gw = _port(h, w, labels, vocab, chunk, g, dtype,
                        tied=case == "tied")
    assert [c.launches for c in _COUNTERS] == counts
    if case == "all_unlabelled":
        assert got == 0.0 and want == 0.0
        assert not gh.any() and not gw.any()
        return
    assert got == pytest.approx(want, rel=1e-6 if dtype == F32 else 1e-5)
    rel = 1e-5 if dtype == F32 else 2.0 ** -6
    _within(gh, gh_r, rel)
    _within(gw, gw_r, rel)
    assert not gw[:, vocab:].any()


@pytest.mark.parametrize("case,B,S,d,V,vocab,chunk,g", CASES)
def test_linear_ce_equals_the_chunked_program(case, B, S, d, V, vocab, chunk,
                                              g):
    """On CPU tensors chunked_cross_entropy keeps its chunked program;
    LinearCE's plain route gives its value and gradients."""
    h, w, labels = _inputs(case, B, S, d, V, vocab, seed=1)
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    want = g * PLY.chunked_cross_entropy(ht, wt, torch.from_numpy(labels),
                                         vocab, chunk=chunk)
    gh_w, gw_w = torch.autograd.grad(want, (ht, wt))
    got, gh, gw = _port(h, w, labels, vocab, chunk, g, F32, tied=False)
    assert got == pytest.approx(float(want.detach()), rel=1e-6, abs=1e-7)
    _within(gh, gh_w.numpy(), 1e-5)
    _within(gw, gw_w.numpy(), 1e-5)


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-1.3b"])
def test_loss_fn_unchanged_against_reference(arch):
    """loss_fn on the CPU (qwen3-4b untied, mamba2 with its tied head)
    equals the reference's and launches nothing of B11."""
    ref_cfg, cfg = ref_get(arch, reduced=True), get(arch, reduced=True)
    params = TT.init_model(cfg, seed=0, device="cpu")
    params_r = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels[:, -2:] = -1
    want = float(RT.loss_fn(params_r, ref_cfg, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}))
    counts = [c.launches for c in _COUNTERS]
    with torch.no_grad():
        got = float(TT.loss_fn(params, cfg, {
            "tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}))
    assert [c.launches for c in _COUNTERS] == counts
    assert got == pytest.approx(want, rel=2e-5)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("N,dl_rows", [(70, 16), (300, 128), (33, 33)])
def test_backward_passes_equal_one_pass(dtype, tied, N, dl_rows):
    """``_backward``'s passes of rows (a ragged last one; dW summed in
    float32 across passes) through the wrappers' plain versions equal the
    plain backward over all rows at once."""
    d, V, vocab = 32, 512, 480
    rng = np.random.default_rng(N)
    h = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(d, V)) / 4).astype(np.float32))
    w = w.to(dtype)
    if tied:
        w = w.T.contiguous().T
    labels = torch.from_numpy(rng.integers(-1, vocab, N))
    stats, _, lse = LO.linear_ce_forward(h, w, labels, vocab)
    scale = torch.tensor(0.75) / stats[1]
    elem = 4 if dtype == F32 else 2
    plan = linear_ce_plan(N, d, V, dtype, dl_rows * V * elem, tied)
    assert plan.pass_rows == min(N, dl_rows)
    dh, dw = LO._backward(h, w, labels, lse, scale, vocab, plan, True,
                          True)
    dh_w, dw_w = linear_ce_bwd_ref(h, w, labels, lse, scale, vocab)
    assert dh.shape == h.shape and dw.shape == w.shape
    rel = 1e-6 if dtype == F32 else 2.0 ** -7
    _within(dh.to(F32).numpy(), dh_w.to(F32).numpy(), rel)
    _within(dw.to(F32).numpy(), dw_w.to(F32).numpy(), rel)
    assert not dw[:, vocab:].any()
    dh_only, none = LO._backward(h, w, labels, lse, scale, vocab, plan,
                                 True, False)
    assert none is None and torch.equal(dh_only, dh)


def test_dlogits_plain_version():
    """K2's plain version: the softmax minus the one-hot, scaled by
    g / max(count, 1) at labelled rows, zeros on the padded columns and
    unlabelled rows, rounded to the operands' dtype."""
    rng = np.random.default_rng(5)
    N, d, V, vocab = 9, 16, 256, 250
    h = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(d, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, vocab, N))
    labels[2] = -1
    tot, cnt, lse = linear_ce_fwd_ref(h, w, labels, vocab)
    scale = torch.tensor(3.0) / cnt
    dl = dlogits_ref(h, w, labels, lse, scale, vocab)
    logits = h @ w
    logits[:, vocab:] = -1e30
    p = torch.softmax(logits, -1)
    p[torch.arange(N), labels.clamp_min(0)] -= 1
    want = p * 3.0 / 8.0
    want[2] = 0
    assert torch.allclose(dl, want, rtol=1e-5, atol=1e-7)
    assert not dl[:, vocab:].any() and not dl[2].any()
    assert float(cnt) == 8.0 and float(tot) > 0
    out = torch.empty_like(dl)
    got = LO.linear_ce_dlogits(h, w, labels, lse, scale, vocab, out=out)
    assert got is out and torch.equal(out, dl)
    bf = dlogits_ref(h.to(BF16), w.to(BF16), labels, lse, scale, vocab)
    assert bf.dtype == BF16


def _run_shards(h, w, labels, vocab, ranks, g):
    """The ranks of a head whose V columns are split in ``ranks`` equal
    parts, one after another through the wrappers: each rank's K1 partials
    (a first pass gathers them), the combine over all of them, and each
    rank's backward on its columns -> (loss, lse, dh summed over the ranks
    in float32, dW [d, V])."""
    V = w.shape[1]
    width = V // ranks
    # a rank's shard as it holds it: dense (the tied table's rows are)
    cols = [(r * width, w[:, r * width:(r + 1) * width]) for r in range(ranks)]
    cols = [(c, wr if LO._stored(wr) else wr.contiguous()) for c, wr in cols]
    parts = []
    for col0, wr in cols:
        LO.linear_ce_forward(h, wr, labels, vocab, col0=col0,
                             gather=lambda p: parts.append(p) or p)
    every = lambda p: torch.cat(parts, dim=1)
    fwd = [LO.linear_ce_forward(h, wr, labels, vocab, col0=col0,
                                gather=every) for col0, wr in cols]
    for stats, loss, lse in fwd[1:]:
        assert torch.equal(stats, fwd[0][0]) and torch.equal(lse, fwd[0][2])
    stats, loss, lse = fwd[0]
    scale = torch.tensor(g) / torch.clamp(stats[1], min=1.0)
    dh, dws = torch.zeros(h.shape), []
    for col0, wr in cols:
        plan = linear_ce_plan(h.shape[0], h.shape[1], width, h.dtype,
                              16 * width * 4, LO._stored(wr) == "cols")
        dhr, dwr = LO._backward(h, wr, labels, lse, scale, vocab, plan,
                                True, True, col0)
        dh += dhr.to(F32)
        dws.append(dwr)
    return loss, lse, dh, torch.cat(dws, dim=1)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("ranks,vocab", [(2, 500), (4, 150), (4, 256)])
def test_vocab_shards_equal_the_whole_head(ranks, vocab, tied, dtype):
    """A head split over ``ranks`` (at vocab 150 of 256 the last rank is
    all padding, the third partly) gives the whole head's loss and lse
    (float32 within 1e-6, bf16 1e-5), dh within 1e-6 / 2^-7 of its largest
    (each rank's share rounded to the dtype before the sum) and dW within
    the same, exactly 0 on the padded columns."""
    N, d, V = 37, 32, 256 if vocab <= 256 else 512
    rng = np.random.default_rng(ranks * vocab)
    h = torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(d, V)) / 3).astype(np.float32))
    w = w.to(dtype)
    if tied:
        w = w.T.contiguous().T
    labels = torch.from_numpy(rng.integers(-1, vocab, N))
    labels[:ranks] = torch.arange(ranks) * (V // ranks)   # every rank's
    labels[ranks] = vocab - 1
    labels = torch.where(labels < vocab, labels, torch.zeros_like(labels))
    assert (live_columns(150, 192, 64), live_columns(150, 128, 64),
            live_columns(500, 256, 256)) == (0, 22, 244)
    loss, lse, dh, dw = _run_shards(h, w, labels, vocab, ranks, -1.5)
    stats, want, lse_w = LO.linear_ce_forward(h, w, labels, vocab)
    scale = torch.tensor(-1.5) / stats[1]
    dh_w, dw_w = linear_ce_bwd_ref(h, w, labels, lse_w, scale, vocab)
    rel = 1e-6 if dtype == F32 else 1e-5
    assert float(loss) == pytest.approx(float(want), rel=rel)
    _within(lse.numpy(), lse_w.numpy(), rel)
    rel = 1e-6 if dtype == F32 else 2.0 ** -7
    _within(dh.numpy(), dh_w.to(F32).numpy(), rel)
    _within(dw.to(F32).numpy(), dw_w.to(F32).numpy(), rel)
    assert not dw[:, vocab:].any()


@pytest.mark.parametrize("a_t,b_t", [(False, False), (False, True),
                                     (True, True), (True, False)])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_gemm_plain_version_in_every_layout(a_t, b_t, dtype):
    """K3's plain version reads a and b through any stored layout, sums in
    float32 (plus c_in) and rounds to out's dtype."""
    rng = np.random.default_rng(7)
    M, K, N = 24, 40, 16
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
    a, b = a.to(dtype), b.to(dtype)
    av = a.T.contiguous().T if a_t else a
    bv = b.T.contiguous().T if b_t else b
    assert LO._stored(av) == ("cols" if a_t else "rows")
    assert LO._stored(bv) == ("cols" if b_t else "rows")
    want = a.to(F32) @ b.to(F32)
    assert torch.equal(LO.linear_ce_gemm(av, bv), want.to(dtype))
    c = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32))
    out = torch.empty((M, N), dtype=F32)
    assert torch.equal(LO.linear_ce_gemm(av, bv, out=out, c_in=c), want + c)


def test_wrappers_refuse_what_they_cannot_take():
    h = torch.zeros(4, 8)
    w = torch.zeros(8, 16)
    labels = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        LO.linear_ce_forward(h, w, labels.int(), 16)
    with pytest.raises(ValueError, match="share"):
        LO.linear_ce_forward(h, w.to(BF16), labels, 16)
    with pytest.raises(ValueError, match="vocab_size"):
        LO.linear_ce_forward(h, w, labels, 17)
    with pytest.raises(ValueError, match="stored"):
        LO.linear_ce_forward(h, torch.zeros(8, 32)[:, ::2], labels, 16)
    with pytest.raises(ValueError, match="device"):
        LO.linear_ce_forward(h.to("meta"), w.to("meta"), labels.to("meta"),
                             16)
    with pytest.raises(ValueError, match="expected"):
        LO.linear_ce_gemm(torch.zeros(3, 4), torch.zeros(5, 6))
    # bf16 K2 stores dl by TMA: an out 2 bytes off a 16-byte boundary
    hb, wb = h.to(BF16), w.to(BF16)
    buf = torch.empty(4 * 16 + 8, dtype=BF16)
    base = (-buf.data_ptr() % 16) // 2
    out = buf[base + 1:base + 1 + 4 * 16].view(4, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        LO.linear_ce_dlogits(hb, wb, labels, torch.zeros(4),
                             torch.ones(()), 16, out=out)


def test_plan_at_train_shape_fills_the_card():
    """qwen3-4b's [train] call (2,048 rows, d 2,560, V_pad 153,600, bf16,
    chunk 256 at B = 4): one backward pass, the forward's splits in one
    wave of items over 132 SMs, dh split in K; every split's vocab tiles
    contiguous and every tile in exactly one split."""
    N, d, V = 2048, 2560, 153600
    plan = linear_ce_plan(N, d, V, BF16, 4 * 256 * V * 4)
    assert plan.route == "wgmma" and plan.pass_rows == N
    assert plan.row_tiles == 16 and plan.vocab_tiles == 600
    assert plan.row_tiles * plan.n_split <= HOPPER_SMS
    assert 7 <= plan.n_split <= 9 and plan.fwd_grid == 16 * plan.n_split
    assert plan.dh_split == 4 and plan.dh_tiles == (16, 10)
    assert plan.dw_tiles == (20, 600)
    for p in (plan, linear_ce_plan(70, 64, 2048, BF16, 0),
              linear_ce_plan(64, 2560, V, F32, 2 * 256 * V * 4)):
        tiles = [t for s in range(p.n_split)
                 for t in range(*split_bounds(p.vocab_tiles, p.n_split, s))]
        assert tiles == list(range(p.vocab_tiles))
        assert smem_bytes(p) <= MAX_SMEM_BYTES
    f32 = linear_ce_plan(64, 2560, V, F32, 2 * 256 * V * 4)
    assert f32.route == "simt" and f32.dh_split == 1 and f32.pass_rows == 64
    # the ring, then two bf16 boxes of 16 x 64 a consumer warp (8 warps)
    # for the staged epilogue's TMA stores, then the barriers and the flag
    assert smem_bytes(plan) == 1024 + 4 * 384 * 64 * 2 + 8 * 2 * 16 * 64 * 2 \
        + 64 + 16 == 230480
    # the pass rows: the plain program's chunk logits in float32 over the
    # dtype's bytes, whole row tiles
    assert linear_ce_plan(1000, 64, 2048, BF16, 300 * 2048 * 2).pass_rows == 256
    assert linear_ce_plan(100, 64, 2048, F32, 30 * 2048 * 4).pass_rows == 30
    with pytest.raises(ValueError):
        linear_ce_plan(8, 8, 8, torch.float16, 0)


def test_build_source_and_entry_points():
    """The source exists, built with the default flags (B11 is held to a
    tolerance), with its C entry points and ctypes argument types, and the
    constants that ref.py's mirror repeats."""
    P, I = ctypes.c_void_p, ctypes.c_int
    src = [s for s in _build.SOURCES
           if str(s.path) == "linear_ce/csrc/linear_ce.cu"]
    assert len(src) == 1 and src[0].flags == ()
    text = (_build.KERNELS / src[0].path).read_text()
    want = {"linear_ce_combine": [P] * 5 + [I] * 2 + [P]}
    for t in ("f32", "bf16"):
        want[f"linear_ce_fwd_{t}"] = [P] * 7 + [I] * 7 + [P]
        want[f"linear_ce_dlogits_{t}"] = [P] * 6 + [I] * 6 + [P]
        want[f"linear_ce_gemm_{t}"] = [P] * 6 + [I] * 7 + [P]
    assert src[0].entry_points == want
    assert 'extern "C" int linear_ce_combine(' in text
    for name in ("linear_ce_fwd", "linear_ce_dlogits", "linear_ce_gemm"):
        assert f"#define LCE_{name[10:].upper()}(NAME, BF16)" in text
        for t, bf in (("f32", "false"), ("bf16", "true")):
            assert f"LCE_{name[10:].upper()}({name}_{t}, {bf})" in text
    for const in ("kBM = 128", "kBN = 256", "kBK = 64", "kStages = 4",
                  "kSM = 64", "kSN = 64", "kSK = 16", "kWgThreads = 384",
                  "kMaskValue = -1e30f", "kOutRows = 16",
                  "kOutBox = kOutRows * 64 * 2", "kOutBytes = 8 * 2 * kOutBox",
                  "kOutBytes + 2 * kStages * 8 + 16"):
        assert const in text, const
    assert text.count("atomicAdd(") == 1 and "atomicAdd(&p.sem" in text
