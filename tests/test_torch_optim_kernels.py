"""The optimizer kernels' plain versions (B12: the global norm and clip
scale; B13: AdamW's update with the clip folded in) and their chunk table,
on the CPU.

* B12's and B13's plain versions (``kernels/adamw/ref.py``) against the
  JAX package's ``clip_by_global_norm`` followed by ``AdamW.update`` over
  ten steps: the norm and scale within a relative 1e-6, and B13 given the
  reference's scale: float32 within a relative 1e-6, bf16 moments within
  one bf16 ulp (``test_torch_optim``'s tolerances).
* The fold: B13's plain version given B12's scale is bit-equal to the
  in-place clip followed by the update, over parameter dtype x moment
  dtype x schedule x clip active / inactive; so is the train step's
  ``clip_and_update``, which folds on the CPU as on a card, and its
  gradients' norm is B12's.
* The chunk table (``ref.chunk_table`` / ``ref.regions``, what the kernels
  walk) covers every leaf of 1, 7, CHUNK - 1, CHUNK, CHUNK + 1 and 3 CHUNK
  + 5 elements and a 0-dim leaf exactly once, in order, with every vector
  16-byte aligned in each tensor, at aligned, shifted and disagreeing
  addresses.
* The wrappers on CPU tensors run the plain versions and count no launch;
  ``_build.SOURCES`` has the source with ``-fmad=false`` and its entry
  points, and the source's constants match the mirror's.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as P
from repro_torch.kernels import _build
from repro_torch.kernels.adamw import ops as AO
from repro_torch.kernels.adamw import ref as AR
from repro_torch.optim import adamw as PA

BF = torch.bfloat16


def _tree(rng):
    return {"w": rng.normal(size=(8, 4)), "b": rng.normal(size=(4,)),
            "s": rng.normal(size=()),
            "layers": {"stack": rng.normal(size=(3, 5, 6)),
                       "norm": rng.normal(size=(3, 6))}}


def _torch(tree, dtype):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x, np.float32),
                                               dtype=dtype), tree)


def _jnp(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float32),
                                              dtype=dtype), tree)


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _lists(grads, state, params):
    return [PA.tree_leaves(t) for t in (grads, state.mu, state.nu, params)]


@pytest.mark.parametrize("scale_grads", [1.0, 0.01])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("schedule", [False, True])
def test_plain_versions_match_reference_clip_then_update(schedule, state_dtype,
                                                         scale_grads):
    """Ten steps of B12 then B13 (the clip folded in) against the JAX
    package's clip_by_global_norm then AdamW.update; the norms within a
    relative 1e-6 too.  With gradients times 0.01 the clip is inactive."""
    kw = dict(lr=1e-2, weight_decay=0.1, state_dtype=state_dtype)
    r = R.AdamW(schedule=R.cosine_schedule(3, 10) if schedule else None,
                **kw)
    p = P.AdamW(schedule=P.cosine_schedule(3, 10) if schedule else None,
                **kw)
    bf = state_dtype == "bfloat16"
    rng = np.random.default_rng(11)
    p0 = _tree(rng)
    pr, pt = _jnp(p0, jnp.bfloat16 if bf else None), \
        _torch(p0, BF if bf else torch.float32)
    sr, st = r.init(pr), p.init(pt)
    active = []
    for _ in range(10):
        g = jax.tree.map(lambda x: x * scale_grads * 3.0, _tree(rng))
        gr = _jnp(g, jnp.bfloat16 if bf else None)
        gt = _torch(g, BF if bf else torch.float32)
        gr, nr = R.clip_by_global_norm(gr, 1.0)
        pr, sr = r.update(gr, sr, pr)
        gs, ms, vs, ps = _lists(gt, st, pt)
        nt, scale = AR.global_norm_ref(gs, 1.0)
        assert float(nt) == pytest.approx(float(nr), rel=1e-6)
        # the update is held to the reference's own scale: a last-bit
        # difference of the two norms moves a moment that cancels to near
        # zero by more than 1e-6 of itself
        scale_r = jnp.minimum(1.0, 1.0 / (nr + 1e-9))
        assert float(scale) == pytest.approx(float(scale_r), rel=1e-6)
        step = st.step + 1
        AR.adamw_update_ref(gs, ms, vs, ps, *p.scalars(step), p.consts(),
                            torch.tensor(np.asarray(scale_r)))
        st = PA.AdamWState(step=step, mu=st.mu, nu=st.nu)
        active.append(float(scale) < 1.0)
    assert all(active) if scale_grads == 1.0 else not any(active)
    for want, got in ((pr, pt), (sr.mu, st.mu), (sr.nu, st.nu)):
        for a, b in zip(jax.tree.leaves(want), PA.tree_leaves(got)):
            a = np.asarray(a, np.float32)
            b = b.float().numpy()
            if bf:
                assert (np.abs(a - b) <= _bf16_ulp(a)).all()
            else:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("clip_active", [True, False])
@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, BF])
def test_fold_is_bit_equal_to_clip_then_update(param_dtype, state_dtype,
                                               schedule, clip_active):
    """B13's plain version with B12's scale folded into the load gives the
    bits of the in-place clip followed by the update, over 4 steps; the
    gradients are not written.  The train step's clip_and_update (the
    fold) gives the same bits and the same norm."""
    opt = P.AdamW(lr=1e-2, state_dtype=state_dtype,
                  schedule=P.cosine_schedule(2, 6) if schedule else None)
    rng = np.random.default_rng(12)
    p0 = _tree(rng)
    trees = [_torch(p0, param_dtype) for _ in range(3)]
    states = [opt.init(t) for t in trees]
    for _ in range(4):
        g = jax.tree.map(lambda x: x * (3.0 if clip_active else 0.02),
                         _tree(rng))
        gs = [_torch(g, param_dtype) for _ in range(3)]
        # the two calls
        clipped, n0 = P.clip_by_global_norm(gs[0], 1.0, inplace=True)
        trees[0], states[0] = opt.update(clipped, states[0], trees[0])
        # the fold
        g1, m1, v1, p1 = _lists(gs[1], states[1], trees[1])
        g_before = [x.clone() for x in g1]
        n1, scale = AR.global_norm_ref(g1, 1.0)
        step = states[1].step + 1
        AR.adamw_update_ref(g1, m1, v1, p1, *opt.scalars(step),
                            opt.consts(), scale)
        states[1] = PA.AdamWState(step=step, mu=states[1].mu,
                                  nu=states[1].nu)
        for a, b in zip(g1, g_before):
            assert torch.equal(_bits(a), _bits(b))
        # the train step's function
        trees[2], states[2], n2 = PA.clip_and_update(opt, gs[2], states[2],
                                                     trees[2], 1.0)
        assert (float(scale) < 1.0) == clip_active
        assert torch.equal(_bits(n0), _bits(n1))
        assert torch.equal(_bits(n0), _bits(n2))
    for k in range(1, 3):
        for a, b in zip(PA.tree_leaves([trees[0], states[0].mu,
                                        states[0].nu]),
                        PA.tree_leaves([trees[k], states[k].mu,
                                        states[k].nu])):
            assert a.dtype == b.dtype
            assert torch.equal(_bits(a), _bits(b))


def test_over_ranks_route_and_pieces_give_the_same_bits(monkeypatch):
    """The DTensor route's per-leaf hook (identity here) and a piece of 7
    elements change no bit of B12's norm and scale."""
    g = PA.tree_leaves(_torch(_tree(np.random.default_rng(13)),
                              torch.float32))
    n, s = AR.global_norm_ref(g, 0.5)
    seen = []

    def hook(i, v):
        seen.append(i)
        return v
    n2, s2 = AR.global_norm_ref(g, 0.5, hook)
    assert seen == list(range(len(g)))
    monkeypatch.setitem(AR.PIECE, "cpu", 7)
    n3, s3 = AR.global_norm_ref(g, 0.5)
    for a, b in ((n, n2), (s, s2)):
        assert torch.equal(_bits(a), _bits(b))
    assert float(n3) == pytest.approx(float(n), rel=1e-6)
    assert float(n) == pytest.approx(
        float(np.sqrt(sum((x.double() ** 2).sum() for x in g))), rel=1e-6)
    assert AR.PIECE is PA.PIECE and AR.pieces is PA.pieces


def test_wrappers_on_cpu_run_the_plain_versions():
    opt = P.AdamW(lr=1e-2)
    rng = np.random.default_rng(14)
    a, b = (_torch(_tree(np.random.default_rng(15)), torch.float32)
            for _ in range(2))
    g = _torch(_tree(rng), torch.float32)
    sa, sb = opt.init(a), opt.init(b)
    counts = (AO.global_norm_scale.launches, AO.adamw_update.launches)
    n, s = AO.global_norm_scale(PA.tree_leaves(g), 0.25)
    nr, sr = AR.global_norm_ref(PA.tree_leaves(g), 0.25)
    assert torch.equal(n, nr) and torch.equal(s, sr)
    step = torch.ones((), dtype=torch.int32)
    AO.adamw_update(*_lists(g, sa, a), *opt.scalars(step), opt.consts(), s)
    AR.adamw_update_ref(*_lists(g, sb, b), *opt.scalars(step), opt.consts(),
                        s)
    for x, y in zip(PA.tree_leaves([a, sa.mu, sa.nu]),
                    PA.tree_leaves([b, sb.mu, sb.nu])):
        assert torch.equal(x, y)
    # an empty tree is the plain version's too: the update only steps
    state = PA.AdamWState(step=torch.zeros((), dtype=torch.int32), mu={},
                          nu={})
    params, state = opt.update({}, state, {})
    assert params == {} and int(state.step) == 1
    assert (AO.global_norm_scale.launches, AO.adamw_update.launches) == counts


# ---------------------------------------------------------------------------
# The chunk table
# ---------------------------------------------------------------------------

C = AR.CHUNK
SIZES = [1, 7, C - 1, C, C + 1, 3 * C + 5]
# (p, g, m, v) byte offsets from a 512-byte aligned base, element sizes:
# bf16 p and g with float32 moments, aligned; every tensor shifted alike
# (a scalar head); shifts that disagree (element by element); float32
# throughout shifted by one element; a gradient alone, bf16 and shifted
ADDRESSES = {"aligned": ((0, 2), (0, 2), (0, 4), (0, 4)),
             "shifted": ((6, 2), (6, 2), (12, 4), (12, 4)),
             "disagree": ((2, 2), (0, 2), (4, 4), (0, 4)),
             "f32": ((4, 4), (4, 4), (4, 4), (4, 4)),
             "g only": ((0, 0), (10, 2), (0, 0), (0, 0))}


def _specs(sizes, where):
    specs = []
    for i, n in enumerate(sizes):
        base = (1 + i) << 30
        tensors = tuple((base + off, s) if s else (0, 0)
                        for off, s in ADDRESSES[where])
        specs.append(AR.LeafSpec(tensors, n, 0))
    return specs


@pytest.mark.parametrize("where", sorted(ADDRESSES))
def test_chunk_table_covers_every_leaf_once(where):
    specs = _specs(SIZES + [1], where)      # the last: a 0-dim leaf
    table, L, nC = AR.chunk_table(specs)
    assert table.dtype == np.int64 and L == len(specs)
    assert table.size == L * AR.LEAF_WORDS + nC * AR.CHUNK_WORDS
    recs = table[:L * AR.LEAF_WORDS].reshape(L, AR.LEAF_WORDS)
    regs = AR.regions(table, L)
    assert len(regs) == nC
    for leaf, spec in enumerate(specs):
        head = int(recs[leaf, 5])
        assert head == AR.leaf_head(spec.tensors)
        assert list(recs[leaf, :5]) == [a for a, _ in spec.tensors] + \
            [spec.numel]
        mine = [r for r in regs if r[0] == leaf]
        first = int(recs[leaf, 7])
        assert regs[first:first + len(mine)] == mine     # contiguous
        covered = 0
        for _, s, vs, ve, e in mine:
            assert s == covered and s <= vs <= ve <= e
            assert (ve - vs) % AR.VEC == 0 and e - ve < AR.VEC
            assert e - s <= C + AR.VEC
            if head < 0:
                assert vs == ve == e
            else:
                assert vs - s < AR.VEC
                for a, size in spec.tensors:
                    if a:
                        assert (a + size * vs) % 16 == 0 or vs == ve
            covered = e
        assert covered == spec.numel
    if where == "disagree":
        assert (recs[:, 5] == -1).all()
    if where == "aligned":
        assert (recs[:, 5] == 0).all()
        assert sum(r[3] - r[2] for r in regs) > 0.99 * sum(SIZES)


def test_leaf_head_and_chunks():
    assert AR.leaf_head([(16, 2), (32, 4)]) == 0
    assert AR.leaf_head([(18, 2)]) == 7
    assert AR.leaf_head([(20, 4)]) == 3
    assert AR.leaf_head([(18, 2), (20, 4)]) == 7
    assert AR.leaf_head([(18, 2), (24, 4)]) == -1
    assert AR.leaf_head([(17, 2)]) == -1
    assert AR.chunks([0], [0]).shape == (0, 3)
    assert AR.chunks([5], [3]).tolist() == [[0, 0, 5]]
    assert AR.chunks([2 * C + 1], [3]).tolist() == [[0, 0, C + 3],
                                                     [0, C + 3, 2 * C + 1]]
    assert AR.chunks([C + 3], [3]).tolist() == [[0, 0, C + 3]]
    assert AR.chunks([C + 1, 0, 2], [-1, 0, 5]).tolist() == [
        [0, 0, C], [0, C, C + 1], [2, 0, 2]]
    # an empty leaf has no chunk; its leaf sum is 0
    table, L, nC = AR.chunk_table(_specs([0, 9], "aligned"))
    assert (L, nC) == (2, 1) and table[7] == 0 and table[15] == 0


def test_dtype_codes_of_the_wrappers_records():
    p = torch.zeros(5, dtype=BF)
    g = torch.zeros(5, dtype=torch.float32)
    m = torch.zeros(5, dtype=BF)
    spec = AO._spec(g, p, m, m.clone())
    assert spec.code == AR.P_BF16 | AR.MV_BF16 and spec.numel == 5
    assert spec.tensors[0] == (p.data_ptr(), 2)
    assert AO._spec(g.to(BF)).code == AR.G_BF16
    assert AO._spec(g.to(BF)).tensors[0] == (0, 0)
    with pytest.raises(ValueError, match="share a dtype"):
        AO._spec(g, p, m, g.clone())
    with pytest.raises(ValueError, match="contiguous"):
        AO._spec(torch.zeros(4, 4).t())


def test_build_source_and_constants():
    src = [s for s in _build.SOURCES if str(s.path) == "adamw/csrc/adamw.cu"]
    assert len(src) == 1 and src[0].flags == _build.EXACT_FLAGS
    assert "-fmad=false" in src[0].flags
    assert set(src[0].entry_points) == {"adamw_norm_partials",
                                        "adamw_norm_finish", "adamw_update"}
    text = (_build.KERNELS / src[0].path).read_text()
    assert re.search(r"constexpr int kVec = (\d+);", text).group(1) == \
        str(AR.VEC)
    assert "struct Leaf {\n  int64_t p, g, m, v, n, head, code, first;" in text
    assert "struct Chunk {\n  int64_t leaf, start, end, pad;" in text
    assert re.search(r"kPBf16 = (\d+), kGBf16 = (\d+), kMvBf16 = (\d+)",
                     text).groups() == tuple(
        str(c) for c in (AR.P_BF16, AR.G_BF16, AR.MV_BF16))
    for fn in ("__fdiv_rn", "__fsqrt_rn", "__fmul_rn", "__fadd_rn"):
        assert fn in text
