"""The port's AdamW and gradient utilities vs the JAX package's.

The same parameters and the same ten steps of gradients, drawn from a seed
with numpy, go through ``repro.optim.AdamW.update`` and the port's on the
CPU, with weight decay and the cosine schedule: float32 moments and
parameters within a relative 1e-6; bf16 moments and parameters within one
bf16 ulp.  The port's update runs in place and over pieces of a leaf; a
piece size of a few elements gives the same bits as whole leaves.  Then
``global_norm``, ``clip_by_global_norm`` and the gradient compression
round trips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as P
from repro_torch.optim import adamw as PA


def _tree(rng, dtype=np.float32):
    return {"w": rng.normal(size=(8, 4)).astype(dtype),
            "b": rng.normal(size=(4,)).astype(dtype),
            "layers": {"stack": rng.normal(size=(3, 5, 6)).astype(dtype),
                       "norm": rng.normal(size=(3, 6)).astype(dtype)}}


def _jnp(tree, dtype=None):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype=dtype), tree)


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda x: torch.from_numpy(
        np.asarray(x, np.float32)).to(dtype), tree)


def _np(tree):
    return jax.tree.map(lambda x: x.float().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32), tree)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (the spacing above it; 2^-133 at zero)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _run(opt_r, opt_p, steps=10, seed=0, state_dtype=None):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    bf = state_dtype == "bfloat16"
    pr = _jnp(p0, jnp.bfloat16 if bf else None)
    pt = _torch(p0, torch.bfloat16 if bf else torch.float32)
    sr, st = opt_r.init(pr), opt_p.init(pt)
    for g in grads:
        gr = _jnp(g, jnp.bfloat16 if bf else None)
        gt = _torch(g, torch.bfloat16 if bf else torch.float32)
        pr, sr = opt_r.update(gr, sr, pr)
        pt, st = opt_p.update(gt, st, pt)
    assert int(st.step) == int(sr.step) == steps
    return (pr, sr), (pt, st)


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_f32_matches_reference(schedule):
    kw = dict(lr=1e-2, weight_decay=0.1)
    r = R.AdamW(schedule=R.cosine_schedule(3, 10) if schedule else None,
                **kw)
    p = P.AdamW(schedule=P.cosine_schedule(3, 10) if schedule else None,
                **kw)
    (pr, sr), (pt, st) = _run(r, p)
    for want, got in ((pr, pt), (sr.mu, st.mu), (sr.nu, st.nu)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, a, rtol=1e-6, atol=1e-12), _np(want), _np(got))


def test_adamw_bf16_moments_within_one_ulp():
    kw = dict(lr=1e-2, weight_decay=0.1, state_dtype="bfloat16",
              schedule=None)
    (pr, sr), (pt, st) = _run(R.AdamW(**kw), P.AdamW(**kw),
                              state_dtype="bfloat16")
    for want, got in ((pr, pt), (sr.mu, st.mu), (sr.nu, st.nu)):
        for a, b in zip(jax.tree.leaves(_np(want)), jax.tree.leaves(_np(got))):
            assert b.dtype == np.float32
            assert (np.abs(a - b) <= _bf16_ulp(a)).all()
    assert all(x.dtype == torch.bfloat16 for x in PA.tree_leaves(st.mu))


def test_update_in_pieces_is_bit_equal(monkeypatch):
    """A piece of a few elements (a period of a stacked leaf, rows of a
    matrix) gives the bits of whole-leaf updates."""
    opt = P.AdamW(lr=1e-2, schedule=P.cosine_schedule(2, 6))
    (_, _), (whole, sw) = _run(R.AdamW(), opt, steps=4)
    monkeypatch.setitem(PA.PIECE, "cpu", 7)
    assert len(list(PA.pieces(torch.zeros(3, 5, 6)))) == 3
    assert len(list(PA.pieces(torch.zeros(8, 4)))) == 8
    (_, _), (cut, sc) = _run(R.AdamW(), opt, steps=4)
    for a, b in zip(PA.tree_leaves([whole, sw.mu, sw.nu]),
                    PA.tree_leaves([cut, sc.mu, sc.nu])):
        assert torch.equal(a, b)


def test_update_is_in_place_and_state_tree_order():
    params = _torch(_tree(np.random.default_rng(1)))
    opt = P.AdamW()
    st = opt.init(params)
    ids = [id(x) for x in PA.tree_leaves(params)]
    new, st2 = opt.update(_torch(_tree(np.random.default_rng(2))), st, params)
    assert [id(x) for x in PA.tree_leaves(new)] == ids
    assert st2.mu is st.mu and st2._fields == ("step", "mu", "nu")
    assert st2.step.dtype == torch.int32 and st2.step.dim() == 0
    # leaves in jax's order: sorted keys
    ref = jax.tree.leaves(_tree(np.random.default_rng(1)))
    for a, b in zip(ref, PA.tree_leaves(params)):
        assert a.shape == tuple(b.shape)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    np.testing.assert_allclose(float(P.global_norm(_torch(tree))),
                               float(R.global_norm(_jnp(tree))), rtol=1e-6)
    for max_norm in (0.5, 1e4):
        cr, nr = R.clip_by_global_norm(_jnp(tree), max_norm)
        ct, nt = P.clip_by_global_norm(_torch(tree), max_norm)
        np.testing.assert_allclose(float(nt), float(nr), rtol=1e-6)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, a, rtol=1e-6), _np(cr), _np(ct))
    # in place: the same tensors, the same numbers
    inp = _torch(tree)
    ids = [id(x) for x in PA.tree_leaves(inp)]
    ci, ni = P.clip_by_global_norm(inp, 0.5, inplace=True)
    assert [id(x) for x in PA.tree_leaves(ci)] == ids
    ct, _ = P.clip_by_global_norm(_torch(tree), 0.5)
    for a, b in zip(PA.tree_leaves(ci), PA.tree_leaves(ct)):
        assert torch.equal(a, b)
    # below the threshold the tree comes back unchanged; above it, at norm 1
    small = {"a": torch.full((4,), 0.1)}
    out, _ = P.clip_by_global_norm(small, 1.0)
    assert torch.equal(out["a"], small["a"])
    big, n = P.clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert float(n) == pytest.approx(np.sqrt(1000.0), rel=1e-6)
    assert float(P.global_norm(big)) == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_matches_reference():
    """Within a relative 1e-6: the two libraries' float32 cosines may
    differ in the last ulp."""
    fr, fp = R.cosine_schedule(5, 40), P.cosine_schedule(5, 40)
    for s in range(0, 45):
        assert float(fp(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(fr(jnp.asarray(s, jnp.int32))), rel=1e-6,
                          abs=1e-12)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compression_round_trip_matches_reference(mode):
    tree = _tree(np.random.default_rng(4))
    cr = R.compress_grads(_jnp(tree), mode)
    ct = P.compress_grads(_torch(tree), mode)
    if mode == "int8":
        for (qa, sa), (qb, sb) in zip(
                jax.tree.leaves(cr, is_leaf=lambda t: isinstance(t, tuple)),
                PA.tree_leaves(ct)):
            assert qb.dtype == torch.int8
            np.testing.assert_array_equal(qb.numpy(), np.asarray(qa))
            assert float(sb) == float(sa)
    dr = R.decompress_grads(cr, mode)
    dt = P.decompress_grads(ct, mode)
    for a, b in zip(jax.tree.leaves(dr), PA.tree_leaves(dt)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    if mode == "none":
        assert dt is not None and PA.tree_leaves(dt)[0].dtype == torch.float32
    with pytest.raises(ValueError):
        P.compress_grads(_torch(tree), "fp8")
    with pytest.raises(ValueError):
        P.decompress_grads(ct, "fp8")
