"""The port's LM layers, exit gate, decode attention and decode step vs the
JAX package.

The same inputs, drawn from a seed with numpy, go through the reference
function and its counterpart in the port (on the CPU, where the port's
kernel wrappers run their plain versions), with these tolerances:

* exit gate (B6): the plain version against the reference's Pallas kernel
  in interpret mode, conf to a relative 1e-5 (sums in another order), the
  argmax exactly;
* decode attention (B7): the plain version, and the float32 mirror of the
  CUDA kernel's split-and-merge arithmetic, against the reference's Pallas
  kernel in interpret mode, rtol = atol = 2e-5 in float32 and 2e-2 in bf16
  (the reference's own kernel-vs-oracle tolerances); the kernel's split
  plan covers the cache with whole tiles;
* ``rmsnorm``, ``apply_rope``, ``mlp_apply``, ``attn_decode_step`` and
  ``exit_head_apply``: 1e-5 in float32 (the same arithmetic in another
  summation order);
* ``decode_step`` logits and exit logits over 6 steps: 1e-4.

Weights come from the reference's ``init_model`` through
``convert.transformer_params_from``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get as ref_get
from repro.kernels.decode_attn.ops import decode_attn as ref_decode_attn
from repro.kernels.ee_gate.ops import ee_gate as ref_ee_gate
from repro.kernels.ee_gate.ref import ee_gate_ref as ref_ee_gate_oracle
from repro.models import attention as RA
from repro.models import early_exit as RE
from repro.models import layers as RL
from repro.models import transformer as RT

from repro_torch.configs import ARCH_NAMES, get
from repro_torch.configs.base import LayerSpec
from repro_torch.convert import transformer_params_from
from repro_torch.kernels.decode_attn import ops as attn_ops
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.kernels.decode_attn.ref import (decode_attn_ref,
                                                 decode_attn_split_ref)
from repro_torch.kernels.ee_gate.ops import ee_gate, gate_plan, gate_slices
from repro_torch.kernels.ee_gate.ref import ee_gate_ref, ee_gate_split_ref
from repro_torch.models import attention as TA
from repro_torch.models import early_exit as TE
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32).copy())


def _both(x, dtype):
    """One float32 numpy array as (jnp, torch) arrays of ``dtype``; both
    round a float32 to bf16 to nearest-even, so the inputs are equal."""
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    return jnp.asarray(x, jnp.float32), _t(x)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", REF_ARCH_NAMES)
def test_configs_equal_reference(arch, reduced):
    """Every architecture comes across as data: all fields and the derived
    exits, padded vocab, periods and head width."""
    assert ARCH_NAMES == REF_ARCH_NAMES
    ref, got = ref_get(arch, reduced=reduced), get(arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.exit_layer_list == ref.exit_layer_list
    assert got.padded_vocab == ref.padded_vocab
    assert got.n_periods == ref.n_periods
    if ref.n_heads:
        assert got.head_dim_ == ref.head_dim_


# ---------------------------------------------------------------------------
# B6: the exit gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,V", [(1, 128), (8, 2048), (5, 5000), (16, 50304),
                                 (2, 131)])
def test_ee_gate_plain_matches_pallas(B, V, dtype, tail):
    """conf to a relative 1e-5 and the argmax exactly, with and without a
    -inf padded tail."""
    x = np.random.default_rng(B + V).normal(size=(B, V)).astype(np.float32)
    x *= 4
    if tail:
        x[:, V - tail:] = -np.inf
    xj, xt = _both(x, dtype)
    conf_r, arg_r = ref_ee_gate(xj)
    conf, arg = ee_gate(xt)
    assert conf.dtype == torch.float32 and arg.dtype == torch.int32
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_r), rtol=1e-5)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(arg_r))


def test_ee_gate_peaked_and_ties():
    """A confident row gives conf ~ 1 at its token; a tie keeps the first
    index; an all -inf row gives index 0, as both reference versions, and
    conf 1/V, the max softmax probability of a uniform row.  There the
    reference's versions disagree with each other: its Pallas kernel counts
    its own -inf padding (1/2048), its oracle loses log(V) against the
    NEG clamp in ``m + log(sum)`` and returns 1."""
    x = np.full((3, 512), -5.0, np.float32)
    x[0, 77] = 20.0
    x[1, [300, 40]] = 20.0
    x[2] = -np.inf
    conf, arg = ee_gate(_t(x))
    conf_r, arg_r = ref_ee_gate(jnp.asarray(x))
    conf_o, arg_o = ref_ee_gate_oracle(jnp.asarray(x))
    assert arg.tolist() == [77, 40, 0] == np.asarray(arg_r).tolist() \
        == np.asarray(arg_o).tolist()
    assert conf[0] > 0.999 and float(conf[2]) == 1 / 512
    for want in (conf_r, conf_o):
        np.testing.assert_allclose(conf[:2].numpy(), np.asarray(want)[:2],
                                   rtol=1e-5)


def _split_gate_rows(V, P, seed):
    """Rows whose first max sits on either side of a slice boundary of the
    P-way split: row 0 ties at the last element of slice 0 and the first
    of slice 1, row 1 at the first of slice 1 and the last of the row's
    last non-empty slice, row 2 has its max only in the last slice, row 3
    is all -inf, row 4 ties across every boundary."""
    x = np.random.default_rng(seed).normal(size=(5, V)).astype(np.float32)
    x *= 4
    cuts = [lo for lo, hi in gate_slices(V, P) if lo < hi][1:] or [V // 2]
    b, last = cuts[0], V - 1
    x[0, [b - 1, b]] = 40.0
    x[1, [b, last]] = 40.0
    x[2, last] = 41.0
    x[3] = -np.inf
    for c in cuts:
        x[4, [c - 1, c]] = 50.0
    return x, [b - 1, b, last, 0, cuts[0] - 1]


@pytest.mark.parametrize("B,V", [(4, 153600), (1, 4097), (5, 5000),
                                 (1, 2047), (1, 2048), (1, 2049),
                                 (16, 50304), (130, 4096)])
def test_gate_plan_fills_the_card_and_slices_cover_the_row(B, V):
    """B6's split: about one block an SM at the serving batch (P = 33 at
    [4, 153,600]), at least GATE_MIN_SLICE elements a block, P = 1 once
    B fills the SMs; the slices are contiguous, ascending, a multiple of 8
    wide, and cover [0, V)."""
    P = gate_plan(B, V, 132)
    assert 1 <= P and B * P <= 132 + B
    assert P <= -(-V // 2048)
    if (B, V) == (4, 153600):
        assert P == 33
    if B >= 132 or V <= 2048:
        assert P == 1
    cuts = gate_slices(V, P)
    assert cuts[0][0] == 0 and cuts[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert all((hi - lo) % 8 == 0 for lo, hi in cuts[:-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,P", [(4097, 3), (4097, 2), (5000, 7), (2049, 2),
                                 (153600, 33), (20, 5), (9, 1)])
def test_ee_gate_split_model_matches_plain(V, P, dtype):
    """The kernel's split-and-merge order on the CPU (ee_gate_split_ref):
    first-max ties on both sides of a slice boundary keep the lower index,
    an all -inf row gives conf 1/V and index 0, empty trailing slices
    (V = 20, P = 5) are the identity; conf within 1e-5 relative of the
    plain version, the argmax exact."""
    x, want_arg = _split_gate_rows(V, P, V + P)
    xt = _t(x) if dtype == "float32" else _t(x).bfloat16()
    conf, arg = ee_gate_split_ref(xt, P)
    conf_p, arg_p = ee_gate_ref(xt)
    assert arg.tolist() == arg_p.tolist() == want_arg
    torch.testing.assert_close(conf, conf_p, rtol=1e-5, atol=0)
    assert float(conf[3]) == pytest.approx(1 / V, rel=1e-6)


def test_kernel_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="device"):
        ee_gate(torch.empty(2, 8, device="meta"))
    q = torch.empty(1, 2, 4, device="meta")
    kv = torch.empty(1, 3, 2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        decode_attn(q, kv, kv, torch.empty(3, dtype=torch.int32,
                                           device="meta"), 1)


# ---------------------------------------------------------------------------
# B7: decode attention
# ---------------------------------------------------------------------------

def _attn_inputs(B, H, KV, D, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, D)).astype(np.float32),
            rng.normal(size=(B, T, KV, D)).astype(np.float32),
            rng.normal(size=(B, T, KV, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,D,T,bt", [
    (1, 4, 4, 32, 128, 64),       # MHA
    (2, 8, 2, 64, 256, 128),      # GQA 4:1
    (1, 8, 1, 64, 300, 128),      # MQA, ragged T
    (3, 4, 2, 16, 64, 64),        # single block
    (2, 8, 2, 80, 96, 32),        # qwen3-4b's head width
])
def test_decode_attn_plain_matches_pallas(B, H, KV, D, T, bt, dtype):
    q, k, v = _attn_inputs(B, H, KV, D, T, B + H + T)
    cache_pos = np.arange(T, dtype=np.int32)
    pos = T - 3                       # the last slots are in the future
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    want = ref_decode_attn(qj, kj, vj, jnp.asarray(cache_pos), jnp.int32(pos),
                           block_t=bt)
    got = decode_attn(qt, kt, vt, torch.from_numpy(cache_pos), pos)
    assert got.dtype == qt.dtype
    _close(got.float(), want, 2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("window", [16, 64])
def test_decode_attn_sliding_window(window):
    B, H, KV, D, T = 1, 4, 2, 32, 256
    q, k, v = _attn_inputs(B, H, KV, D, T, 9)
    cache_pos = np.arange(T, dtype=np.int32)
    want = ref_decode_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(cache_pos), jnp.int32(T - 1),
                           window=window, block_t=64)
    got = decode_attn(_t(q), _t(k), _t(v), torch.from_numpy(cache_pos),
                      T - 1, window=window)
    _close(got, want, 2e-5)


def test_decode_attn_empty_slots_masked():
    """Slots with cache_pos = -1 contribute nothing."""
    B, H, KV, D, T = 1, 2, 2, 16, 64
    q, k, v = _attn_inputs(B, H, KV, D, T, 5)
    cache_pos = np.where(np.arange(T) < 10, np.arange(T), -1).astype(np.int32)
    want = ref_decode_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(cache_pos), jnp.int32(9), block_t=32)
    got = decode_attn(_t(q), _t(k), _t(v), torch.from_numpy(cache_pos), 9)
    short = decode_attn(_t(q), _t(k[:, :10]), _t(v[:, :10]),
                        torch.from_numpy(cache_pos[:10]), 9)
    _close(got, want, 2e-5)
    _close(got, short, 2e-5)


@pytest.mark.parametrize("T", [1, 31, 64, 255, 256, 257, 300, 513, 1000,
                               4097, 8192, 32768])
@pytest.mark.parametrize("B,KV,D,itemsize", [(1, 1, 80, 2), (1, 8, 80, 2),
                                             (2, 2, 128, 2), (4, 8, 80, 2),
                                             (3, 5, 64, 4), (64, 8, 80, 2)])
def test_split_plan_covers_the_cache_with_whole_tiles(B, KV, D, itemsize, T):
    """1 <= P <= 8; the ranges cover [0, T) in order with none empty and
    none shorter than a tile; P = 1 when T is one tile or less; B*KV*P
    stays within the block target, and P is the largest that does."""
    P = attn_ops.split_plan(B, KV, T, D, itemsize)
    tile = attn_ops.tile_slots(D, itemsize)
    assert 1 <= P <= attn_ops.MAX_CLUSTER
    ranges = attn_ops.split_ranges(T, P)
    assert len(ranges) == P and ranges[0][0] == 0 and ranges[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi - lo >= (tile if P > 1 else 1) for lo, hi in ranges)
    if T <= tile:
        assert P == 1
    assert P == 1 or B * KV * P <= attn_ops.TARGET_BLOCKS
    assert P == attn_ops.MAX_CLUSTER or T // (P + 1) < tile or \
        B * KV * (P + 1) > attn_ops.TARGET_BLOCKS


def test_split_plan_at_the_serving_shape():
    """qwen3-4b's B = 4, KV = 8 in bf16 (256-slot tiles): one block a
    (sequence, kv-head) at T = 256, clusters of 3 (96 blocks of a third of
    the cache) at T = 8192 and 32,768."""
    for T, P, per in ((256, 1, {256}), (8192, 3, {2730, 2731}),
                      (32768, 3, {10922, 10923})):
        assert attn_ops.split_plan(4, 8, T) == P
        assert {hi - lo for lo, hi in attn_ops.split_ranges(T, P)} == per


def _split_case(case):
    """(B, H, KV, D, T, P, cache_pos, pos, window, block_t) of a mirror
    check; block_t divides T where no slot is live, since the Pallas
    kernel's padding slots would join the uniform average."""
    B, H, KV, D, T, P = {
        "ragged": (2, 8, 2, 32, 300, 7),        # T % P != 0, empty warps
        "dead_range": (1, 8, 2, 64, 256, 8),    # rank 2's slots empty
        "future_range": (1, 4, 1, 32, 256, 5),  # the last range beyond pos
        "window": (1, 4, 2, 32, 256, 8),        # all but one range out
        "no_live": (2, 4, 2, 16, 128, 4),       # the uniform average
        "qwen_widths": (1, 32, 8, 80, 600, 2),
    }[case]
    cache_pos = np.arange(T, dtype=np.int32)
    pos, window = T - 3, 0
    ranges = attn_ops.split_ranges(T, P)
    if case == "dead_range":
        lo, hi = ranges[2]
        cache_pos[lo:hi] = -1
    elif case == "future_range":
        pos = ranges[-1][0] - 1
    elif case == "window":
        pos, window = T - 1, 16
    elif case == "no_live":
        cache_pos[:] = -1
    if case == "qwen_widths":
        assert P == attn_ops.split_plan(B, KV, T)
    return B, H, KV, D, T, P, cache_pos, pos, window, 32 if T % 64 else 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ragged", "dead_range", "future_range",
                                  "window", "no_live", "qwen_widths"])
def test_decode_attn_split_mirror_matches_pallas(case, dtype):
    """The CUDA kernel's split over a cluster and its merges, mirrored in
    float32, against the reference's Pallas kernel and the plain version."""
    B, H, KV, D, T, P, cache_pos, pos, window, bt = _split_case(case)
    q, k, v = _attn_inputs(B, H, KV, D, T, T + P)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    want = ref_decode_attn(qj, kj, vj, jnp.asarray(cache_pos), jnp.int32(pos),
                           window=window, block_t=bt)
    cp = torch.from_numpy(cache_pos)
    got = decode_attn_split_ref(qt, kt, vt, cp, pos, P, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.dtype == qt.dtype
    _close(got.float(), want, tol)
    _close(got.float(), decode_attn_ref(qt, kt, vt, cp, pos,
                                        window=window).float(), tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_mlp_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(TL.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6),
           RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6),
           1e-5)
    xr = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        _close(TL.apply_rope(_t(xr), torch.from_numpy(pos), theta),
               RL.apply_rope(jnp.asarray(xr), jnp.asarray(pos), theta), 1e-5)
    w = {n: rng.normal(size=s).astype(np.float32) / 8 for n, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    _close(TL.mlp_apply({n: _t(a) for n, a in w.items()}, _t(x)),
           RL.mlp_apply({n: jnp.asarray(a) for n, a in w.items()},
                        jnp.asarray(x)), 1e-5)


def test_lm_head_masks_padded_tail_like_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 1, 16)).astype(np.float32)
    w = rng.normal(size=(16, 40)).astype(np.float32)
    got = TL.lm_head_apply({"w": _t(w)}, _t(x), 33)
    want = RL.lm_head_apply({"w": jnp.asarray(w)}, jnp.asarray(x), 33)
    assert torch.isinf(got[..., 33:]).all() and got.dtype == torch.float32
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _cfg(variant):
    """Reduced qwen3-4b (f32) and variants that exercise the other decode
    paths: two exits, an int8 cache, a sliding-window ring buffer."""
    cfg = ref_get("qwen3-4b", reduced=True)
    return {
        "base": cfg,
        "two_exits": dataclasses.replace(cfg, n_layers=3, exit_layers=(1, 2)),
        "int8": dataclasses.replace(cfg, kv_cache_dtype="int8"),
        "window": dataclasses.replace(cfg, sliding_window=4),
    }[variant]


def _models(variant, seed=0):
    ref_cfg = _cfg(variant)
    cfg = dataclasses.replace(get("qwen3-4b", reduced=True), **{
        f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)
        if f.name != "pattern"})
    params_r = RT.init_model(jax.random.PRNGKey(seed), ref_cfg)
    params = transformer_params_from(jax.tree.map(np.asarray, params_r), cfg,
                                     device="cpu")
    return ref_cfg, cfg, params_r, params


@pytest.mark.parametrize("variant", ["base", "int8", "window"])
def test_attn_decode_step_matches_reference(variant):
    """Ten steps through one layer's cache (the ring buffer wraps under the
    window): outputs within 1e-5, slot positions equal."""
    ref_cfg, cfg, params_r, params = _models(variant)
    p_r = jax.tree.map(lambda x: x[0], params_r["layers"]["l0"]["mix"])
    p_t = {k: (v[0] if not isinstance(v, dict) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in params["layers"]["l0"]["mix"].items()}
    B, T = 2, 8
    c_r = RA.cache_spec(ref_cfg, B, T).init(jnp.float32)
    c_t = TA.cache_spec(cfg, B, T).init(torch.float32, CPU)
    rng = np.random.default_rng(11)
    step = jax.jit(lambda p, x, c, pos: RA.attn_decode_step(p, ref_cfg, x, c,
                                                            pos))
    for pos in range(10):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        y_r, c_r = step(p_r, jnp.asarray(x), c_r, jnp.int32(pos))
        y_t, c_t = TA.attn_decode_step(p_t, cfg, _t(x), c_t, pos)
        _close(y_t, y_r, 1e-5)
        np.testing.assert_array_equal(c_t["pos"].numpy(),
                                      np.asarray(c_r["pos"]))
        if variant == "int8":
            _close(c_t["k_scale"], c_r["k_scale"], 1e-6)
        else:
            _close(c_t["k"], c_r["k"], 1e-5)


def test_exit_head_and_gate_statistics_match_reference():
    ref_cfg, cfg, params_r, params = _models("base")
    rng = np.random.default_rng(2)
    h = rng.normal(size=(4, 3, cfg.d_model)).astype(np.float32)
    head_r = RT._lm_head_params(params_r, ref_cfg)
    head_t = TT._lm_head_params(params, cfg)
    lr = RE.exit_head_apply(params_r["exits"]["exit_1"], ref_cfg,
                            jnp.asarray(h), head_r)
    lt = TE.exit_head_apply(params["exits"]["exit_1"], cfg, _t(h), head_t)
    _close(lt, lr, 1e-5)
    _close(TE.confidence_ref(lt), RE.confidence_ref(lr), 1e-5)
    logits = {"exit_1": lt * 40, "exit_2": lt * 80}
    thr = {"exit_1": float(np.median(TE.confidence_ref(lt * 40).numpy())),
           "exit_2": 0.0}
    got = TE.exit_statistics(logits, thr)
    want = RE.exit_statistics({k: jnp.asarray(v.numpy())
                               for k, v in logits.items()}, thr)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert TE.measure_phi(got) == RE.measure_phi(want)


@pytest.mark.parametrize("variant", ["base", "two_exits", "int8", "window"])
def test_decode_step_matches_reference(variant):
    """Six steps: final and exit logits within 1e-4, the caches' slot
    positions equal."""
    ref_cfg, cfg, params_r, params = _models(variant)
    B, T = 3, 16
    c_r = RT.init_caches(ref_cfg, B, T)
    c_t = TT.init_caches(cfg, B, T, device=CPU)
    dec = jax.jit(lambda p, c, t, pos: RT.decode_step(p, ref_cfg, t, c, pos))
    rng = np.random.default_rng(1)
    for pos in range(6):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        l_r, c_r, e_r = dec(params_r, c_r, jnp.asarray(toks), jnp.int32(pos))
        l_t, c_t, e_t = TT.decode_step(params, cfg, torch.from_numpy(toks),
                                       c_t, pos)
        assert l_t.shape == (B, cfg.padded_vocab) and set(e_t) == set(e_r)
        _close(l_t, l_r, 1e-4)
        for name in e_r:
            _close(e_t[name], e_r[name], 1e-4)
    np.testing.assert_array_equal(c_t["l0"]["pos"].numpy(),
                                  np.asarray(c_r["l0"]["pos"]))


def _shape_dtypes(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape),
             str(x.dtype).replace("torch.", ""))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", REF_ARCH_NAMES)
def test_init_model_and_caches_mirror_reference_tree(arch, dtype):
    """Same tree, shapes and dtypes as the reference's params and caches,
    for every architecture (attention, SSM, MoE, hybrid, encoder-only):
    the SSM decay / skip terms and the router stay float32 in bf16."""
    ref_cfg = dataclasses.replace(ref_get(arch, reduced=True), dtype=dtype)
    cfg = dataclasses.replace(get(arch, reduced=True), dtype=dtype)
    params_r = jax.eval_shape(lambda: RT.init_model(jax.random.PRNGKey(0),
                                                    ref_cfg))
    params = TT.init_model(cfg, seed=0, device=CPU)
    assert _shape_dtypes(params) == _shape_dtypes(params_r)
    assert TT.param_count(params) == RT.param_count(params_r)
    c_r = RT.init_caches(ref_cfg, 2, 8)
    c_t = TT.init_caches(cfg, 2, 8, device=CPU)
    assert _shape_dtypes(c_t) == _shape_dtypes(c_r)
    for i, spec in enumerate(cfg.pattern):
        if spec.kind == "attn":
            assert (c_t[f"l{i}"]["pos"] == -1).all()
        else:
            assert not c_t[f"l{i}"]["state"].any()


def test_init_model_rejects_unknown_layer_kinds():
    cfg = get("qwen3-4b", reduced=True)
    for spec in (LayerSpec("conv", "dense"), LayerSpec("attn", "sparse")):
        with pytest.raises(ValueError, match="unknown"):
            TT.init_model(dataclasses.replace(cfg, pattern=(spec,)),
                          device=CPU)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mixtral-8x22b",
                                  "arctic-480b"])
def test_transformer_params_from_carries_ssm_and_moe_leaves(arch):
    """A bf16 reference tree with SSM and MoE layers: every leaf comes
    across bit for bit in its own dtype (A_log, D, dt_bias and the router
    float32), and a MoE key the port does not read raises."""
    ref_cfg = dataclasses.replace(ref_get(arch, reduced=True),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(get(arch, reduced=True), dtype="bfloat16")
    pnp = jax.tree.map(np.asarray,
                       RT.init_model(jax.random.PRNGKey(1), ref_cfg))
    got = transformer_params_from(pnp, cfg, device="cpu")
    flat_r = jax.tree_util.tree_flatten_with_path(pnp)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_t] == \
        [jax.tree_util.keystr(p) for p, _ in flat_r]
    for (path, want), (_, t) in zip(flat_r, flat_t):
        name = jax.tree_util.keystr(path)
        f32 = any(k in name for k in ("A_log", "'D'", "dt_bias", "router"))
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
        np.testing.assert_array_equal(t.float().numpy(),
                                      want.astype(np.float32))
    moe = next(f"l{i}" for i, s in enumerate(cfg.pattern) if s.mlp == "moe"
               ) if cfg.n_experts else None
    if moe is not None:
        pnp["layers"][moe]["mlp"]["w_extra"] = pnp["layers"][moe]["mlp"][
            "w_up"]
        with pytest.raises(ValueError, match="keys"):
            transformer_params_from(pnp, cfg, device="cpu")


def test_transformer_params_from_checks_the_tree():
    ref_cfg, cfg, params_r, _ = _models("base")
    pnp = jax.tree.map(np.asarray, params_r)
    with pytest.raises(ValueError, match="keys"):
        transformer_params_from({k: v for k, v in pnp.items()
                                 if k != "lm_head"}, cfg, device="cpu")
    with pytest.raises(ValueError, match="exit heads"):
        transformer_params_from({**pnp, "exits": {}}, cfg, device="cpu")
    bad = jax.tree.map(lambda x: x, pnp)
    bad["layers"]["l0"]["mix"]["wz"] = bad["layers"]["l0"]["mix"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        transformer_params_from(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda x: x, pnp)
    bad["layers"]["l0"]["norm1"] = bad["layers"]["l0"]["norm1"]["scale"]
    with pytest.raises(ValueError, match="keys"):
        transformer_params_from(bad, cfg, device="cpu")
    bf = transformer_params_from(
        jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                     params_r), cfg, device="cpu")
    assert bf["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"]["table"].float().numpy(),
        np.asarray(jnp.asarray(params_r["embed"]["table"], jnp.bfloat16),
                   np.float32))
