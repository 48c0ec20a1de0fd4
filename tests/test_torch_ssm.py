"""The port's Mamba-2 (SSD) mixer vs the JAX package.

The same inputs, drawn from a seed with numpy, go through the reference's
``repro.models.ssm`` and the port's on the CPU, in float32, within
rtol = atol = 1e-4: the chunked scan across chunk sizes and a ragged
sequence (zero-padded to a chunk multiple), the full-sequence mixer with
its decode cache (including a prompt shorter than the conv window), and
the recurrent decode step over six steps, from a zeroed cache and from a
prefill cache.  The weights are the reference's ``ssm_init`` draws; the
decay ``A_log``, the skip ``D`` and ``dt_bias`` are re-drawn away from
their init constants so that every term is exercised.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import ssm as RS

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import ssm as TS

TOL = 1e-4


def _port_cfg(ref_cfg) -> ArchConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["pattern"] = tuple(LayerSpec(s.kind, s.mlp) for s in ref_cfg.pattern)
    return ArchConfig(**kw)


def _cfgs(**over):
    ref = dataclasses.replace(ref_get("mamba2-1.3b", reduced=True), **over)
    return ref, _port_cfg(ref)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _params(ref_cfg, seed=0):
    """Reference weights with the per-head terms drawn from a seed, as
    (jnp tree, torch tree)."""
    p = RS.ssm_init(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    H = p["A_log"].shape[0]
    p["A_log"] = rng.uniform(-1.0, 1.0, H).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    p["dt_bias"] = rng.uniform(-1.0, 1.0, H).astype(np.float32)
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32)
    p["norm"]["scale"] = rng.uniform(0.5, 1.5, p["norm"]["scale"].shape
                                     ).astype(np.float32)
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), p))


def _x(B, S, d, seed):
    return (np.random.default_rng(seed).normal(size=(B, S, d)) * 0.5
            ).astype(np.float32)


def test_dims_and_cache_shapes_match_reference():
    ref_cfg, cfg = _cfgs()
    full_ref, full = ref_get("mamba2-1.3b"), _port_cfg(ref_get("mamba2-1.3b"))
    for r, c in ((ref_cfg, cfg), (full_ref, full)):
        assert TS.ssm_dims(c) == RS.ssm_dims(r)
        assert TS.ssm_cache_shape(c, 3) == RS.ssm_cache_shape(r, 3)
    got = TS.ssm_cache_init(cfg, 2, torch.bfloat16, "cpu")
    want = RS.ssm_cache_init(ref_cfg, 2, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in want.items()}


def test_init_tree_matches_reference():
    """Names, shapes and dtypes; A_log / D / dt_bias float32 in a bf16
    layer, the rest in the layer's dtype."""
    ref_cfg, cfg = _cfgs()
    want = RS.ssm_init(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
    got = TS.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      "cpu")
    view = lambda t: jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)
                                             .replace("torch.", "")), t)
    assert view(got) == view(want)


def test_softplus_is_logaddexp():
    x = np.array([-80.0, -20.0, -1.0, 0.0, 0.5, 19.0, 20.0, 21.0, 25.0,
                  80.0], np.float32)
    got = TS.softplus(torch.from_numpy(x))
    want = jax.nn.softplus(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("S", [1, 2, 7])
def test_causal_conv_matches_reference(S):
    ref_cfg, _ = _cfgs()
    p_r, p_t = _params(ref_cfg, seed=S)
    x = _x(2, S, p_r["conv_w"].shape[1], S)
    want = RS._causal_conv(p_r["conv_w"], p_r["conv_b"], jnp.asarray(x))
    got = TS._causal_conv(p_t["conv_w"], p_t["conv_b"], torch.from_numpy(x))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("chunk", [4, 8, 64])
@pytest.mark.parametrize("S", [16, 19, 21])
def test_ssd_scan_matches_reference(chunk, S):
    """Outputs and the final state, across chunk sizes, with S a chunk
    multiple or ragged (zero-padded) and one chunk longer than S."""
    ref_cfg, cfg = _cfgs(ssm_chunk=chunk)
    di, H, P, N = RS.ssm_dims(ref_cfg)
    rng = np.random.default_rng(chunk * S)
    B = 2
    xh = rng.normal(size=(B, S, H, P)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    a_log = -rng.uniform(0.01, 1.0, (B, S, H)).astype(np.float32) * dt
    y_r, st_r = RS._ssd_scan(ref_cfg, *map(jnp.asarray,
                                           (xh, Bm, Cm, dt, a_log)))
    y_t, st_t = TS._ssd_scan(cfg, *map(torch.from_numpy,
                                       (xh, Bm, Cm, dt, a_log)))
    assert tuple(y_t.shape) == (B, S, H, P) and st_t.dtype == torch.float32
    _close(y_t, y_r)
    _close(st_t, st_r)


@pytest.mark.parametrize("S", [2, 13, 21])
def test_ssm_apply_with_state_matches_reference(S):
    """The mixer's output and its decode cache (final state, conv tail;
    S = 2 is shorter than the conv window and left-pads the tail)."""
    ref_cfg, cfg = _cfgs()
    p_r, p_t = _params(ref_cfg, seed=S)
    x = _x(2, S, cfg.d_model, S + 1)
    out_r, c_r = RS.ssm_apply_with_state(p_r, ref_cfg, jnp.asarray(x))
    out_t, c_t = TS.ssm_apply_with_state(p_t, cfg, torch.from_numpy(x))
    _close(out_t, out_r)
    _close(c_t["state"], c_r["state"])
    _close(c_t["conv"], c_r["conv"])
    _close(TS.ssm_apply(p_t, cfg, torch.from_numpy(x)), out_r)


@pytest.mark.parametrize("start", ["zeros", "prefill"])
def test_ssm_decode_step_matches_reference(start):
    """Six recurrent steps: outputs and the cache (updated in place) after
    each, from a zeroed cache or from ``ssm_apply_with_state``'s."""
    ref_cfg, cfg = _cfgs()
    p_r, p_t = _params(ref_cfg, seed=4)
    B = 2
    if start == "zeros":
        c_r = RS.ssm_cache_init(ref_cfg, B, jnp.float32)
        c_t = TS.ssm_cache_init(cfg, B, torch.float32, "cpu")
    else:
        x0 = _x(B, 9, cfg.d_model, 8)
        _, c_r = RS.ssm_apply_with_state(p_r, ref_cfg, jnp.asarray(x0))
        _, c_t = TS.ssm_apply_with_state(p_t, cfg, torch.from_numpy(x0))
    step = jax.jit(lambda p, x, c: RS.ssm_decode_step(p, ref_cfg, x, c))
    for t in range(6):
        x = _x(B, 1, cfg.d_model, 20 + t)
        y_r, c_r = step(p_r, jnp.asarray(x), c_r)
        state = c_t["state"]
        y_t, c_t = TS.ssm_decode_step(p_t, cfg, torch.from_numpy(x), c_t)
        assert c_t["state"] is state              # in place
        _close(y_t, y_r)
        _close(c_t["state"], c_r["state"])
        _close(c_t["conv"], c_r["conv"])


def test_chunked_scan_equals_recurrence_in_the_port():
    """The port alone, as the reference's own test: the chunked dual form
    equals stepping the recurrence token by token."""
    ref_cfg, cfg = _cfgs()
    _, p_t = _params(ref_cfg, seed=7)
    x = torch.from_numpy(_x(2, 21, cfg.d_model, 7)) * 0.6
    full = TS.ssm_apply(p_t, cfg, x)
    cache = TS.ssm_cache_init(cfg, 2, torch.float32, "cpu")
    seq = torch.cat([TS.ssm_decode_step(p_t, cfg, x[:, t:t + 1], cache)[0]
                     for t in range(21)], dim=1)
    torch.testing.assert_close(full, seq, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# bfloat16: the casts and accumulation orders of the reference
# ---------------------------------------------------------------------------
# The reference runs op by op here: under ``jax.jit`` XLA may keep excess
# precision inside a fusion (it skips the bf16 rounding between fused
# elementwise ops), so a jitted bf16 result depends on the backend's fusion
# choices, not on the source.  Op by op, every operation rounds to its
# dtype as the port's do, and the port's bf16 results are bit-equal.

def _bf16_params(ref_cfg, seed):
    """``_params`` in bfloat16 (A_log, D and dt_bias stay float32), as
    (jnp tree, torch tree) holding the same values."""
    p_r, _ = _params(ref_cfg, seed)
    p_r = {k: (v if k in ("A_log", "D", "dt_bias") else
               jax.tree.map(lambda a: a.astype(jnp.bfloat16), v))
           for k, v in p_r.items()}
    return p_r, jax.tree.map(_to_torch, p_r)


def _to_torch(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _equal(got, want):
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("S", [1, 7, 21])
def test_causal_conv_bf16_is_bit_equal_to_reference(S):
    """The taps summed in bf16 in the reference's order (i = 0 .. w-1),
    each product and sum rounded: bit-equal.  ``F.conv1d`` (one float32
    sum rounded once) differs in about a fifth of the elements."""
    ref_cfg, _ = _cfgs()
    p_r, p_t = _bf16_params(ref_cfg, seed=S)
    x = jnp.asarray(_x(2, S, p_r["conv_w"].shape[1], S)).astype(jnp.bfloat16)
    want = RS._causal_conv(p_r["conv_w"], p_r["conv_b"], x)
    got = TS._causal_conv(p_t["conv_w"], p_t["conv_b"], _to_torch(x))
    _equal(got, want)


@pytest.mark.parametrize("S", [2, 13, 21])
def test_ssm_apply_with_state_bf16_matches_reference(S):
    """bf16 activations: the mixer's output and conv tail bit-equal, the
    float32 state within 1e-5 (its sums run in another order)."""
    ref_cfg, cfg = _cfgs()
    p_r, p_t = _bf16_params(ref_cfg, seed=S + 3)
    x = jnp.asarray(_x(2, S, cfg.d_model, S + 5)).astype(jnp.bfloat16)
    out_r, c_r = RS.ssm_apply_with_state(p_r, ref_cfg, x)
    out_t, c_t = TS.ssm_apply_with_state(p_t, cfg, _to_torch(x))
    _equal(out_t, out_r)
    _equal(c_t["conv"], c_r["conv"])
    assert c_t["state"].dtype == torch.float32
    _close(c_t["state"], c_r["state"], 1e-5)


def test_ssm_decode_step_bf16_matches_reference():
    """Six bf16 decode steps from a prefill cache: the decode conv as one
    float32 sum rounded to bf16 (the reference's bf16 einsum), the
    output and the conv cache bit-equal after each step, the float32
    state within 1e-5."""
    ref_cfg, cfg = _cfgs()
    p_r, p_t = _bf16_params(ref_cfg, seed=11)
    x0 = jnp.asarray(_x(2, 9, cfg.d_model, 12)).astype(jnp.bfloat16)
    _, c_r = RS.ssm_apply_with_state(p_r, ref_cfg, x0)
    c_t = {k: _to_torch(v).clone() for k, v in c_r.items()}
    for t in range(6):
        x = jnp.asarray(_x(2, 1, cfg.d_model, 30 + t)).astype(jnp.bfloat16)
        y_r, c_r = RS.ssm_decode_step(p_r, ref_cfg, x, c_r)
        y_t, c_t = TS.ssm_decode_step(p_t, cfg, _to_torch(x), c_t)
        _equal(y_t, y_r)
        _equal(c_t["conv"], c_r["conv"])
        _close(c_t["state"], c_r["state"], 1e-5)
