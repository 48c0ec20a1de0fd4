"""The port's chunked attention, ``prefill`` and the serve-step builders
vs the JAX package: ``chunked_attention`` on the reference's grid,
``attn_apply``, ``prefill`` (with its caches) for every architecture of
the registry at its reduced size and ``decode_step`` after it for the
nine decoders, ring-slot and int8 caches, and the port's own
teacher-forcing check (``tests/test_torch_forward.py`` holds the
full-sequence forward).

The same inputs, drawn from a seed with numpy, go through the reference
function (jitted once per config) and the port's on the CPU, in float32,
within rtol = atol = 1e-4.  Weights are the port's ``init_model`` draws,
handed to the reference as numpy arrays (the two trees share names and
layouts).  MoE configs raise ``capacity_factor`` to 16 where prefill and
decode are held to each other, as the reference's own teacher-forcing
test does, so that no token is dropped.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get as ref_get
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.runtime import steps as RS

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.runtime import steps as TS

TOL = 1e-4
#: the reference's teacher-forcing architectures (tests/test_models_smoke.py)
TEACHER_ARCHS = ["qwen3-4b", "granite-34b", "mamba2-1.3b",
                 "jamba-1.5-large-398b", "internvl2-2b"]


def _port_cfg(ref_cfg) -> ArchConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["pattern"] = tuple(LayerSpec(s.kind, s.mlp) for s in ref_cfg.pattern)
    return ArchConfig(**kw)


def _cfgs(arch, **over):
    ref = dataclasses.replace(ref_get(arch, reduced=True), **over)
    return ref, _port_cfg(ref)


@functools.lru_cache(maxsize=None)
def _params(cfg: ArchConfig, seed: int = 0):
    """The port's weights and the same numbers as jnp arrays."""
    params = TT.init_model(cfg, seed=seed, device="cpu")
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), params), params


@functools.lru_cache(maxsize=None)
def _ref(name, cfg, *static):
    """The reference entry point ``name`` for ``cfg``, jitted once."""
    if name == "prefill":
        return jax.jit(lambda p, b: RT.prefill(p, cfg, b,
                                               cache_len=static[0]))
    if name == "decode_step":
        return jax.jit(lambda p, c, t, pos: RT.decode_step(p, cfg, t, c, pos))
    raise ValueError(name)


def _batch(cfg, B, S, seed=0, patches=True):
    """Seeded inputs as (jnp dict, torch dict)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        return {"frames": jnp.asarray(x)}, {"frames": torch.from_numpy(x)}
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    br, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision" and patches:
        pe = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
        br["patch_embeds"] = jnp.asarray(pe)
        bt["patch_embeds"] = torch.from_numpy(pe)
    return br, bt


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _same_tree(got, want):
    """Same keys, shapes and dtypes; integers equal, floats within TOL."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == \
        [jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), \
            jax.tree_util.keystr(path)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            _close(g, w)


# ---------------------------------------------------------------------------
# chunked attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_mask_bias_matches_reference(causal, window):
    q_pos = np.arange(9, dtype=np.int32)
    k_pos = np.array([0, 1, 2, -1, 4, 5, 6, 7, -10**9, 9, 10, 3],
                     dtype=np.int32)
    want = RA._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), causal,
                         window)
    got = TA._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                        causal, window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
@pytest.mark.parametrize("S,chunk", [(16, 4), (16, 16), (13, 4), (33, 8)])
def test_chunked_attention_matches_reference(causal, window, S, chunk):
    """The reference's own grid (tests/test_attention.py): padded key
    chunks (S % chunk), GQA 2:1, causal, windowed and bidirectional."""
    rng = np.random.default_rng(S * chunk + window)
    B, H, KV, D = 2, 4, 2, 8
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want = RA.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=causal, window=window, chunk=chunk)
    got = TA.chunked_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                               causal=causal, window=window, chunk=chunk)
    _close(got, want)


def test_chunked_attention_fully_masked_chunks():
    """Rows whose first chunks are all masked (a window far behind, empty
    slots) keep the reference's finite NEG_INF arithmetic: the masked
    chunk's share is wiped by the next live chunk."""
    rng = np.random.default_rng(3)
    B, Sq, Sk, H, KV, D = 1, 6, 24, 4, 1, 8
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    q_pos = np.arange(18, 24, dtype=np.int32)
    k_pos = np.arange(Sk, dtype=np.int32)
    k_pos[:4] = -1
    args_r = map(jnp.asarray, (q, k, v, q_pos, k_pos))
    args_t = map(torch.from_numpy, (q, k, v, q_pos, k_pos))
    want = RA.chunked_attention(*args_r, causal=True, window=5, chunk=4)
    got = TA.chunked_attention(*args_t, causal=True, window=5, chunk=4)
    _close(got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
@pytest.mark.parametrize("S,chunk", [(16, 4), (33, 8)])
def test_chunked_attention_bf16_is_bit_equal_to_reference(causal, window,
                                                          S, chunk):
    """bf16 q, k and v: scores and the running (max, sum, acc) in float32,
    the probabilities rounded to bf16 before the PV product, the output
    rounded once.  The reference runs op by op (under ``jax.jit`` XLA may
    skip the bf16 rounding inside a fusion); the port is bit-equal."""
    rng = np.random.default_rng(S * chunk + window + 1)
    B, H, KV, D = 2, 4, 2, 8
    qkv = [jnp.asarray(rng.normal(size=s).astype(np.float32)
                       ).astype(jnp.bfloat16)
           for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    pos = np.arange(S, dtype=np.int32)
    want = RA.chunked_attention(*qkv, jnp.asarray(pos), jnp.asarray(pos),
                                causal=causal, window=window, chunk=chunk)
    got = TA.chunked_attention(
        *(torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in qkv), torch.from_numpy(pos), torch.from_numpy(pos),
        causal=causal, window=window, chunk=chunk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x22b",
                                  "hubert-xlarge"])
def test_attn_apply_matches_reference(arch):
    """qk-norm (qwen3), a sliding window (mixtral), bidirectional
    (hubert), over two chunks of keys."""
    ref_cfg, cfg = _cfgs(arch)
    params_r, params = _params(cfg)
    p_r = jax.tree.map(lambda x: x[0], params_r["layers"]["l0"]["mix"])
    p_t = TT._period(params["layers"], 0)["l0"]["mix"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    want = jax.jit(lambda p, x, pos: RA.attn_apply(p, ref_cfg, x, pos))(
        p_r, jnp.asarray(x), jnp.asarray(pos))
    got = TA.attn_apply(p_t, cfg, torch.from_numpy(x),
                        torch.from_numpy(pos.copy()))
    _close(got, want)


# ---------------------------------------------------------------------------
# prefill and decode after it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REF_ARCH_NAMES)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill logits and every cache leaf (K/V, slot positions, SSM state
    and conv tail), then, for the nine decoders, three decode steps' final
    and exit logits.  The encoder-only hubert prefills its frames, as in
    the reference."""
    ref_cfg, cfg = _cfgs(arch)
    params_r, params = _params(cfg)
    B, S, L = 2, 11, 16
    br, bt = _batch(cfg, B, S, seed=1)
    l_r, c_r = _ref("prefill", ref_cfg, L)(params_r, br)
    l_t, c_t = TT.prefill(params, cfg, bt, cache_len=L)
    _close(l_t, l_r)
    _same_tree(c_t, c_r)
    if not cfg.has_decoder:
        return
    dec = _ref("decode_step", ref_cfg)
    rng = np.random.default_rng(9)
    for pos in range(S, S + 3):
        toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        l_r, c_r, e_r = dec(params_r, c_r, jnp.asarray(toks), jnp.int32(pos))
        l_t, c_t, e_t = TT.decode_step(params, cfg, torch.from_numpy(toks),
                                       c_t, pos)
        _close(l_t, l_r)
        assert set(e_t) == set(e_r)
        for name in e_r:
            _close(e_t[name], e_r[name])
    _same_tree(c_t, c_r)


@pytest.mark.parametrize("arch,over,S,L", [
    ("mixtral-8x22b", {}, 40, 64),                     # window 16: wraps
    ("qwen3-4b", {"kv_cache_dtype": "int8"}, 11, 16),  # int8 cache
    ("qwen3-4b", {"kv_cache_dtype": "int8", "sliding_window": 8}, 21, 32),
])
def test_prefill_ring_and_int8_caches_match_reference(arch, over, S, L):
    """A prompt longer than a sliding-window cache lands at ring slots
    ``pos % T``; an int8 cache stores quantized K/V and their scales."""
    ref_cfg, cfg = _cfgs(arch, **over)
    params_r, params = _params(cfg)
    br, bt = _batch(cfg, 2, S, seed=6)
    l_r, c_r = _ref("prefill", ref_cfg, L)(params_r, br)
    l_t, c_t = TT.prefill(params, cfg, bt, cache_len=L)
    _close(l_t, l_r)
    _same_tree(c_t, c_r)
    toks = np.array([[3], [5]], dtype=np.int32)
    l_r, c_r, _ = _ref("decode_step", ref_cfg)(params_r, c_r,
                                               jnp.asarray(toks),
                                               jnp.int32(S))
    l_t, c_t, _ = TT.decode_step(params, cfg, torch.from_numpy(toks), c_t, S)
    _close(l_t, l_r)
    _same_tree(c_t, c_r)


@pytest.mark.parametrize("arch,S", [(a, 12) for a in TEACHER_ARCHS]
                         + [("mixtral-8x22b", 24), ("arctic-480b", 12)])
def test_decode_matches_teacher_forcing(arch, S):
    """The port alone: prefill of S - 1 tokens plus one decode step equals
    ``forward_train`` at the last position (relative error < 1e-4, as the
    reference's test); mixtral's prompt runs past its window."""
    cfg = _port_cfg(ref_get(arch, reduced=True))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    params = TT.init_model(cfg, seed=0, device="cpu")
    _, batch = _batch(cfg, 2, S, seed=7)
    full = TT.forward_train(params, cfg, batch)["final"][:, -1]
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    _, caches = TT.prefill(params, cfg, pre, cache_len=S + 4)
    lg, _, _ = TT.decode_step(params, cfg, batch["tokens"][:, S - 1:S],
                              caches, S - 1)
    a, b = full.numpy(), lg.numpy()
    m = np.isfinite(a) & np.isfinite(b)
    assert (np.isfinite(a) == np.isfinite(b)).all()
    err = np.abs(a[m] - b[m]).max() / (np.abs(a[m]).max() + 1e-9)
    assert err < 1e-4, f"{arch}: decode/forward mismatch {err:.2e}"


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-1.3b",
                                  "hubert-xlarge"])
def test_step_builders_match_reference(arch):
    """``build_prefill_step`` then ``build_serve_step`` for a decoder,
    ``build_encode_step`` for the encoder-only hubert."""
    ref_cfg, cfg = _cfgs(arch)
    params_r, params = _params(cfg)
    br, bt = _batch(cfg, 2, 9, seed=8)
    if not cfg.has_decoder:
        _close(TS.build_encode_step(cfg)(params, bt),
               jax.jit(RS.build_encode_step(ref_cfg))(params_r, br))
        return
    l_r, c_r = jax.jit(RS.build_prefill_step(ref_cfg, 12))(params_r, br)
    l_t, c_t = TS.build_prefill_step(cfg, 12)(params, bt)
    _close(l_t, l_r)
    toks = np.array([[1], [2]], dtype=np.int32)
    l_r, c_r, e_r = jax.jit(RS.build_serve_step(ref_cfg))(
        params_r, c_r, jnp.asarray(toks), jnp.int32(9))
    l_t, c_t, e_t = TS.build_serve_step(cfg)(params, c_t,
                                             torch.from_numpy(toks), 9)
    _close(l_t, l_r)
    for name in e_r:
        _close(e_t[name], e_r[name])
    _same_tree(c_t, c_r)
