"""The port's full-sequence forward vs the JAX package: ``forward_train``
(logits at every exit and the final head), ``forward_hiddens`` and
``encode`` for every architecture of the registry at its reduced size,
and ``decode_step``'s refusal of the encoder-only hubert.

The same inputs, drawn from a seed with numpy, go through the reference
function (jitted once per config) and the port's on the CPU, in float32,
within rtol = atol = 1e-4.  Weights are the port's ``init_model`` draws,
handed to the reference as numpy arrays (the two trees share names and
layouts).  ``tests/test_torch_prefill.py`` holds prefill and decode.
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
from repro.models import transformer as RT

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import transformer as TT

TOL = 1e-4


def _port_cfg(ref_cfg) -> ArchConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["pattern"] = tuple(LayerSpec(s.kind, s.mlp) for s in ref_cfg.pattern)
    return ArchConfig(**kw)


def _cfgs(arch, **over):
    ref = dataclasses.replace(ref_get(arch, reduced=True), **over)
    return ref, _port_cfg(ref)


def _params(cfg: ArchConfig, seed: int = 0):
    """The port's weights and the same numbers as jnp arrays."""
    params = TT.init_model(cfg, seed=seed, device="cpu")
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), params), params


@functools.lru_cache(maxsize=None)
def _ref(name, cfg):
    """The reference's forward for ``cfg``, jitted once: ``forward_train``
    alone, or with ``forward_hiddens`` in one program."""
    if name == "forward_train":
        return jax.jit(lambda p, b: RT.forward_train(p, cfg, b))
    return jax.jit(lambda p, b: (RT.forward_train(p, cfg, b),
                                 RT.forward_hiddens(p, cfg, b)))


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



@pytest.mark.parametrize("arch", REF_ARCH_NAMES)
def test_forward_train_and_hiddens_match_reference(arch):
    """Logits at every exit and the final head, and the normed hiddens:
    jamba's hybrid period (SSM + attention, MoE on alternate layers),
    internvl2's patch embeds, hubert's audio frames."""
    ref_cfg, cfg = _cfgs(arch)
    params_r, params = _params(cfg)
    br, bt = _batch(cfg, 2, 12)
    want, want_h = _ref("forward_both", ref_cfg)(params_r, br)
    got = TT.forward_train(params, cfg, bt)
    assert set(got) == set(want) == {"final"} | {
        f"exit_{p}" for p in cfg.exit_layer_list}
    for name in want:
        assert got[name].dtype == torch.float32
        assert tuple(got[name].shape) == (2, 12, cfg.padded_vocab)
        _close(got[name], want[name])
    got_h = TT.forward_hiddens(params, cfg, bt)
    assert set(got_h) == set(want_h)
    for name in want_h:
        _close(got_h[name], want_h[name])


def test_vision_without_patch_embeds_matches_reference():
    ref_cfg, cfg = _cfgs("internvl2-2b")
    params_r, params = _params(cfg)
    br, bt = _batch(cfg, 2, 10, seed=4, patches=False)
    _close(TT.forward_train(params, cfg, bt)["final"],
           _ref("forward_train", ref_cfg)(params_r, br)["final"])


def test_encode_matches_reference_and_decode_refuses():
    """hubert (encoder-only): ``encode`` is the final frame logits;
    ``decode_step`` refuses, as the reference's assert does."""
    ref_cfg, cfg = _cfgs("hubert-xlarge")
    params_r, params = _params(cfg)
    br, bt = _batch(cfg, 2, 20, seed=2)
    want = jax.jit(lambda p, b: RT.encode(p, ref_cfg, b))(params_r, br)
    got = TT.encode(params, cfg, bt)
    assert tuple(got.shape) == (2, 20, cfg.padded_vocab)
    _close(got, want)
    caches = TT.init_caches(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        TT.decode_step(params, cfg, torch.zeros(2, 1, dtype=torch.int32),
                       caches, 0)
