"""The port's training path vs the JAX package's, on the CPU in float32.

* ``cross_entropy`` and ``chunked_cross_entropy`` (ragged S, -1 labels, a
  padded vocab, chunk sizes) and their gradients;
* ``loss_fn`` for all ten reduced architectures within rtol 1e-5, the
  same value under every ``remat`` policy, and its gradients for a dense,
  an SSM, a MoE and a hybrid config within 1e-4 x max|ref grad| a leaf;
* one ``build_train_step`` against the reference's (loss, grad norm,
  step, the new parameters and moments);
* ``train``: the loss falls, a resumed run is bit-identical to the
  uninterrupted one, and train checkpoints resume across the packages
  both ways (a train state's keys are the reference's: ``opt/step``,
  ``opt/mu/...``, ``opt/nu/...``);
* the launcher on the CPU.

Weights are the port's ``init_model`` draws, handed to the reference as
numpy arrays; the reference is jitted once per config.
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
from repro.models import layers as RLY
from repro.models import transformer as RT
from repro.optim import AdamW as RAdamW
from repro.runtime import checkpoint as rck
from repro.runtime import steps as RS
from repro.runtime import train_loop as RTL

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as PLY
from repro_torch.models import transformer as TT
from repro_torch.optim import AdamWState
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import steps as PS
from repro_torch.runtime import train_loop as PTL

GRAD_ARCHS = ["qwen3-4b", "mamba2-1.3b", "mixtral-8x22b",
              "jamba-1.5-large-398b"]


def _port_cfg(ref_cfg) -> ArchConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["pattern"] = tuple(LayerSpec(s.kind, s.mlp) for s in ref_cfg.pattern)
    return ArchConfig(**kw)


def _cfgs(arch, **over):
    ref = dataclasses.replace(ref_get(arch, reduced=True), **over)
    return ref, _port_cfg(ref)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _params(cfg, seed=0):
    params = TT.init_model(cfg, seed=seed, device="cpu")
    return jax.tree.map(jnp.asarray, _np_tree(params)), params


def _batch(cfg, B, S, seed=0, unlabelled=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if unlabelled:
        labels[:, -unlabelled:] = -1
    out = {"labels": labels}
    if cfg.frontend == "audio":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        if cfg.frontend == "vision":
            out["patch_embeds"] = rng.normal(
                size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


@functools.lru_cache(maxsize=None)
def _ref_loss(cfg, grad=False):
    fn = lambda p, b: RT.loss_fn(p, cfg, b)
    return jax.jit(jax.value_and_grad(fn) if grad else fn)


def _leaf_close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + 1e-12)


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 40)).astype(np.float32) * 4
    logits[..., 37:] = -np.inf                  # a padded vocab tail
    labels = rng.integers(0, 37, (3, 7)).astype(np.int32)
    want = RLY.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss)
    got = PLY.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), z_loss)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("S,chunk,vocab,unlabelled", [
    (16, 8, 40, 0), (13, 8, 40, 3), (5, 256, 37, 0), (21, 4, 37, 21),
    (9, 9, 33, 2)])
def test_chunked_cross_entropy_matches_reference(S, chunk, vocab,
                                                 unlabelled):
    """Value and gradients (h, head) on ragged S, -1 labels (all of them
    in one case: the loss is then 0) and a padded vocab (V_pad 40)."""
    rng = np.random.default_rng(S)
    B, d, V = 2, 12, 40
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = rng.normal(size=(d, V)).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    if unlabelled:
        labels[:, S - unlabelled:] = -1
    fn = lambda h, w: RLY.chunked_cross_entropy(h, w, jnp.asarray(labels),
                                                vocab, chunk=chunk)
    want, (gh_r, gw_r) = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = PLY.chunked_cross_entropy(ht, wt, torch.from_numpy(labels), vocab,
                                    chunk=chunk)
    gh, gw = torch.autograd.grad(got, (ht, wt))
    got = got.detach()
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    for g, r in ((gh, gh_r), (gw, gw_r)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-7)
    assert not gw[:, vocab:].any()


def test_chunked_cross_entropy_equals_full_cross_entropy():
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.normal(size=(2, 11, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 30)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 30, (2, 11)).astype(np.int32))
    full = PLY.cross_entropy(h @ w, labels)
    for chunk in (1, 4, 11, 64):
        assert float(PLY.chunked_cross_entropy(h, w, labels, 30,
                                               chunk=chunk)) == \
            pytest.approx(float(full), rel=1e-6)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REF_ARCH_NAMES)
def test_loss_fn_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    params_r, params = _params(cfg)
    br, bt = _batch(cfg, 2, 12, unlabelled=2)
    want = float(_ref_loss(ref_cfg)(params_r, br))
    with torch.no_grad():
        got = TT.loss_fn(params, cfg, bt)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_fn_gradients_match_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    params_r, params = _params(cfg, seed=1)
    br, bt = _batch(cfg, 2, 10, seed=1)
    want, grads_r = _ref_loss(ref_cfg, grad=True)(params_r, br)
    got, grads = PS.value_and_grad(lambda p: TT.loss_fn(p, cfg, bt), params)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    flat_r = jax.tree_util.tree_flatten_with_path(grads_r)[0]
    flat_p = {k: v for k, v, _ in ckpt._flatten(grads)}
    assert len(flat_r) == len(flat_p)
    for path, g in flat_r:
        _leaf_close(flat_p["/".join(str(p.key) for p in path)], g)
    assert not any(x.requires_grad for x in PS.tree_leaves(params))


@pytest.mark.parametrize("remat", ["full", "layer", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-1.5-large-398b"])
def test_remat_policies_keep_loss_and_grads(arch, remat):
    """``_remat`` changes what the backward keeps, not what it computes:
    bit-equal loss and gradients to ``remat="none"`` on the CPU."""
    _, cfg = _cfgs(arch)
    params = TT.init_model(cfg, seed=2, device="cpu")
    _, bt = _batch(cfg, 1, 9, seed=2)
    base = PS.value_and_grad(lambda p: TT.loss_fn(p, cfg, bt), params)
    cfg_r = dataclasses.replace(cfg, remat=remat)
    got = PS.value_and_grad(lambda p: TT.loss_fn(p, cfg_r, bt), params)
    assert torch.equal(got[0], base[0])
    for a, b in zip(PS.tree_leaves(got[1]), PS.tree_leaves(base[1])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        TT.loss_fn(params, dataclasses.replace(cfg, remat="some"), bt)


def test_periods_unbind_writes_each_stack_gradient_once():
    """The forward takes the periods of a stack by one ``unbind``: a
    stack's gradient comes from one UnbindBackward node, not a select per
    period."""
    _, cfg = _cfgs("qwen3-4b", n_layers=4)
    params = TT.init_model(cfg, device="cpu")
    leaf = params["layers"]["l0"]["mlp"]["w_up"].requires_grad_(True)
    periods = TT._periods(params["layers"])
    assert len(periods) == cfg.n_periods == 4
    nodes = {p["l0"]["mlp"]["w_up"].grad_fn for p in periods}
    assert len(nodes) == 1
    assert type(nodes.pop()).__name__.startswith("Unbind")
    leaf.requires_grad_(False)


# ---------------------------------------------------------------------------
# The train step and the loop
# ---------------------------------------------------------------------------

def test_train_step_matches_reference():
    ref_cfg, cfg = _cfgs("qwen3-4b")
    params_r, params = _params(cfg, seed=3)
    br, bt = _batch(cfg, 2, 16, seed=3)
    state_r = {"params": params_r, "opt": RAdamW(lr=3e-4).init(params_r)}
    new_r, m_r = jax.jit(RS.build_train_step(ref_cfg))(state_r, br)
    state = {"params": params, "opt": PS.make_optimizer(cfg).init(params)}
    new, m = PS.build_train_step(cfg)(state, bt)
    assert isinstance(new["opt"], AdamWState)
    assert new["params"] is params
    assert float(m["loss"]) == pytest.approx(float(m_r["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(m_r["grad_norm"]),
                                                  rel=1e-5)
    assert int(m["step"]) == int(m_r["step"]) == 1
    for tree_r, tree in ((new_r["params"], new["params"]),
                         (new_r["opt"].mu, new["opt"].mu),
                         (new_r["opt"].nu, new["opt"].nu)):
        for a, b in zip(jax.tree.leaves(tree_r), PS.tree_leaves(tree)):
            _leaf_close(b.numpy(), a, rel=1e-4)


def test_make_optimizer_follows_master_weights():
    _, cfg = _cfgs("qwen3-4b")
    assert PS.make_optimizer(cfg).state_dtype is None
    cfg = dataclasses.replace(cfg, master_weights=False)
    assert PS.make_optimizer(cfg).state_dtype == "bfloat16"
    st = PS.init_train_state(cfg, seed=0, device="cpu")
    assert st["opt"].mu["embed"]["table"].dtype == torch.bfloat16


def test_train_learns_and_resumes_bit_identically(tmp_path):
    _, cfg = _cfgs("qwen3-4b")
    kw = dict(n_steps=8, global_batch=4, seq_len=16, seed=0, log_every=0,
              device="cpu")
    full = PTL.train(cfg, **kw)
    assert full.steps == 8 and len(full.losses) == 8
    assert np.isfinite(full.losses).all()
    assert full.losses[-1] < full.losses[0]
    d = str(tmp_path / "ck")
    seen = []
    first = PTL.train(cfg, **dict(kw, n_steps=4), ckpt_dir=d, ckpt_every=2,
                      on_step=lambda s, m: seen.append(s))
    assert seen == [0, 1, 2, 3] and first.resumed_from is None
    assert ckpt.available_steps(d) == [2, 4]
    second = PTL.train(cfg, **kw, ckpt_dir=d, ckpt_every=100)
    assert second.resumed_from == 4 and second.steps == 8
    assert first.losses + second.losses == full.losses
    _, man = ckpt.load_arrays(d, 8)
    assert "opt/step" in man["keys"] and man["dtypes"]["opt/step"] == "int32"


def test_train_state_keys_are_the_references():
    """The port's train state flattens to the reference's checkpoint keys
    (``opt/mu/...`` by field, not ``opt/1/...``), and restore rebuilds
    the ``AdamWState``."""
    ref_cfg, cfg = _cfgs("mixtral-8x22b")
    state_r = RS.init_train_state(jax.random.PRNGKey(0), ref_cfg)
    state = PS.init_train_state(cfg, device="cpu")
    keys_r = [k for k, _ in rck._flatten(state_r)[0]]
    keys = [k for k, _, _ in ckpt._flatten(state)]
    assert keys == keys_r
    assert "opt/step" in keys and any(k.startswith("opt/nu/") for k in keys)


def test_namedtuple_round_trip(tmp_path):
    st = AdamWState(step=torch.tensor(3, dtype=torch.int32),
                    mu={"a": torch.ones(2)}, nu={"a": torch.zeros(2)})
    ckpt.save(str(tmp_path), 1, {"opt": st, "t": (np.ones(1), np.zeros(2))})
    back = ckpt.restore(str(tmp_path), 1,
                        {"opt": st, "t": (np.ones(1), np.zeros(2))})
    assert type(back["opt"]) is AdamWState and type(back["t"]) is tuple
    assert int(back["opt"].step) == 3
    np.testing.assert_array_equal(back["opt"].mu["a"], np.ones(2))
    _, man = ckpt.load_arrays(str(tmp_path), 1)
    assert man["keys"] == ["opt/step", "opt/mu/a", "opt/nu/a", "t/0", "t/1"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_checkpoint_resumes_across_packages(tmp_path, writer):
    """Steps 0-3 in one package with a checkpoint at 4, steps 4-7 resumed
    in the other: the resumed losses follow the writer's uninterrupted
    run within a relative 1e-4."""
    ref_cfg, cfg = _cfgs("qwen3-4b")
    kw = dict(global_batch=4, seq_len=16, seed=0, log_every=0)
    d = str(tmp_path / "ck")
    if writer == "reference":
        full = RTL.train(ref_cfg, n_steps=8, **kw)
        RTL.train(ref_cfg, n_steps=4, ckpt_dir=d, ckpt_every=4, **kw)
        resumed = PTL.train(cfg, n_steps=8, ckpt_dir=d, device="cpu", **kw)
    else:
        full = PTL.train(cfg, n_steps=8, device="cpu", **kw)
        PTL.train(cfg, n_steps=4, ckpt_dir=d, ckpt_every=4, device="cpu",
                  **kw)
        resumed = RTL.train(ref_cfg, n_steps=8, ckpt_dir=d, **kw)
    assert resumed.resumed_from == 4 and resumed.steps == 8
    np.testing.assert_allclose(resumed.losses, full.losses[4:], rtol=1e-4)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "mamba2-1.3b", "--steps", "3", "--batch",
                       "2", "--seq", "8", "--device", "cpu", "--ckpt",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "step 0: loss" in out and "done: 3 steps" in out
    launch_train.main(["--arch", "mamba2-1.3b", "--steps", "3", "--device",
                       "cpu", "--ckpt", str(tmp_path)])
    assert "nothing left to run" in capsys.readouterr().out
