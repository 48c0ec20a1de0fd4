"""The paper's branchy CNNs in the port vs the JAX package.

B-LeNet, B-AlexNet and B-ResNet (``blocks_per_stage`` 1 and 2, and the
depth knob's arithmetic up to ResNet-110) go through the reference and
the port on the CPU with the same weights: the reference's ``init`` draws,
carried into the port by ``convert.branchy_params_from``, and the same
seeded numpy inputs ``[B, H, W, C]``.

* ``out_shape`` / ``macs`` of every layer and every model, and the
  Table III features, equal the reference's exactly;
* the forward (every exit's logits and the last block's output, also with
  ``up_to_block``) within rtol = atol = 1e-4;
* ``infer``: the exit taken equal wherever the reference's confidence
  lies more than 1e-6 from its threshold, and the prediction equal
  wherever the reference's top two probabilities differ by more than
  1e-6 (the exit gate's confidence is ``exp(m - lse)``, the reference's
  ``softmax().max()``; they may differ in the last ulp);
* ``loss`` within 1e-5 and its gradients within 1e-4 x max|ref grad| a
  parameter, against ``jax.value_and_grad``;
* ``extract_profile`` field by field, and ``solve_fin`` on it equal to the
  reference's Solution;
* two mutants fail the forward check: a symmetric padding of the stride-2
  SAME convolutions (B-ResNet) and an NCHW flatten (B-LeNet).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as RC
from repro.core.scenarios import paper_scenario as ref_paper_scenario
from repro.models import branchy as RB

import repro_torch as T
from repro_torch.convert import branchy_params_from, network_from
from repro_torch.models import branchy as PB
from repro_torch.models import cnn_layers as PL

TOL = 1e-4
MODELS = [("b-lenet", {}), ("b-alexnet", {}),
          ("b-resnet", {"blocks_per_stage": 1}),
          ("b-resnet", {"blocks_per_stage": 2})]
IDS = ["lenet", "alexnet", "resnet-bps1", "resnet-bps2"]


@functools.lru_cache(maxsize=None)
def _pair(name, bps=None, seed=0):
    """(reference model, its params as numpy, the port's model carrying
    them), built once."""
    kw = {} if bps is None else {"blocks_per_stage": bps}
    ref = RB.PAPER_MODELS[name](**kw)
    params = ref.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    port = PB.PAPER_MODELS[name](**kw).init(device="cpu")
    port.load_state_dict(branchy_params_from(port, tree, device="cpu"))
    return ref, params, port


def _args(kw):
    return (kw.get("blocks_per_stage"),)


@functools.lru_cache(maxsize=None)
def _ref_apply(name, bps, up_to_block=None):
    ref, _, _ = _pair(name, bps)
    return jax.jit(lambda p, x: ref.apply(p, x, up_to_block=up_to_block))


def _x(model, B, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B,) + tuple(model.input_shape)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _ratio(got, want, tol=TOL):
    """max |got - want| / (tol + tol * |want|): at most 1 where
    ``assert_allclose(rtol=atol=tol)`` passes."""
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want) / (tol + tol * np.abs(want))))


def _forward_err(name, bps, B=3, up_to_block=None):
    """The largest ``_ratio`` over every exit's logits and the output."""
    _, params, port = _pair(name, bps)
    x = _x(port, B)
    lr, hr = _ref_apply(name, bps, up_to_block)(params, jnp.asarray(x))
    with torch.no_grad():
        lp, hp = port.apply(torch.from_numpy(x), up_to_block=up_to_block)
    assert set(lp) == set(lr)
    errs = [_ratio(lp[b].numpy(), lr[b]) for b in lr]
    errs.append(_ratio(hp.numpy(), hr))
    return max(errs), lp, lr, hp, hr


# ---------------------------------------------------------------------------
# Shapes and MACs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RB.PAPER_MODELS))
def test_table3_features(name):
    m = PB.PAPER_MODELS[name]()
    shape, feats = m.input_shape, []
    for blk in m.blocks:
        shape = blk.out_shape(shape)
        feats.append(int(np.prod(shape)))
    assert feats == PB.TABLE_III_FEATURES[name] == \
        RB.TABLE_III_FEATURES[name]
    assert list(PB.PAPER_MODELS) == list(RB.PAPER_MODELS)


def _walk(seq_r, seq_p, shape):
    """Every (reference layer, port layer, in_shape) of two Sequentials."""
    assert len(seq_r.layers) == len(seq_p.layers)
    for lr, lp in zip(seq_r.layers, seq_p.layers):
        assert type(lr).__name__ == type(lp).__name__
        yield lr, lp, shape
        shape = lr.out_shape(shape)


@pytest.mark.parametrize("name,kw", [("b-lenet", {}), ("b-alexnet", {})]
                         + [("b-resnet", {"blocks_per_stage": n})
                            for n in (1, 2, 3, 18)])
def test_layer_and_model_macs_and_shapes(name, kw):
    ref = RB.PAPER_MODELS[name](**kw)
    port = PB.PAPER_MODELS[name](**kw)
    assert port.exit_blocks() == ref.exit_blocks()
    shape = ref.input_shape
    for i, (br, bp) in enumerate(zip(ref.blocks, port.blocks)):
        assert bp.out_shape(shape) == br.out_shape(shape)
        assert bp.macs(shape) == br.macs(shape)
        for lr, lp, s in _walk(br, bp, shape):
            assert lp.out_shape(s) == lr.out_shape(s)
            assert lp.macs(s) == lr.macs(s)
        out = br.out_shape(shape)
        if i in ref.exits:
            hr, hp = ref.exits[i], port.exits[str(i)]
            assert hp.out_shape(out) == hr.out_shape(out)
            assert hp.macs(out) == hr.macs(out)
            for lr, lp, s in _walk(hr, hp, out):
                assert lp.macs(s) == lr.macs(s)
        shape = out
    assert len(port.blocks) == len(ref.blocks)


@pytest.mark.parametrize("h,k,s", [(32, 3, 2), (16, 3, 2), (13, 3, 1),
                                   (28, 5, 1), (27, 5, 1), (7, 4, 3),
                                   (5, 1, 2), (2, 5, 1)])
def test_same_padding_is_xla_s(h, k, s):
    """``same_pads`` pads as XLA's SAME: a reference convolution of a
    one-hot map shows where the window sits."""
    before, after = PL.same_pads(h, k, s)
    out = -(-h // s)
    assert (out - 1) * s + k <= h + before + after
    assert after - before in (0, 1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, h, h, 2)).astype(np.float32)
    w = rng.normal(size=(k, k, 2, 3)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = PL.Conv(3, k, s, "SAME", use_relu=False)
    conv.init(torch.Generator(), (h, h, 2), "cpu")
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), want, 1e-5)


# ---------------------------------------------------------------------------
# Forward, gate, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", MODELS, ids=IDS)
def test_forward_matches_reference(name, kw):
    err, lp, lr, hp, hr = _forward_err(name, *_args(kw))
    for b in lr:
        assert lp[b].shape == (3, 10)
        _close(lp[b], lr[b])
    _close(hp, hr)
    assert err <= 1


@pytest.mark.parametrize("name,kw,up", [("b-lenet", {}, 0),
                                        ("b-lenet", {}, 1),
                                        ("b-resnet", {"blocks_per_stage": 1},
                                         2)])
def test_up_to_block_matches_reference(name, kw, up):
    err, lp, lr, _, _ = _forward_err(name, *_args(kw), up_to_block=up)
    assert set(lp) == {b for b in PB.PAPER_MODELS[name]().exit_blocks()
                       if b <= up}
    assert err <= 1


def test_mutant_symmetric_stride2_padding_fails(monkeypatch):
    """B-ResNet's stride-2 3x3 convolutions pad 0 before and 1 after; a
    symmetric padding of 1 shifts every output and fails the forward
    check."""
    assert PL.same_pads(32, 3, 2) == (0, 1)
    monkeypatch.setattr(PL, "same_pads",
                        lambda h, k, s: ((k - 1) // 2, (k - 1) // 2))
    err, *_ = _forward_err("b-resnet", 1)
    assert err > 100


def test_mutant_nchw_flatten_fails(monkeypatch):
    """B-LeNet's Flatten -> Dense reads the features in NHWC order; an
    NCHW ``x.flatten(1)`` permutes them and fails the forward check."""
    monkeypatch.setattr(PL, "_nhwc_flat", lambda x: x.reshape(x.shape[0], -1))
    err, *_ = _forward_err("b-lenet", None)
    assert err > 100


def _ref_gate_stats(logits):
    p = np.asarray(jax.nn.softmax(logits, axis=-1))
    top2 = np.sort(p, axis=-1)[:, -2:]
    return p.max(-1), top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("name,kw", MODELS, ids=IDS)
def test_infer_matches_reference(name, kw):
    ref, params, port = _pair(name, *_args(kw))
    B = 64
    x = _x(port, B, seed=2)
    lr, _ = _ref_apply(name, *_args(kw))(params, jnp.asarray(x))
    eb = ref.exit_blocks()
    stats = [_ref_gate_stats(lr[b]) for b in eb]
    # thresholds at the median confidence: both sides of each gate taken
    thr = [float(np.median(stats[j][0])) for j in range(len(eb) - 1)]
    pr, er = ref.infer(params, jnp.asarray(x), thr)
    with torch.no_grad():
        pp, ep = port.infer(torch.from_numpy(x), thr)
    pr, er = np.asarray(pr), np.asarray(er)
    assert pp.dtype == ep.dtype == torch.int32
    clear = np.ones(B, bool)
    for j in range(len(eb) - 1):
        clear &= np.abs(stats[j][0] - thr[j]) > 1e-6
    assert clear.sum() >= B // 2
    np.testing.assert_array_equal(ep.numpy()[clear], er[clear])
    gap = np.choose(er, [s[1] for s in stats])
    sure = clear & (gap > 1e-6)
    np.testing.assert_array_equal(pp.numpy()[sure], pr[sure])
    assert len(set(er.tolist())) > 1


def test_infer_extreme_thresholds():
    """Threshold 0 exits everything at exit 0; above 1 nothing exits early."""
    _, _, port = _pair("b-lenet", None)
    x = torch.from_numpy(_x(port, 8))
    with torch.no_grad():
        assert (port.infer(x, [0.0])[1] == 0).all()
        assert (port.infer(x, [1.1])[1] == 1).all()
    with pytest.raises(ValueError, match="thresholds"):
        port.infer(x, [])


@pytest.mark.parametrize("name,kw", [("b-lenet", {}),
                                     ("b-resnet", {"blocks_per_stage": 1})],
                         ids=["lenet", "resnet-bps1"])
@pytest.mark.parametrize("weights", [None, (0.3, 1.0, 2.0)])
def test_loss_and_grads_match_reference(name, kw, weights):
    ref, params, port = _pair(name, *_args(kw))
    n_e = len(ref.exit_blocks())
    w = None if weights is None else list(weights[-n_e:])
    x = _x(port, 6, seed=3)
    y = np.random.default_rng(4).integers(0, 10, 6).astype(np.int32)
    lr, gr = jax.value_and_grad(lambda p: ref.loss(
        p, jnp.asarray(x), jnp.asarray(y), w))(params)
    lp, gp = port.value_and_grad(torch.from_numpy(x), torch.from_numpy(y), w)
    assert float(lp) == pytest.approx(float(lr), rel=1e-5)
    want = branchy_params_from(port, jax.tree.map(np.asarray, gr),
                               device="cpu")
    assert set(gp) == set(want)
    for k, g in gp.items():
        scale = float(want[k].abs().max())
        np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-4 * scale + 1e-12)


# ---------------------------------------------------------------------------
# Profile -> FIN
# ---------------------------------------------------------------------------

PROFILE_KW = [{}, {"accuracies": [0.91, 0.97], "phis": [0.94, 0.06]},
              {"bits_per_feature": 16}]


@pytest.mark.parametrize("name,kw", [("b-lenet", {}), ("b-alexnet", {}),
                                     ("b-resnet", {"blocks_per_stage": 18})],
                         ids=["lenet", "alexnet", "resnet110"])
@pytest.mark.parametrize("pkw", range(len(PROFILE_KW)))
def test_extract_profile_and_fin_match_reference(name, kw, pkw):
    pk = dict(PROFILE_KW[pkw])
    ref = RB.PAPER_MODELS[name](**kw)
    port = PB.PAPER_MODELS[name](**kw)
    if "accuracies" in pk and len(ref.exit_blocks()) != 2:
        n = len(ref.exit_blocks())
        pk = {"accuracies": list(np.linspace(0.9, 0.97, n)),
              "phis": [0.5] + [0.5 / (n - 1)] * (n - 1)}
    a, b = ref.extract_profile(**pk), port.extract_profile(**pk)
    assert isinstance(b, T.DNNProfile)
    assert b.name == a.name and b.input_bits == a.input_bits
    assert b.block_ops == a.block_ops and b.cut_bits == a.cut_bits
    assert all(type(x) is float for x in b.block_ops + b.cut_bits)
    assert len(b.exits) == len(a.exits)
    for ea, ep in zip(a.exits, b.exits):
        for f in ("block", "ops", "out_bits", "accuracy", "phi"):
            assert getattr(ep, f) == getattr(ea, f), f
            assert type(getattr(ep, f)) is type(getattr(ea, f)), f
    ref_nw = ref_paper_scenario()
    nw = network_from(ref_nw)
    alpha = min(e.accuracy for e in a.exits)
    for gamma, delta in ((10, 2e-3), (25, 5e-2)):
        want = RC.solve_fin(ref_nw, a, RC.AppRequirements(alpha, delta),
                            gamma=gamma, backend="minplus")
        got = T.solve_fin(nw, b, T.AppRequirements(alpha, delta),
                          gamma=gamma, device="cpu")
        assert got.found == want.found
        if want.found:
            assert got.config.placement == want.config.placement
            assert got.config.final_exit == want.config.final_exit
            for f in ("energy", "latency", "accuracy", "feasible"):
                assert getattr(got.eval, f) == getattr(want.eval, f), f


def test_branchy_params_from_rejects_other_trees():
    ref, params, port = _pair("b-lenet", None)
    tree = jax.tree.map(np.asarray, params)
    bad = {"blocks": tree["blocks"][:2], "exits": tree["exits"]}
    with pytest.raises(ValueError, match="blocks"):
        branchy_params_from(port, bad, device="cpu")
    # a weight where the model has none (exit 0's MaxPool) and a weight of
    # another shape: the strict load refuses both
    bad = {"blocks": tree["blocks"], "exits": dict(tree["exits"])}
    bad["exits"]["0"] = [{"w": np.zeros((1, 1, 1, 1), np.float32),
                          "b": np.zeros(1, np.float32)}] + \
        bad["exits"]["0"][1:]
    with pytest.raises(RuntimeError, match="exits.0.layers.0.w"):
        port.load_state_dict(branchy_params_from(port, bad, device="cpu"))
    bad = jax.tree.map(np.asarray, params)
    bad["blocks"][0][0]["w"] = bad["blocks"][0][0]["w"][:, :, :, :3]
    with pytest.raises(RuntimeError, match="size mismatch"):
        port.load_state_dict(branchy_params_from(port, bad, device="cpu"))
