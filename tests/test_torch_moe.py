"""The port's Mixture-of-Experts FFN vs the JAX package.

The same inputs, drawn from a seed with numpy, go through the reference's
``repro.models.moe`` and the port's on the CPU, in float32.  Expert ids
and the capacity each expert keeps must be equal, not merely close, since
they decide which expert and which slot a token gets; probabilities,
gates and outputs agree within rtol = atol = 1e-4.  Covered: both
dispatch impls (``gather``, the default, and the literal GShard
``einsum``), with and without capacity drops, the dense residual branch
(arctic), exact ties among router probabilities and among tokens' gates
(``jax.lax.top_k`` keeps the lower index first), and the capacity rule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import moe as RM

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import moe as TM

TOL = 1e-4


def _port_cfg(ref_cfg) -> ArchConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["pattern"] = tuple(LayerSpec(s.kind, s.mlp) for s in ref_cfg.pattern)
    return ArchConfig(**kw)


def _cfgs(arch="mixtral-8x22b", **over):
    ref = dataclasses.replace(ref_get(arch, reduced=True), **over)
    return ref, _port_cfg(ref)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _params(ref_cfg, seed=0):
    p = jax.tree.map(np.asarray,
                     RM.moe_init(jax.random.PRNGKey(seed), ref_cfg,
                                 jnp.float32))
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), p))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_capacity_matches_reference():
    for arch in ("mixtral-8x22b", "arctic-480b", "jamba-1.5-large-398b"):
        for cf in (0.1, 1.0, 1.25, 16.0):
            for red in (False, True):
                ref = dataclasses.replace(ref_get(arch, reduced=red),
                                          capacity_factor=cf)
                cfg = _port_cfg(ref)
                for t in (1, 2, 7, 8, 63, 64, 100, 4096, 4608):
                    assert TM._capacity(t, cfg) == RM._capacity(t, ref)
        assert TM.moe_flops_per_token(cfg) == RM.moe_flops_per_token(ref)


def test_init_tree_matches_reference():
    """Names, shapes and dtypes: the router float32 in a bf16 layer."""
    for arch in ("mixtral-8x22b", "arctic-480b"):
        ref_cfg, cfg = _cfgs(arch)
        want = RM.moe_init(jax.random.PRNGKey(0), ref_cfg, jnp.bfloat16)
        got = TM.moe_init(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16, "cpu")
        view = lambda t: jax.tree.map(lambda x: (tuple(x.shape), str(
            x.dtype).replace("torch.", "")), t)
        assert view(got) == view(want)


@pytest.mark.parametrize("G,t", [(1, 1), (2, 8), (3, 17), (1, 64)])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_route_ids_equal_reference(arch, G, t):
    """Expert ids equal; probabilities and renormalized gates close."""
    ref_cfg, cfg = _cfgs(arch)
    p_r, p_t = _params(ref_cfg, seed=G * t)
    x = _x((G, t, cfg.d_model), G + t)
    pr, gr, ir = RM._route(p_r, ref_cfg, jnp.asarray(x))
    pt, gt, it = TM._route(p_t, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
    _close(pt, pr)
    _close(gt, gr)


def test_route_ties_keep_the_lower_index():
    """Tied router probabilities: all experts equal (rows 0-1), a tie for
    the second place between experts 1 and 3 (row 2), a tie for the first
    place between experts 2 and 0 (row 3).  ``torch.topk`` gives no order
    among equals; the port's ids equal the reference's."""
    ref_cfg, cfg = _cfgs(n_experts=4)
    d = cfg.d_model
    router = np.zeros((d, 4), np.float32)
    router[0] = [0.0, 1.0, 0.0, 1.0]
    router[1] = [2.0, 0.0, 2.0, 0.0]
    x = np.zeros((1, 4, d), np.float32)
    x[0, 2, 0] = 1.0             # experts 1 and 3 tie above 0 and 2
    x[0, 3, 1] = 1.0             # experts 0 and 2 tie above 1 and 3
    _, _, ir = RM._route({"router": jnp.asarray(router)}, ref_cfg,
                         jnp.asarray(x))
    _, _, it = TM._route({"router": torch.from_numpy(router)}, cfg,
                         torch.from_numpy(x))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
    assert it[0].tolist() == [[0, 1], [0, 1], [1, 3], [0, 2]]


@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("cf", [16.0, 1.0, 0.1])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_moe_apply_matches_reference(arch, cf, impl):
    """Both dispatch impls, without drops (cf 16), with some (cf 1 at 64
    tokens a group) and with most tokens dropped (cf 0.1); arctic adds its
    dense residual branch."""
    ref_cfg, cfg = _cfgs(arch, capacity_factor=cf, moe_impl=impl)
    p_r, p_t = _params(ref_cfg, seed=int(cf * 10))
    x = _x((2, 64, cfg.d_model), 3)
    want = RM.moe_apply(p_r, ref_cfg, jnp.asarray(x))
    got = TM.moe_apply(p_t, cfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close(got, want)


def test_gather_kept_tokens_equal_reference():
    """With drops, each expert keeps the same tokens in the same slots:
    the gathered token ids and their weights per (group, expert, slot)."""
    ref_cfg, cfg = _cfgs(capacity_factor=1.0)
    p_r, p_t = _params(ref_cfg, seed=2)
    x = _x((2, 64, cfg.d_model), 4)
    C = RM._capacity(64, ref_cfg)
    assert TM._capacity(64, cfg) == C < 64
    _, g_r, i_r = RM._route(p_r, ref_cfg, jnp.asarray(x))
    gate_te = jnp.einsum("gtke,gtk->gte",
                         jax.nn.one_hot(i_r, ref_cfg.n_experts), g_r)
    w_r, idx_r = jax.lax.top_k(jnp.swapaxes(gate_te, 1, 2), C)
    _, g_t, i_t = TM._route(p_t, cfg, torch.from_numpy(x))
    gate_t = torch.zeros(2, 64, cfg.n_experts).scatter_(-1, i_t, g_t)
    w_t, idx_t = TM._topk(gate_t.transpose(1, 2), C)
    live = np.asarray(w_r) > 0
    np.testing.assert_array_equal(idx_t.numpy()[live], np.asarray(idx_r)[live])
    np.testing.assert_array_equal(w_t.numpy() > 0, live)
    _close(w_t, w_r)


@pytest.mark.parametrize("impl", ["gather", "einsum"])
def test_tied_tokens_take_the_reference_slots(impl):
    """Identical tokens have identical gates, so an expert's top-C over
    its tokens meets ties at the capacity boundary: 12 copies of a token
    for 8 slots.  The lower token indices win, as in the reference, and
    the same tokens are dropped."""
    ref_cfg, cfg = _cfgs(capacity_factor=0.25, moe_impl=impl)
    assert TM._capacity(48, cfg) == 8
    p_r, p_t = _params(ref_cfg, seed=5)
    base = _x((1, 4, cfg.d_model), 6)
    x = np.repeat(base, 12, axis=1)                   # 12 copies of 4 tokens
    want = RM.moe_apply(p_r, ref_cfg, jnp.asarray(x))
    got = TM.moe_apply(p_t, cfg, torch.from_numpy(x))
    _close(got, want)
    dropped = np.abs(np.asarray(want)).sum(-1) == 0
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(got.abs().sum(-1).numpy() == 0, dropped)


def test_moe_apply_groups_match_reference():
    ref_cfg, cfg = _cfgs(capacity_factor=1.0)
    p_r, p_t = _params(ref_cfg, seed=8)
    x = _x((2, 16, cfg.d_model), 9)
    for n_groups in (1, 4, 8):
        _close(TM.moe_apply(p_t, cfg, torch.from_numpy(x), n_groups=n_groups),
               RM.moe_apply(p_r, ref_cfg, jnp.asarray(x), n_groups=n_groups))


# ---------------------------------------------------------------------------
# bfloat16 experts
# ---------------------------------------------------------------------------

def _ref_gather_expert_major(params, cfg, xg):
    """The reference's ``_moe_gather`` (``repro/models/moe.py``) line by
    line, with its three expert products taken expert-major, one group at
    a time (``ecd,edf->ecf``).  XLA's CPU backend refuses the reference's
    own ``gecd,edf->gecf`` product on bf16 operands with a float32 result
    ("Unsupported element type for DotThunk"), so the reference cannot run
    its bf16 experts here; routing and capacity are its own calls, and the
    replay equals it in float32."""
    G, t, d = xg.shape
    E = cfg.n_experts
    C = RM._capacity(t, cfg)
    _, gate_vals, expert_ids = RM._route(params, cfg, xg)
    sel = jax.nn.one_hot(expert_ids, E, dtype=jnp.float32)
    gate_te = jnp.einsum("gtke,gtk->gte", sel, gate_vals)
    top_w, top_idx = jax.lax.top_k(jnp.swapaxes(gate_te, 1, 2), min(C, t))
    valid = top_w > 0.0
    xe = jnp.take_along_axis(xg[:, None, :, :], top_idx[..., None], axis=2)
    xe = xe * valid[..., None].astype(xg.dtype)

    def expert_major(spec, a, w):
        return jnp.stack([jnp.einsum(spec, a[g], w,
                                     preferred_element_type=jnp.float32)
                          for g in range(G)])

    h_g = expert_major("ecd,edf->ecf", xe, params["w_gate"])
    h_u = expert_major("ecd,edf->ecf", xe, params["w_up"])
    h = (jax.nn.silu(h_g) * h_u).astype(xg.dtype)
    ye = expert_major("ecf,efd->ecd", h, params["w_down"])
    ye = ye * (top_w * valid)[..., None]
    y = jax.vmap(lambda idx, c: jnp.zeros((t, d), jnp.float32)
                 .at[idx.reshape(-1)].add(c.reshape(-1, d)))(top_idx, ye)
    return y.astype(xg.dtype)


@pytest.mark.parametrize("cf", [16.0, 1.0])
def test_moe_gather_bf16_matches_reference(cf):
    """bf16 tokens and expert weights, float32 router: the experts'
    products on bf16 operands accumulated in float32, the SwiGLU product
    rounded to bf16 before the down projection, the weighted sum in
    float32 rounded once.  Expert ids equal; the output bit-equal to the
    reference's arithmetic (see ``_ref_gather_expert_major``), without
    drops (cf 16) and with some (cf 1)."""
    ref_cfg, cfg = _cfgs(capacity_factor=cf)
    p_r, _ = _params(ref_cfg, seed=12)
    x = _x((2, 64, cfg.d_model), 13)
    np.testing.assert_array_equal(
        np.asarray(_ref_gather_expert_major(p_r, ref_cfg, jnp.asarray(x))),
        np.asarray(RM._moe_gather(p_r, ref_cfg, jnp.asarray(x))))
    bf = {k: (v if k == "router" else v.astype(jnp.bfloat16))
          for k, v in p_r.items()}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = _ref_gather_expert_major(bf, ref_cfg, xb)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    p_t = {k: to_t(v) for k, v in bf.items()}
    _, _, i_r = RM._route(bf, ref_cfg, xb)
    _, _, i_t = TM._route(p_t, cfg, to_t(xb))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    got = TM._moe_gather(p_t, cfg, to_t(xb))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
