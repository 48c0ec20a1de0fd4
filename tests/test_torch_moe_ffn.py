"""The MoE experts' kernel B10 (``kernels/moe_ffn``) on the CPU.

* ``moe_ffn_ref``, the kernel's plain version, against the reference's own
  stage of ``_moe_gather`` (``repro/models/moe.py``): the same numpy-seeded
  tokens and weights, routed by the reference's ``_route`` and ``top_k``,
  through the reference's gather, SwiGLU einsums and weighting (float32,
  within 1e-5 of the largest |ye|) and, in bf16, through its expert-major
  replay (``tests/test_torch_moe.py``: XLA's CPU backend refuses the bf16
  einsums with a float32 result), within 2^-8 of it (the float32 sums'
  order differs, so h may round one bf16 ulp apart); the port's routing
  gives the same slots.  Dead slots are exact zeros.
* ``moe_apply`` of the port against the reference's, with the reference's
  model parameters carried over by ``convert.transformer_params_from``.
* The launch-plan mirror (``moe_ffn_plan``, ``live_tiles``,
  ``smem_bytes``): the regime by rows an expert and dtype, the grids, the
  live (expert, slot tile) blocks against the valid flags, a dead tile
  always a zero block of the plain version's output, and every block's
  shared memory within the 232,448 bytes a Hopper block may use, at the
  registry's MoE widths.
* ``moe_ffn_fn``'s gradients equal the plain version's; the wrapper takes
  the plain version on the CPU only and counts no launch there.
* The DTensor route (``_moe_ffn_local``): four gloo CPU ranks on a (2, 2)
  ("data", "model") mesh run ``moe_apply`` forward and backward over
  DTensors placed by the spec rules, with experts sharded (expert
  parallel), their d_ff sharded (tensor-parallel experts), with and
  without FSDP, and with the groups replicated; outputs and gradients
  equal the unsharded port's within 1e-5 of their largest magnitude.  Run
  as a script (``python tests/test_torch_moe_ffn.py <rank> <world>
  <port>``) this file is one rank.
"""
import ctypes
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import moe as RM
from repro.models import transformer as RT

from repro_torch.configs import get
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.kernels import _build
from repro_torch.kernels.moe_ffn import ops as MO
from repro_torch.kernels.moe_ffn.ref import (MAX_SMEM_BYTES, experts_ref,
                                             live_tiles, moe_ffn_plan,
                                             moe_ffn_ref, smem_bytes)
from repro_torch.models import moe as TM

REPO = pathlib.Path(__file__).resolve().parents[1]
F32, BF16 = torch.float32, torch.bfloat16
#: float32: both sides sum the same products in float32 in their own
#: library's order; 1e-5 of the largest |ye| holds that
F32_TOL = 1e-5
#: bf16: the same, and h rounded to bf16 after those sums may land one ulp
#: apart (2^-8 relative), which the down product carries into ye
BF16_TOL = 2.0 ** -8
#: (G, t, capacity_factor, n_experts) of the stage checks: no drops, drops
#: (cf 1), one token a group (the decode step's shape, Ck = 1 < C), a C
#: that is no tile multiple, jamba's 16 experts
STAGE_CASES = [(1, 64, 16.0, 4), (2, 32, 1.0, 4), (4, 1, 1.25, 8),
               (3, 17, 1.25, 4), (2, 40, 1.25, 16)]
#: the DTensor route's cases: (tag, expert_parallel, fsdp, batch)
DT_CASES = [("ep", True, False, 4), ("ep_fsdp", True, True, 4),
            ("tp", False, False, 4), ("tp_fsdp", False, True, 4),
            ("ep_groups_replicated", True, False, 1)]
DT_WORLD = 4


def _port_cfg(ref_cfg) -> ArchConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["pattern"] = tuple(LayerSpec(s.kind, s.mlp) for s in ref_cfg.pattern)
    return ArchConfig(**kw)


def _cfgs(**over):
    ref = dataclasses.replace(ref_get("mixtral-8x22b", reduced=True), **over)
    return ref, _port_cfg(ref)


def _ref_params(ref_cfg, seed):
    return jax.tree.map(np.asarray, RM.moe_init(jax.random.PRNGKey(seed),
                                                ref_cfg, jnp.float32))


def _ref_routing(p, ref_cfg, xg):
    """The reference's routing of ``_moe_gather``: top_w, top_idx, valid."""
    G, t, _ = xg.shape
    E = ref_cfg.n_experts
    C = RM._capacity(t, ref_cfg)
    _, gate_vals, expert_ids = RM._route(p, ref_cfg, xg)
    sel = jax.nn.one_hot(expert_ids, E, dtype=jnp.float32)
    gate_te = jnp.einsum("gtke,gtk->gte", sel, gate_vals)
    top_w, top_idx = jax.lax.top_k(jnp.swapaxes(gate_te, 1, 2), min(C, t))
    return top_w, top_idx, top_w > 0.0


def _ref_stage(p, xg, top_w, top_idx, valid, expert_major=False):
    """The reference's experts' stage, einsum by einsum (expert-major, a
    group at a time, where XLA's CPU backend refuses bf16 operands)."""
    xe = jnp.take_along_axis(xg[:, None, :, :], top_idx[..., None], axis=2)
    xe = xe * valid[..., None].astype(xg.dtype)

    def product(spec, a, w):
        if not expert_major:
            return jnp.einsum(spec, a, w, preferred_element_type=jnp.float32)
        one = spec.replace("g", "")
        return jnp.stack([jnp.einsum(one, a[g], w,
                                     preferred_element_type=jnp.float32)
                          for g in range(a.shape[0])])

    h_g = product("gecd,edf->gecf", xe, p["w_gate"])
    h_u = product("gecd,edf->gecf", xe, p["w_up"])
    h = (jax.nn.silu(h_g) * h_u).astype(xg.dtype)
    ye = product("gecf,efd->gecd", h, p["w_down"])
    return ye * (top_w * valid)[..., None]


def _to_t(a, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)
                                  if jnp.asarray(a).dtype == jnp.bfloat16
                                  else a))
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,t,cf,E", STAGE_CASES)
def test_moe_ffn_ref_matches_reference_stage(G, t, cf, E, dtype):
    ref_cfg, cfg = _cfgs(capacity_factor=cf, n_experts=E)
    p = _ref_params(ref_cfg, seed=G * 100 + t + E)
    x = np.random.default_rng(G + t + E).normal(
        size=(G, t, cfg.d_model)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = BF16 if dtype == "bfloat16" else F32
    pj = {k: (jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(jd))
          for k, v in p.items()}
    xj = jnp.asarray(x).astype(jd)
    top_w, top_idx, valid = _ref_routing(pj, ref_cfg, xj)
    want = np.asarray(_ref_stage(pj, xj, top_w, top_idx, valid,
                                 expert_major=dtype == "bfloat16"))
    # the port's routing picks the same slots
    pt = {k: _to_t(v, F32 if k == "router" else td) for k, v in pj.items()}
    xt = _to_t(xj, td)
    ti_t, valid_t, tw_t = TM._slots(pt, cfg, xt)
    np.testing.assert_array_equal(ti_t.numpy(), np.asarray(top_idx))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid))
    got = moe_ffn_ref(xt, torch.from_numpy(np.asarray(top_idx).astype(
        np.int64)), torch.from_numpy(np.array(valid)),
        torch.from_numpy(np.array(top_w)), pt["w_gate"], pt["w_up"],
        pt["w_down"])
    assert got.dtype == F32 and tuple(got.shape) == want.shape
    scale = float(np.abs(want).max())
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert float(np.abs(got.numpy() - want).max()) <= tol * scale
    dead = ~np.asarray(valid)
    assert not np.any(got.numpy()[dead])
    if cf == 1.0:
        assert dead.any()


@pytest.mark.parametrize("n_groups", [0, 2])
def test_moe_apply_matches_reference_through_convert(n_groups):
    """The reference's model parameters (reduced mixtral, float32) carried
    over by ``convert``; layer 0's MoE FFN on both sides."""
    from repro_torch.convert import transformer_params_from
    ref_cfg = dataclasses.replace(ref_get("mixtral-8x22b", reduced=True),
                                  capacity_factor=1.0)
    cfg = _port_cfg(ref_cfg)
    params_np = jax.tree.map(np.asarray,
                             RT.init_model(jax.random.PRNGKey(3), ref_cfg))
    port = transformer_params_from(params_np, cfg, device="cpu")
    p_r = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       params_np["layers"]["l0"]["mlp"])
    p_t = {k: v[0] for k, v in port["layers"]["l0"]["mlp"].items()}
    x = np.random.default_rng(4).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32)
    want = np.asarray(RM.moe_apply(p_r, ref_cfg, jnp.asarray(x),
                                   n_groups=n_groups))
    got = TM.moe_apply(p_t, cfg, torch.from_numpy(x), n_groups=n_groups)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= F32_TOL * scale


@pytest.mark.parametrize("G,Ck,dtype,regime,nt", [
    (4, 1, BF16, "stream", 1), (1, 1, BF16, "stream", 1),
    (2, 8, BF16, "stream", 2), (16, 1, BF16, "stream", 2),
    (17, 1, BF16, "tiles", 2), (1, 1440, BF16, "tiles", 2),
    (4, 1, F32, "simt", 1), (1, 4199, F32, "simt", 2)])
def test_plan_regime_and_grids(G, Ck, dtype, regime, nt):
    d, ff, E = 6144, 16384, 8
    plan = moe_ffn_plan(G, E, Ck, d, ff, dtype)
    M = G * Ck
    assert (plan.regime, plan.rows, plan.nt) == (regime, M, nt)
    if regime == "stream":
        assert plan.up_grid == (ff // 64, E, 1)
        assert plan.down_grid == (d // 64, E, 1)
        assert plan.slot_tiles == 1 and M <= 16
    else:
        rows = 128 if regime == "tiles" else 64
        tiles = -(-M // rows)
        assert plan.slot_tiles == tiles
        assert plan.up_grid == (tiles, -(-ff // plan.up_cols), E)
        assert plan.down_grid == (tiles, -(-d // plan.down_cols), E)
    with pytest.raises(ValueError):
        moe_ffn_plan(G, E, Ck, d, ff, torch.float16)


def test_plan_smem_within_a_hopper_block():
    """Every block of both launches, every regime, at the registry's MoE
    widths (mixtral, jamba, arctic) and the reduced ones."""
    seen = set()
    for arch in ("mixtral-8x22b", "jamba-1.5-large-398b", "arctic-480b"):
        for cfg in (get(arch), get(arch, reduced=True)):
            for G, Ck in ((4, 1), (1, 1), (8, 2), (1, 1440), (2, 333)):
                for dtype in (BF16, F32):
                    plan = moe_ffn_plan(G, cfg.n_experts, Ck, cfg.d_model,
                                        cfg.d_ff, dtype)
                    up, down = smem_bytes(plan)
                    assert 0 < up <= MAX_SMEM_BYTES
                    assert 0 < down <= MAX_SMEM_BYTES
                    seen.add((plan.regime, plan.nt, up, down))
    # the source's sizes: the stream rings (6 stages of 18 KB / 8 of 10 KB
    # at two n8 tiles), the tiles ring (4 stages of 48 KB), the simt arrays
    assert ("stream", 2, 110912, 82240) in seen
    assert ("stream", 1, 104768, 74048) in seen
    assert ("tiles", 2, 199168, 199168) in seen
    assert ("simt", 1, 26368, 18176) in seen


def _valid_prefix(G, E, Ck, counts):
    """valid [G, E, Ck] with the first counts[g][e] slots live (the top-C
    selection sorts live slots first)."""
    v = torch.zeros(G, E, Ck, dtype=torch.bool)
    for g in range(G):
        for e in range(E):
            v[g, e, :counts[g][e]] = True
    return v


@pytest.mark.parametrize("G,E,Ck,dtype", [(1, 8, 300, BF16), (3, 4, 50, F32),
                                          (4, 8, 1, BF16), (2, 16, 8, BF16),
                                          (2, 4, 100, F32)])
def test_live_tiles_follow_the_valid_flags(G, E, Ck, dtype):
    rng = np.random.default_rng(G * E + Ck)
    counts = rng.integers(0, Ck + 1, size=(G, E))
    counts[:, 0] = 0                                 # an expert with no token
    counts[0, -1] = Ck                               # every slot valid
    valid = _valid_prefix(G, E, Ck, counts)
    plan = moe_ffn_plan(G, E, Ck, 64, 128, dtype)
    live = live_tiles(valid, plan)
    assert tuple(live.shape) == (E, plan.slot_tiles)
    rows = plan.tile_rows if plan.regime != "stream" else G * Ck
    for e in range(E):
        flags = valid[:, e, :].reshape(-1)
        for i in range(plan.slot_tiles):
            assert bool(live[e, i]) == bool(flags[i * rows:(i + 1) * rows]
                                            .any())
    assert not live[0].any() and live[E - 1].any()
    # a dead tile is a zero block of the plain version's output
    d, ff, t = 64, 128, max(Ck, 4)
    g = torch.Generator().manual_seed(0)
    xg = torch.randn(G, t, d, generator=g).to(dtype)
    top_idx = torch.randint(0, t, (G, E, Ck), generator=g)
    top_w = torch.rand(G, E, Ck, generator=g) * valid
    w = [torch.randn(E, d, ff, generator=g).to(dtype) / 8,
         torch.randn(E, d, ff, generator=g).to(dtype) / 8,
         torch.randn(E, ff, d, generator=g).to(dtype) / 8]
    ye = moe_ffn_ref(xg, top_idx, valid, top_w, *w)
    by_row = ye.permute(1, 0, 2, 3).reshape(E, G * Ck, d)
    for e in range(E):
        for i in range(plan.slot_tiles):
            if not live[e, i]:
                assert not by_row[e, i * rows:(i + 1) * rows].any()


def _stage_inputs(G, t, E, Ck, d, ff, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    xg = torch.randn(G, t, d, generator=g).to(dtype)
    top_idx = torch.stack([torch.stack([torch.randperm(t, generator=g)[:Ck]
                                        for _ in range(E)]) for _ in range(G)])
    top_w = torch.rand(G, E, Ck, generator=g)
    top_w[:, :, Ck // 2:] = 0.0                      # dead slots
    valid = top_w > 0
    w = [(torch.randn(E, d, ff, generator=g) / d ** 0.5).to(dtype),
         (torch.randn(E, d, ff, generator=g) / d ** 0.5).to(dtype),
         (torch.randn(E, ff, d, generator=g) / ff ** 0.5).to(dtype)]
    return xg, top_idx, valid, top_w, w


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_moe_ffn_fn_gradients_equal_plain(dtype):
    xg, top_idx, valid, top_w, w = _stage_inputs(2, 12, 4, 6, 32, 48, dtype,
                                                 5)
    cot = torch.randn(2, 4, 6, 32, generator=torch.Generator().manual_seed(6))

    def grads(fn):
        leaves = [a.clone().requires_grad_(True) for a in [xg, top_w] + w]
        x, tw, wg, wu, wd = leaves
        ye = fn(x, top_idx, valid, tw, wg, wu, wd)
        return [ye] + list(torch.autograd.grad((ye * cot).sum(), leaves))

    # the Function itself (the models' CUDA route; ``moe_ffn_fn`` runs the
    # plain version directly on the CPU)
    got, want = grads(MO.MoEFFN.apply), grads(moe_ffn_ref)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(grads(MO.moe_ffn_fn), want):
        assert torch.equal(a, b)
    # no gradient where none is asked
    ye = MO.moe_ffn_fn(xg, top_idx, valid, top_w.requires_grad_(True), *w)
    (g_tw,) = torch.autograd.grad(ye.sum(), [top_w])
    assert g_tw.shape == top_w.shape


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    xg, top_idx, valid, top_w, w = _stage_inputs(1, 9, 3, 5, 16, 24, F32, 7)
    n = MO.moe_ffn.launches
    assert torch.equal(MO.moe_ffn(xg, top_idx, valid, top_w, *w),
                       moe_ffn_ref(xg, top_idx, valid, top_w, *w))
    assert MO.moe_ffn.launches == n
    meta = [a.to("meta") for a in (xg, top_idx, valid, top_w)]
    with pytest.raises(ValueError, match="device"):
        MO.moe_ffn(*meta, *(a.to("meta") for a in w))


def test_experts_of_the_einsum_dispatch_are_the_plain_version():
    """``_moe_einsum`` keeps ``_experts``, now the plain version's
    ``experts_ref``."""
    xg, top_idx, valid, top_w, w = _stage_inputs(2, 8, 4, 4, 16, 24, F32, 8)
    xe = xg[torch.arange(2)[:, None, None], top_idx]
    params = dict(zip(("w_gate", "w_up", "w_down"), w))
    assert torch.equal(TM._experts(params, xe), experts_ref(xe, *w))


def test_build_source_and_entry_points():
    """The source exists, built with the default flags, with its C entry
    points and ctypes argument types (pointers, ints, the stream)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    src = [s for s in _build.SOURCES
           if str(s.path) == "moe_ffn/csrc/moe_ffn.cu"]
    assert len(src) == 1 and src[0].flags == ()
    text = (_build.KERNELS / src[0].path).read_text()
    assert set(src[0].entry_points) == {"moe_ffn_f32", "moe_ffn_bf16"}
    for name, types in src[0].entry_points.items():
        assert types == [P] * 9 + [I] * 7 + [P]
        assert f'extern "C" int {name}(' in text
    assert MO._ENTRY == {F32: "moe_ffn_f32", BF16: "moe_ffn_bf16"}
    # the source's constants that the mirror repeats
    for const in ("kStreamMaxRows = 16", "kBM = 128", "kBN = 256",
                  "kBK = 64", "kTileStages = 4", "kFM = 64", "kFN = 64",
                  "kFK = 16", "kStages = UP ? 6 : 8", "kCols = 64"):
        assert const in text, const


# ---------------------------------------------------------------------------
# The DTensor route on four gloo CPU ranks
# ---------------------------------------------------------------------------

def _dt_case(tag, ep, fsdp, batch, dm, rank):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import transformer as TT
    from repro_torch.sharding import distribute_tree, params_shardings
    cfg = dataclasses.replace(get("mixtral-8x22b", reduced=True),
                              expert_parallel=ep, fsdp=fsdp, n_layers=1,
                              capacity_factor=1.0)
    params = TT.init_model(cfg, seed=11, device="cpu")
    layer = {k: v[0] for k, v in params["layers"]["l0"]["mlp"].items()}
    specs = params_shardings(cfg, dm, params)
    dt = distribute_tree(params, specs, dm)
    layer_dt = {k: v[0] for k, v in dt["layers"]["l0"]["mlp"].items()}
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(batch, 8, cfg.d_model)).astype(np.float32))
    cot = torch.from_numpy(np.random.default_rng(13).normal(
        size=x.shape).astype(np.float32))
    x_place = [Shard(0) if batch % 2 == 0 else Replicate(), Replicate()]
    x_dt = distribute_tensor(x, dm, x_place)

    def run(p, xx, c):
        xx = xx.detach().requires_grad_(True)
        leaves = [p[k] for k in ("w_gate", "w_up", "w_down")]
        for a in leaves:
            a.requires_grad_(True)
        y = TM.moe_apply(p, cfg, xx)
        g = torch.autograd.grad((y * c).sum(), [xx] + leaves)
        return [y] + list(g)

    want = run(layer, x, cot)
    got = run(layer_dt, x_dt, distribute_tensor(cot, dm, x_place))
    worst = 0.0
    for name, a, b in zip(("y", "x", "w_gate", "w_up", "w_down"), got, want):
        a = a.full_tensor()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= F32_TOL * scale, (tag, name, err, scale)
        worst = max(worst, err / scale)
    placements = {k: str(v.placements) for k, v in layer_dt.items()}
    return worst, placements


def _dt_worker(rank, world, port):
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        dm = device_mesh(make_test_mesh((2, 2)), "cpu")
        for tag, ep, fsdp, batch in DT_CASES:
            worst, placements = _dt_case(tag, ep, fsdp, batch, dm, rank)
            print("RESULT " + json.dumps({"rank": rank, "case": tag,
                                          "worst": worst,
                                          "placements": placements}),
                  flush=True)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def dt_results():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r),
                               str(DT_WORLD), str(port)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(DT_WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {}
    for r, (rc, out) in enumerate(outs):
        tail = "\n".join(out.splitlines()[-30:])
        assert rc == 0, f"rank {r} failed:\n{tail}"
        for line in out.splitlines():
            if line.startswith("RESULT "):
                res = json.loads(line[7:])
                results[(res["rank"], res["case"])] = res
    return results


@pytest.mark.parametrize("tag", [c[0] for c in DT_CASES])
def test_dtensor_route_equals_unsharded(dt_results, tag):
    for r in range(DT_WORLD):
        res = dt_results[(r, tag)]
        assert res["worst"] <= F32_TOL
    places = dt_results[(0, tag)]["placements"]
    ep = dict((c[0], c[1]) for c in DT_CASES)[tag]
    # the expert weights are sharded as the case says: experts (dim 0) or
    # d_ff (w_gate's dim 2) on "model"
    want = "Shard(dim=0)" if ep else "Shard(dim=2)"
    assert want in places["w_gate"], places


if __name__ == "__main__":
    _dt_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)
