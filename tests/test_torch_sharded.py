"""Sharded execution of the port over a ``DeviceMesh``: the port's
counterpart of ``tests/test_sharding.py`` (the reference's
``jit(step, in_shardings=...)`` under ``activation_sharding(mesh)``).

* One spawn of 8 gloo CPU ranks on the reference's (2, 4) ("data",
  "model") mesh runs every sharded check; run as a script (``python
  tests/test_torch_sharded.py <rank> <world> <port>``) this file is one
  rank.  Inputs are placed by ``launch.dryrun.place_inputs`` (the specs of
  ``sharding/specs.py`` as DTensors) and the step runs under
  ``activation_sharding(device_mesh)``, at the reference's ``_tiny``
  widths (qwen3-4b's vocabulary cut to 250, so that the vocab-parallel
  head pads):

  - a train step of qwen3-4b, mixtral-8x22b, mamba2-1.3b,
    jamba-1.5-large-398b and granite-34b in float32 equals the unsharded
    step: loss and grad norm within rtol 1e-5; every moment within the
    port's gradient tolerance, GRAD_RTOL x its leaf's largest magnitude
    (twice that for the second moment, plus one ulp where it is bf16); and
    every parameter within 1e-5 x its leaf's largest magnitude plus what a
    gradient error of GRAD_RTOL x the leaf's largest gradient moves
    AdamW's first step (``_param_bound``: the step divides by |g| + eps,
    so it amplifies rounding where |g| is near eps).  Tensor-parallel sums
    reorder float adds, so "equal" is within these tolerances, not bit for
    bit.  mixtral and jamba run with a capacity no group fills: with
    drops, a token whose gate weight ties another's to the last bits is
    kept on one side and dropped on the other;
  - in bfloat16, ``loss_fn`` of the five within the reference's rtol 5e-3
    (mixtral and jamba at their own capacity);
  - ``seq_parallel`` under ``remat="full"``: the backward runs on another
    thread, as autograd's CUDA device thread does; the recompute must
    redistribute as the forward did (the context is thread-local), and the
    gradients equal the unsharded ones;
  - six decode steps of qwen3-4b (cache sharded by KV heads) and
    granite-34b (int8, cache sharded by sequence) equal the unsharded
    steps: logits, exit logits and caches, the caches keeping their
    placements.  An int8 entry whose quotient rounds within float32
    rounding of .5 may quantize one step apart: at most one step, in at
    most 0.1% of the entries, and the int8 logits within INT8_RTOL.

* In this process: the unsharded port's ``loss_fn`` equals the
  reference's on the reference's parameters (numpy, through ``convert``);
  ``_sp_constraint`` / ``_head_constraint`` constrain exactly where the
  reference's do, to the same spec, on a ``MeshDesc`` context; B7's
  per-rank KV-head slice refuses a shard it would pair wrongly.

The spawn starts with the first test and runs beside the in-process ones.
"""
import copy
import dataclasses
import datetime
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
ARCHS = ["qwen3-4b", "mixtral-8x22b", "mamba2-1.3b", "jamba-1.5-large-398b",
         "granite-34b"]
DECODE_ARCHS = ["qwen3-4b", "granite-34b"]
#: a vocabulary the tiny widths pad (250 -> 256): the vocab-parallel head's
#: -inf tail and the CE's padded columns
PADDED = {"qwen3-4b": {"vocab_size": 250}}
#: the architectures with MoE layers
MOE_ARCHS = ("mixtral-8x22b", "jamba-1.5-large-398b")
TRAIN_B, TRAIN_S = 4, 32
DECODE_B, DECODE_T, DECODE_STEPS = 8, 128, 6
RTOL = 1e-5
#: a gradient leaf's float32 rounding relative to its largest element: the
#: port's gradients are held to the reference's at 1e-4
#: (tests/test_torch_train.py); jamba's differ there by ~4e-5
GRAD_RTOL = 1e-4
#: an int8 cache: a key or value whose float32 quotient lies within
#: rounding of .5 quantizes one step apart on either side; such an entry
#: moves the logits by ~1e-4 of their largest here
INT8_RTOL = 1e-3
F32 = torch.float32
BF16_RTOL = 5e-3
#: a capacity factor under which no expert of the tiny mixtral or jamba
#: drops a token (capacity >= tokens a group)
NO_DROPS = 64.0


def _tiny(arch, **over):
    """The reference's ``_tiny`` (tests/test_sharding.py) on the port."""
    from repro_torch.configs import get
    cfg = get(arch, reduced=True)
    return dataclasses.replace(cfg, **_tiny_widths(cfg, over))


def _tiny_widths(cfg, over):
    kw = dict(dtype="bfloat16", vocab_pad_multiple=64,
              n_kv_heads=4 if cfg.n_kv_heads else 0,
              d_model=128, d_ff=256 if cfg.d_ff else 0,
              n_heads=8 if cfg.n_heads else 0,
              head_dim=16 if cfg.n_heads else 0,
              ssm_head_dim=32 if cfg.ssm_state else 64)
    kw.update(over)
    return kw


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _close(got, want, what, rtol=RTOL):
    """Within rtol x the largest finite |want|; non-finite entries (a
    padded vocabulary's -inf) equal."""
    got, want = _full(got).double(), want.double()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)), f"{what}: non-finite"
    assert torch.equal(got[~fin], want[~fin]), f"{what}: non-finite"
    got, want = got[fin], want[fin]
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rtol * scale + 1e-12, f"{what}: {err} > {rtol} x {scale}"


def _param_bound(p_want, mu_want, opt):
    """Per element, how far the updated parameter may lie from the
    unsharded one: 1e-5 x the leaf's largest magnitude, plus AdamW's first
    step moved by a gradient error of GRAD_RTOL x the leaf's largest
    (clipped) gradient, through d(g / (|g| + eps)) / dg = eps / (|g| +
    eps)^2."""
    g = mu_want.double() / (1 - opt.b1)
    dg = GRAD_RTOL * float(g.abs().max())
    amp = opt.eps / (g.abs() + opt.eps) ** 2
    return RTOL * float(p_want.abs().max()) + opt.lr * amp * dg + 1e-12


def _placements_kept(placed, out, what):
    for path, x in _flat(placed).items():
        if hasattr(x, "placements"):
            got = _flat(out)[path]
            assert got.placements == x.placements, (what, path,
                                                    got.placements)


def check_train_f32(dm, arch):
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import place_inputs
    from repro_torch.runtime.steps import (build_train_step,
                                           init_train_state, make_optimizer)
    from repro_torch.sharding.context import activation_sharding
    over = {"capacity_factor": NO_DROPS} if arch in MOE_ARCHS else {}
    over.update(PADDED.get(arch, {}))
    cfg = _tiny(arch, dtype="float32", **over)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_B,
                                seq_len=TRAIN_S)
    state = init_train_state(cfg, seed=0, device="cpu")
    batch = _batch(cfg, TRAIN_B, TRAIN_S, seed=1)
    placed = place_inputs(cfg, shape, {"state": copy.deepcopy(state),
                                       "batch": batch}, dm)
    n_sharded = sum(any(not p.is_replicate() for p in x.placements)
                    for x in _flat(placed["state"]["params"]).values())
    assert n_sharded >= 3, f"{n_sharded} sharded parameters"
    step = build_train_step(cfg)
    want, m_want = step(state, batch)
    with activation_sharding(dm):
        got, m_got = step(placed["state"], placed["batch"])
    _close(m_got["loss"], m_want["loss"], "loss")
    _close(m_got["grad_norm"], m_want["grad_norm"], "grad norm")
    assert int(_full(m_got["step"])) == int(m_want["step"]) == 1
    _placements_kept(placed["state"], got, "train state")
    opt = make_optimizer(cfg)
    fw, fg = _flat(want), _flat(got)
    for path, w in fw.items():
        if path.startswith(("/opt/mu", "/opt/nu")):
            # a moment is a gradient's (mu) or its square's (nu, twice the
            # relative error); bf16 moments (master_weights=False) round
            # to one bf16 ulp either way
            rel = GRAD_RTOL * (2 if path.startswith("/opt/nu") else 1)
            err = (_full(fg[path]).double() - w.double()).abs()
            bound = rel * float(w.abs().max()) + (
                0.0 if w.dtype == F32 else 2 ** -7) * w.double().abs()
            assert bool((err <= bound).all()), (
                f"{path}: {float((err - bound).max())} beyond the bound")
        elif path.startswith("/params"):
            bound = _param_bound(w, fw["/opt/mu" + path[len("/params"):]],
                                 opt)
            err = (_full(fg[path]).double() - w.double()).abs()
            assert bool((err <= bound).all()), (
                f"{path}: {int((err > bound).sum())} elements beyond the "
                f"bound, worst {float((err - bound).max())}")
    return f"loss {float(m_want['loss']):.6f}, {len(fw)} leaves"


def check_loss_bf16(dm, arch):
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import place_inputs
    from repro_torch.models import transformer as T
    from repro_torch.sharding.context import activation_sharding
    cfg = _tiny(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_B,
                                seq_len=TRAIN_S)
    params = T.init_model(cfg, seed=0, device="cpu")
    batch = _batch(cfg, TRAIN_B, TRAIN_S, seed=1)
    placed = place_inputs(cfg, shape, {"params": params, "batch": batch}, dm)
    with torch.no_grad():
        want = float(T.loss_fn(params, cfg, batch))
        with activation_sharding(dm):
            got = float(_full(T.loss_fn(placed["params"], cfg,
                                        placed["batch"])))
    assert abs(got - want) <= BF16_RTOL * abs(want), (got, want)
    return f"loss {want:.5f} / {got:.5f}"


def check_seq_parallel_remat(dm):
    """Forward under the context on this thread, backward on another (as
    autograd's device thread on CUDA).  The hook's redistributions are
    counted: the recompute must make as many as the forward did."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import place_inputs
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import value_and_grad
    from repro_torch.sharding.context import activation_sharding
    cfg = _tiny("qwen3-4b", dtype="float32", seq_parallel=True,
                remat="full")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_B,
                                seq_len=TRAIN_S)
    params = T.init_model(cfg, seed=0, device="cpu")
    batch = _batch(cfg, TRAIN_B, TRAIN_S, seed=2)
    placed = place_inputs(cfg, shape, {"params": copy.deepcopy(params),
                                       "batch": batch}, dm)
    loss_want, g_want = value_and_grad(
        lambda p: T.loss_fn(p, cfg, batch), params)
    calls, orig = [], T.constrain

    def counting(h, spec):
        out = orig(h, spec)
        calls.append((threading.get_ident(), tuple(out.placements)))
        return out

    T.constrain = counting
    leaves = tree_leaves(placed["params"])
    try:
        for x in leaves:
            x.requires_grad_(True)
        with activation_sharding(dm):
            loss = T.loss_fn(placed["params"], cfg, placed["batch"])
            n_fwd = len(calls)
            grads = []
            t = threading.Thread(target=lambda: grads.append(
                torch.autograd.grad(loss, leaves)))
            t.start()
            t.join()
    finally:
        T.constrain = orig
        for x in leaves:
            x.requires_grad_(False)
    assert grads, "the backward thread failed"
    main = threading.get_ident()
    n_bwd = sum(1 for tid, _ in calls if tid != main)
    # the recompute may stop before a period's last hook, whose output no
    # saved tensor needs (torch.utils.checkpoint's early stop)
    assert n_fwd > 0 and n_fwd - cfg.n_periods <= n_bwd <= n_fwd, (
        n_fwd, n_bwd)
    want_pl = {pl for _, pl in calls[:n_fwd]}
    assert all(pl in want_pl for _, pl in calls[n_fwd:])
    _close(loss, loss_want, "loss")
    got = dict(zip(_sorted_paths(placed["params"]), grads[0]))
    for path, g in _flat(g_want).items():
        _close(got[path], g, f"grad {path}")
    return (f"{n_fwd} hook redistributions in the forward, {n_bwd} in the "
            f"recompute")


def _sorted_paths(tree, prefix=""):
    """Leaf paths in ``tree_leaves`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _sorted_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def check_decode(dm, arch):
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import place_inputs
    from repro_torch.models import transformer as T
    from repro_torch.runtime.steps import build_serve_step
    from repro_torch.sharding.context import activation_sharding
    over = {"kv_cache_dtype": "int8"} if arch == "granite-34b" else {}
    over.update(PADDED.get(arch, {}))
    cfg = _tiny(arch, dtype="float32", **over)
    shape = dataclasses.replace(SHAPES["decode_32k"],
                                global_batch=DECODE_B, seq_len=DECODE_T)
    params = T.init_model(cfg, seed=0, device="cpu")
    caches = T.init_caches(cfg, DECODE_B, DECODE_T, device="cpu")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DECODE_STEPS, DECODE_B, 1)).astype(np.int32))
    placed = place_inputs(cfg, shape, {
        "params": params, "caches": copy.deepcopy(caches),
        "tokens": tokens[0], "pos": 0}, dm)
    seq = [pl for path, x in _flat(placed["caches"]).items()
           if path.endswith("/k") for pl in x.placements]
    mode = "sequence" if any(p.is_shard(2) for p in seq) else "heads"
    assert mode == ("sequence" if arch == "granite-34b" else "heads"), seq
    assert any(p.is_shard() for p in seq), seq
    step = build_serve_step(cfg)
    dcaches = placed["caches"]
    rtol = INT8_RTOL if cfg.kv_cache_dtype == "int8" else RTOL
    for i in range(DECODE_STEPS):
        lg, caches, ex = step(params, caches, tokens[i], i)
        tok = place_inputs(cfg, shape, {"tokens": tokens[i]}, dm)["tokens"]
        with activation_sharding(dm):
            lg2, out_caches, ex2 = step(placed["params"], dcaches, tok, i)
        assert out_caches is dcaches
        _close(lg2, lg, f"step {i} logits", rtol)
        assert sorted(ex2) == sorted(ex)
        for k in ex:
            _close(ex2[k], ex[k], f"step {i} {k}", rtol)
    _placements_kept(placed["caches"], dcaches, "caches")
    fc = _flat(dcaches)
    flips = 0
    for path, c in _flat(caches).items():
        if c.dtype == torch.int8:
            d = (_full(fc[path]).int() - c.int()).abs()
            assert int(d.max()) <= 1, f"cache {path}: {int(d.max())} steps"
            flips += int((d > 0).sum())
            assert flips <= 1e-3 * c.numel(), f"cache {path}: {flips} flips"
        else:
            _close(fc[path], c, f"cache {path}")
    return (f"{DECODE_STEPS} steps, cache sharded by {mode}; int8 entries "
            f"one step apart: {flips}")


CHECKS = ([(f"train_f32[{a}]", check_train_f32, (a,)) for a in ARCHS]
          + [(f"loss_bf16[{a}]", check_loss_bf16, (a,)) for a in ARCHS]
          + [("seq_parallel_remat", check_seq_parallel_remat, ())]
          + [(f"decode[{a}]", check_decode, (a,)) for a in DECODE_ARCHS])


def _rank(rank, world, port):
    import torch.distributed as dist
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        dm = device_mesh(make_test_mesh((2, 4)), "cpu")
        for name, fn, args in CHECKS:
            try:
                info = fn(dm, *args)
                res = {"check": name, "ok": True, "info": info}
            except AssertionError as e:
                res = {"check": name, "ok": False, "info": str(e)[:2000]}
            if rank == 0:
                print("RESULT " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the spawn
# ---------------------------------------------------------------------------

class _Spawn:
    def __init__(self):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(WORLD), str(port)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    out, _ = p.communicate(timeout=400)
                    outs.append((p.returncode, out))
            finally:
                self.stop()
            for r, (rc, out) in enumerate(outs):
                tail = "\n".join(out.splitlines()[-30:])
                assert rc == 0, f"rank {r} exited {rc}:\n{tail}"
            self._results = {}
            for line in outs[0][1].splitlines():
                if line.startswith("RESULT "):
                    res = json.loads(line[len("RESULT "):])
                    self._results[res["check"]] = res
        return self._results

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def spawn():
    sp = _Spawn()
    yield sp
    sp.stop()


def _result(spawn, name):
    res = spawn.results().get(name)
    assert res is not None, f"the ranks reported nothing for {name}"
    assert res["ok"], f"{name}: {res['info']}"


def test_spawn_started(spawn):
    assert len(spawn.procs) == WORLD


# ---------------------------------------------------------------------------
# in this process: the reference
# ---------------------------------------------------------------------------

def _ref_tiny(arch, **over):
    from repro.configs import get as ref_get
    cfg = ref_get(arch, reduced=True)
    return dataclasses.replace(cfg, **_tiny_widths(cfg, over))


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_loss_equals_the_reference(arch):
    """The unsharded side of the sharded checks against the reference, on
    the reference's parameters (numpy, through ``convert``)."""
    import jax
    from repro.models import transformer as RT

    from repro_torch.convert import transformer_params_from
    from repro_torch.models import transformer as T
    over = {"capacity_factor": NO_DROPS} if arch in MOE_ARCHS else {}
    ref_cfg = _ref_tiny(arch, dtype="float32", **over)
    cfg = _tiny(arch, dtype="float32", **over)
    assert ref_cfg.name == cfg.name and ref_cfg.n_periods == cfg.n_periods
    ref_params = RT.init_model(jax.random.PRNGKey(0), ref_cfg)
    params_np = jax.tree.map(np.asarray, ref_params)
    params = transformer_params_from(params_np, cfg, device="cpu")
    batch = _batch(cfg, TRAIN_B, TRAIN_S, seed=1)
    want = float(jax.jit(lambda p, b: RT.loss_fn(p, ref_cfg, b))(
        ref_params, {k: np.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(T.loss_fn(params, cfg, batch))
    assert got == pytest.approx(want, rel=RTOL)


# ---------------------------------------------------------------------------
# in this process: the hooks alone
# ---------------------------------------------------------------------------

class _StandInMesh:
    """What the reference's ``activation_sharding`` reads of a jax
    ``Mesh``."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


class _Shape:
    """A stand-in array: the reference's hooks read ``ndim`` and
    ``shape``."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(shape)


HOOK_MESHES = {"2x4": (("data", "model"), (2, 4)),
               "16x16": (("data", "model"), (16, 16)),
               "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
               "data_only": (("data",), (8,))}


def _ref_decision(monkeypatch, fn):
    """The spec the reference's hook constrains to (None: it returns its
    input untouched)."""
    import jax
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    fn()
    return seen[0] if seen else None


def _norm(spec):
    from repro_torch.sharding.specs import _spec
    return None if spec is None else _spec(*spec)


def _hook_cfgs(arch):
    from repro.configs import get as ref_get

    from repro_torch.configs import get
    out = []
    for optimized in (False, True):
        for over in ({}, {"seq_parallel": True}, {"ssm_head_shard": True},
                     {"seq_parallel": False, "ssm_head_shard": False}):
            out.append((dataclasses.replace(
                ref_get(arch, optimized=optimized), **over),
                dataclasses.replace(get(arch, optimized=optimized), **over)))
    return out


@pytest.mark.parametrize("mesh", list(HOOK_MESHES) + [None])
@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-1.5-large-398b"])
def test_sp_constraint_decides_as_the_reference(arch, mesh, monkeypatch):
    import contextlib

    from repro.models import transformer as RT
    from repro.sharding import context as RCTX

    from repro_torch.launch.mesh import MeshDesc
    from repro_torch.models import transformer as T
    from repro_torch.sharding import context as CTX
    n = 0
    for ref_cfg, cfg in _hook_cfgs(arch):
        for shape in ((256, 4096, 8), (4, 64, 8), (3, 6, 8), (512, 32, 8),
                      (16, 16), (128, 1, 8)):
            if mesh is None:
                ctxs = (contextlib.nullcontext(), contextlib.nullcontext())
            else:
                names, sizes = HOOK_MESHES[mesh]
                ctxs = (RCTX.activation_sharding(_StandInMesh(names, sizes)),
                        CTX.activation_sharding(MeshDesc(names, sizes)))
            with ctxs[0], ctxs[1]:
                want = _ref_decision(monkeypatch, lambda: RT._sp_constraint(
                    ref_cfg, _Shape(shape)))
                got = T._sp_spec(cfg, shape)
                h = torch.zeros(shape[:2] or (1,), dtype=torch.float32)
                assert T._sp_constraint(cfg, h) is h   # plain: untouched
            assert _norm(got) == _norm(want), (cfg.name, shape, got, want)
            n += got is not None
    if mesh is None or mesh != "data_only":
        assert (n > 0) == (mesh is not None)


@pytest.mark.parametrize("mesh", list(HOOK_MESHES) + [None])
def test_head_constraint_decides_as_the_reference(mesh, monkeypatch):
    import contextlib

    from repro.models import ssm as RSSM
    from repro.sharding import context as RCTX

    from repro_torch.launch.mesh import MeshDesc
    from repro_torch.models import ssm as SSM
    from repro_torch.sharding import context as CTX
    n = 0
    for ref_cfg, cfg in _hook_cfgs("jamba-1.5-large-398b"):
        for shape, axis in (((4, 64, 256, 64), 2), ((4, 64, 256), 2),
                            ((4, 256, 64, 16), 1), ((4, 64, 6, 64), 2),
                            ((2, 10, 3), 2)):
            if mesh is None:
                ctxs = (contextlib.nullcontext(), contextlib.nullcontext())
            else:
                names, sizes = HOOK_MESHES[mesh]
                ctxs = (RCTX.activation_sharding(_StandInMesh(names, sizes)),
                        CTX.activation_sharding(MeshDesc(names, sizes)))
            with ctxs[0], ctxs[1]:
                want = _ref_decision(monkeypatch, lambda: RSSM._head_constraint(
                    ref_cfg, _Shape(shape), axis))
                got = SSM._head_spec(cfg, shape, axis)
                x = torch.zeros(2, 2)
                assert SSM._head_constraint(cfg, x, 1) is x
            assert _norm(got) == _norm(want), (shape, axis, got, want)
            n += got is not None
    assert (n > 0) == (mesh not in (None, "data_only"))


@pytest.mark.parametrize("h0, Hl, H, KV, kv0, KVl, want", [
    (0, 4, 32, 8, 0, 1, (0, 1)),        # heads sharded: one KV head, G 4
    (8, 8, 32, 8, 2, 2, (2, 4)),        # two whole groups
    (2, 2, 8, 4, 0, 4, (1, 2)),         # KV replicated, q sharded
    (4, 2, 12, 3, 0, 3, (1, 2)),        # within one KV head (G 4)
    (3, 3, 12, 3, 0, 3, None),          # straddles two groups
    (0, 4, 32, 8, 1, 1, None),          # the rank lacks the KV head
    (4, 8, 32, 4, 0, 4, None),          # not whole groups (G 8)
])
def test_kv_heads_read_checks_b7s_grouping(h0, Hl, H, KV, kv0, KVl, want):
    from repro_torch.models.attention import kv_heads_read
    if want is None:
        with pytest.raises(ValueError, match="whole KV heads"):
            kv_heads_read(h0, Hl, H, KV, kv0, KVl)
    else:
        assert kv_heads_read(h0, Hl, H, KV, kv0, KVl) == want


def test_activation_sharding_keeps_a_device_mesh_only():
    from repro_torch.launch.mesh import MeshDesc
    from repro_torch.sharding import context as CTX
    assert CTX.current() is None and CTX.current_mesh() is None
    with CTX.activation_sharding(MeshDesc(("data", "model"), (2, 4))) as c:
        assert CTX.current() == c and CTX.current_mesh() is None
        state = CTX.captured()
        seen = []
        t = threading.Thread(target=lambda: seen.append(CTX.captured()))
        t.start()
        t.join()
        assert seen == [(None, None)]
        t = threading.Thread(target=lambda: seen.append(
            _entered_in_thread(CTX, state)))
        t.start()
        t.join()
        assert seen[1] == (c, None)
    assert CTX.captured() == (None, None)


def _entered_in_thread(CTX, state):
    with CTX.entered(state):
        return CTX.captured()


# ---------------------------------------------------------------------------
# the ranks' results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_unsharded(spawn, arch):
    _result(spawn, f"train_f32[{arch}]")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_bf16_loss_equals_unsharded(spawn, arch):
    _result(spawn, f"loss_bf16[{arch}]")


def test_seq_parallel_remat_backward_on_another_thread(spawn):
    _result(spawn, "seq_parallel_remat")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_decode_equals_unsharded(spawn, arch):
    _result(spawn, f"decode[{arch}]")
