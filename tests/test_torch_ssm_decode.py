"""The Mamba-2 decode core B14 (``kernels/ssm_decode``) on the CPU.

* ``ref.ssm_decode_ref``, the plain version, moved out of
  ``models.ssm.ssm_decode_step``: the step through it equals the step as
  it was written before (kept below) bit for bit over six steps, from a
  zeroed cache and from a prefill cache, in float32 and bfloat16.
* ``ref.ssm_decode_mirror``, the kernel's order of operations, against the
  plain version at every state size the kernel takes: the state and the
  conv cache equal, y within one bf16 ulp of its largest |value| (in
  float32 within the bound of any order of its sum over N).
* ``ops.check_args`` refuses a dtype, a layout or a shape the kernel does
  not take; ``ops.ssm_decode_kernel`` makes one launch a call and counts
  it, and a decode step makes one call an SSM layer (the launch replaced
  by a recorder: the kernel itself runs on the card, in
  ``test_torch_cuda.py``).
* The ``_build.SOURCES`` entry.

The JAX package is not needed: ``test_torch_ssm.py`` holds the step
against it.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get
from repro_torch.kernels import _build
from repro_torch.kernels.ssm_decode import ops
from repro_torch.kernels.ssm_decode.ref import (lanes, softplus,
                                                ssm_decode_mirror,
                                                ssm_decode_ref)
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.layers import linear, rmsnorm

F32, BF16 = torch.float32, torch.bfloat16


def _old_ssm_decode_step(params, cfg, x, cache):
    """``models.ssm.ssm_decode_step`` as it was before B14, verbatim."""
    di, H, P, N = TS.ssm_dims(cfg)
    B = x.shape[0]
    zxbcdt = linear(x, params["in_proj"])
    z, conv_in, dt_raw = TS._split_proj(cfg, zxbcdt)
    # causal conv over [cached w-1 inputs, current]
    hist = torch.cat([cache["conv"], conv_in], dim=1)          # [B,w,C]
    conv_out = ((hist.to(F32) * params["conv_w"].to(F32)).sum(dim=1)
                .to(x.dtype) + params["conv_b"])
    conv_out = F.silu(conv_out.to(F32)).to(x.dtype)
    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)     # [B, .]
    xh = xs.reshape(B, H, P)
    dt = softplus(dt_raw[:, 0].to(F32) + params["dt_bias"])    # [B,H]
    a = torch.exp(-torch.exp(params["A_log"])[None, :] * dt)   # [B,H]
    xdt = xh.to(F32) * dt[..., None]
    state = (cache["state"] * a[:, :, None, None]
             + xdt[..., None] * Bm.to(F32)[:, None, None, :])
    y = torch.bmm(state.reshape(B, H * P, N), Cm.to(F32)[:, :, None])
    y = y.reshape(B, H, P) + xh.to(F32) * params["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.to(F32)).to(x.dtype),
                cfg.norm_eps)
    out = linear(y, params["out_proj"])
    cache["state"].copy_(state)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache


def _layer(cfg, dtype, seed):
    """``ssm_init``'s weights with the per-head terms and the conv bias
    drawn away from their init constants."""
    p = TS.ssm_init(torch.Generator().manual_seed(seed), cfg, dtype, "cpu")
    rng = np.random.default_rng(seed)
    H = p["A_log"].shape[0]
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    p["A_log"] = f(rng.uniform(-1.0, 1.0, H))
    p["D"] = f(rng.uniform(0.5, 1.5, H))
    p["dt_bias"] = f(rng.uniform(-1.0, 1.0, H))
    p["conv_b"] = f(rng.normal(size=p["conv_b"].shape)).to(dtype)
    return p


def _bits(t):
    return t.view(torch.int16) if t.dtype == BF16 else t.view(torch.int32)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("start", ["zeros", "prefill"])
def test_plain_version_equals_the_step_as_it_was(start, dtype):
    """Six steps: the output and the cache after each bit-equal."""
    cfg = get("mamba2-1.3b", reduced=True)
    p = _layer(cfg, dtype, seed=3)
    B = 3
    rng = np.random.default_rng(5)
    x = lambda S: torch.from_numpy(  # noqa: E731
        rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)).to(dtype)
    if start == "zeros":
        c_new = TS.ssm_cache_init(cfg, B, dtype, "cpu")
    else:
        _, c_new = TS.ssm_apply_with_state(p, cfg, x(9))
    c_old = {k: v.clone() for k, v in c_new.items()}
    for _ in range(6):
        xt = x(1)
        state = c_new["state"]
        y_new, c_new = TS.ssm_decode_step(p, cfg, xt, c_new)
        y_old, c_old = _old_ssm_decode_step(p, cfg, xt, c_old)
        assert c_new["state"] is state                # in place
        _equal(y_new, y_old)
        _equal(c_new["state"], c_old["state"])
        _equal(c_new["conv"], c_old["conv"])


def _inputs(B, H, P, N, w, dtype, seed, gate=None):
    """Seeded arguments of one call: the conv cache and the state as a few
    steps leave them, dt_raw spread over softplus's two regimes.  With
    ``gate`` every z is 64, so silu(z) is exactly 64 and the output is
    64 y exactly."""
    rng = np.random.default_rng(seed)
    di, C = H * P, H * P + 2 * N
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    zxbcdt = f(rng.normal(size=(B, 1, 2 * di + 2 * N + H)))
    zxbcdt[..., -H:] = f(rng.uniform(-6.0, 6.0, (B, 1, H)))
    if gate:
        zxbcdt[..., :di] = 64.0
    conv = f(rng.normal(size=(B, w - 1, C)))
    state = f(rng.normal(size=(B, H, P, N)))
    conv_w = f(rng.normal(size=(w, C)) / w ** 0.5)
    conv_b = f(rng.normal(size=C) * 0.1)
    A_log = f(rng.uniform(-1.0, 1.0, H))
    D = f(rng.uniform(0.5, 1.5, H))
    dt_bias = f(rng.uniform(-1.0, 1.0, H))
    return (zxbcdt.to(dtype), conv.to(dtype), state, conv_w.to(dtype),
            conv_b.to(dtype), A_log, D, dt_bias)


def _call(fn, args):
    args = [t.clone() for t in args]
    out = fn(*args)
    return out, args[2], args[1]          # out, state, conv


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


# (B, H, P, N, w): every state size the kernel takes, ragged P against
# a block's rows (4 warps x 32 / L), one tap, mamba2's head at 2 rows
MIRROR_SHAPES = [(2, 4, 16, 16, 4), (3, 2, 24, 32, 4), (2, 3, 9, 64, 3),
                 (2, 2, 64, 128, 4), (1, 2, 5, 256, 2), (2, 3, 7, 16, 1)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,H,P,N,w", MIRROR_SHAPES)
def test_kernel_order_agrees_with_plain_version(B, H, P, N, w, dtype):
    """The state and the conv cache equal.  y, read as the output over a
    gate of exactly 64 (y does not depend on z), within one bf16 ulp of
    max |y| in bf16, and in float32 within 2 (N - 1) 2^-24 sum_n |C_n h_n|
    (the bound of any two orders of the sum over N) plus one ulp of max
    |y| (its add of D x).  With seeded gates the output within that
    scaled by the largest gate, plus one rounding of the product."""
    seed = B * 100 + N + P + w
    for gate in (True, False):
        args = _inputs(B, H, P, N, w, dtype, seed, gate=gate)
        out_r, st_r, cv_r = _call(ssm_decode_ref, args)
        out_m, st_m, cv_m = _call(ssm_decode_mirror, args)
        _equal(st_m, st_r)
        _equal(cv_m, cv_r)
        assert out_m.dtype == dtype and out_m.shape == (B, 1, H * P)
        if gate:
            y_r, y_m = out_r.float() / 64.0, out_m.float() / 64.0
            top = float(y_r.abs().max())
            if dtype == F32:
                terms = st_r.abs() * _c_of(args).abs()[:, None, None, :]
                tol_y = float((2 * (N - 1) * 2.0 ** -24
                               * terms.sum(-1)).max()) + 2.0 ** -23 * top
            else:
                tol_y = _bf16_ulp(top)
            assert float((y_m - y_r).abs().max()) <= tol_y
            continue
        g = F.silu(args[0][:, 0, :H * P].float()).to(dtype).float()
        top = float(out_r.float().abs().max())
        tol = float(g.abs().max()) * tol_y + (
            _bf16_ulp(top) if dtype == BF16 else 2.0 ** -23 * top)
        assert float((out_m.float() - out_r.float()).abs().max()) <= tol


def _c_of(args):
    """C of a call as the plain version computes it, in float32."""
    zxbcdt, conv, state, conv_w, conv_b = args[:5]
    B, H, P, N = state.shape
    conv_in = zxbcdt[:, :, H * P:2 * H * P + 2 * N]
    hist = torch.cat([conv, conv_in], dim=1)
    out = (hist.float() * conv_w.float()).sum(1).to(zxbcdt.dtype) + conv_b
    return F.silu(out.float()).to(zxbcdt.dtype).float()[:, -N:]


def test_lanes_cover_a_state_row_once():
    """A row of N floats on L lanes of CH 4-float words: every n once."""
    for N in ops.STATES:
        L, CH = lanes(N)
        assert L <= 32 and 32 % L == 0 and 4 * L * CH == N
        n = sorted(4 * (c * L + sl) + j for sl in range(L)
                   for c in range(CH) for j in range(4))
        assert n == list(range(N))


def test_check_args_refuses_what_the_kernel_cannot_take():
    good = _inputs(2, 2, 16, 16, 4, BF16, seed=0)
    assert ops.check_args(*good) == (2, 2, 16, 16, 4)

    def bad(i, t, match):
        args = list(good)
        args[i] = t
        with pytest.raises(ValueError, match=match):
            ops.check_args(*args)

    bad(0, good[0].float(), "share float32 or bfloat16")          # dtype
    bad(0, good[0].half(), "share float32 or bfloat16")
    bad(3, good[3].float(), "share float32 or bfloat16")
    bad(2, good[2].bfloat16(), "must be float32")
    bad(5, good[5].double(), "must be float32")
    bad(1, good[1].transpose(1, 2).contiguous().transpose(1, 2),   # layout
        "contiguous")
    bad(2, good[2].transpose(2, 3).contiguous().transpose(2, 3),
        "contiguous")
    bad(0, good[0][..., :-1], "must be")                           # shapes
    bad(1, good[1][:, :2], "must be")
    bad(6, good[6][:1], "must be")
    bad(2, good[2].reshape(2, 2, 256), "expected the state")
    odd = _inputs(2, 2, 16, 24, 4, BF16, seed=0)                   # N = 24
    with pytest.raises(ValueError, match="N in"):
        ops.check_args(*odd)
    wide = _inputs(1, 2, 16, 16, 9, BF16, seed=0)                  # w = 9
    with pytest.raises(ValueError, match="conv of 1..8"):
        ops.check_args(*wide)
    store = torch.zeros(2 * 2 * 16 * 16 + 1)                       # aligned
    shifted = store[1:].view(2, 2, 16, 16)
    bad(2, shifted, "16-byte aligned")


class _Recorder:
    """Stands in for ``_build.launch``: records the entry and the sizes."""

    def __init__(self):
        self.calls = []

    def __call__(self, name, device, *args):
        self.calls.append((name, args[-5:]))


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_a_kernel_call_is_one_launch_counted_once(monkeypatch, dtype):
    rec = _Recorder()
    monkeypatch.setattr(ops, "launch", rec)
    args = _inputs(3, 2, 16, 32, 4, dtype, seed=1)
    n = ops.ssm_decode.launches
    out = ops.ssm_decode_kernel(*args)
    assert ops.ssm_decode.launches == n + 1
    assert rec.calls == [(f"ssm_decode_{'f32' if dtype == F32 else 'bf16'}",
                          (3, 2, 16, 32, 4))]
    assert out.shape == (3, 1, 32) and out.dtype == dtype


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_decode_step_makes_one_call_an_ssm_layer(monkeypatch, arch):
    """Three decode steps of the reduced model through the kernel's route
    (its launch recorded, not run): one launch per SSM layer per step."""
    rec = _Recorder()
    monkeypatch.setattr(ops, "launch", rec)
    monkeypatch.setattr(TS, "ssm_decode", ops.ssm_decode_kernel)
    cfg = get(arch, reduced=True)
    params = TT.init_model(cfg, seed=1, device="cpu")
    caches = TT.init_caches(cfg, 2, 8, device="cpu")
    n_ssm = cfg.n_periods * sum(s.kind == "ssm" for s in cfg.pattern)
    n = ops.ssm_decode.launches
    for pos in range(3):
        TT.decode_step(params, cfg, torch.ones((2, 1), dtype=torch.long),
                       caches, pos)
    assert ops.ssm_decode.launches - n == 3 * n_ssm
    assert len(rec.calls) == 3 * n_ssm


def test_build_sources_entry():
    src = [s for s in _build.SOURCES
           if str(s.path) == "ssm_decode/csrc/ssm_decode.cu"]
    assert len(src) == 1 and src[0].flags == _build.EXACT_FLAGS
    assert set(src[0].entry_points) == set(ops._ENTRY.values())
    for argtypes in src[0].entry_points.values():
        assert argtypes == [_build._PTR] * 10 + [_build._INT] * 5 \
            + [_build._PTR]
    text = (_build.KERNELS / src[0].path).read_text()
    for name in ops._ENTRY.values():
        assert f'extern "C" int {name}(' in text
    assert "kMaxConv = 8;" in text and ops.MAX_CONV == 8
    for N in ops.STATES:
        assert f"case {N}:" in text
