"""Build and load the port's CUDA libraries.

Every kernel source of the port (``<family>/csrc/*.cu``) is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library of its own with a
plain C interface, which ctypes loads.  The builds run at first use, from
the checkout's own sources, into ``build/`` at the repository root, one
``nvcc`` per source, all started together.  Each library is keyed by a
hash of its source and its flags, so a second process finds it and skips
the build.  Nothing is built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

KERNELS = Path(__file__).resolve().parent
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: ``-fmad=false`` keeps every add of the (min,+) kernels a plain IEEE add
#: (no contraction), which their bit-exactness against the reference rests
#: on, as the fused ingest's byte-equal signatures rest on its IEEE order.
#: The optimizer kernels (``adamw/csrc/adamw.cu``: B13's update bit-equal
#: to its plain version, B12's norm repeating bit for bit) and the Mamba-2
#: decode core (``ssm_decode/csrc/ssm_decode.cu``: its state and conv cache
#: equal to the plain version's) rest on it too.
#: The exit gate, the attention kernels, the SSD scan, the MoE experts'
#: kernel and the training loss are held to a tolerance and keep the
#: default contraction.
#: ``-Xptxas -v`` puts the registers and shared memory of each kernel into
#: the build log.
EXACT_FLAGS = ("-fmad=false",)
BUILD_DIR = KERNELS.parents[2] / "build"

_PTR, _INT, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


@dataclass(frozen=True)
class Source:
    path: Path                      # relative to ``kernels/``
    flags: Tuple[str, ...]          # besides BASE_FLAGS
    #: C entry point -> argument types (device pointers, int sizes, a
    #: double where a value must reach the kernel unrounded, then the
    #: stream); every entry point returns a cudaError_t
    entry_points: Dict[str, List]


SOURCES: Tuple[Source, ...] = (
    # init, E, st, hist, arg | B, L, N, G+1, lo, init row, scenarios a
    # group, threads a block, blocks | stream
    Source(Path("minplus/csrc/banded_minplus.cu"), EXACT_FLAGS,
           {name: [_PTR] * 5 + [_INT] * 9 + [_PTR]
            for name in ("banded_chain_f64", "banded_chain_f32")}),
    # init, E, st, hist, par_n, par_k | B, L, N, G+1, K, lo, scenarios a
    # block, threads a block | stream
    Source(Path("minplus/csrc/banded_minplus_kbest.cu"), EXACT_FLAGS,
           {name: [_PTR] * 6 + [_INT] * 8 + [_PTR]
            for name in ("banded_chain_kbest_f64", "banded_chain_kbest_f32")}),
    # dist, W, out, arg | B, S, T, W's batch stride, per, Q | stream
    Source(Path("minplus/csrc/minplus_dense.cu"), EXACT_FLAGS,
           {name: [_PTR] * 4 + [_INT] * 6 + [_PTR]
            for name in ("minplus_f64", "minplus_f32", "minplus_argmin_f64",
                         "minplus_argmin_f32")}),
    # logits, conf, arg | B, V, P | stream
    Source(Path("ee_gate/csrc/ee_gate.cu"), (),
           {name: [_PTR] * 3 + [_INT] * 3 + [_PTR]
            for name in ("ee_gate_f32", "ee_gate_bf16")}),
    # q, k, v, cache_pos, out | B, T, H, KV, D, pos, window, P | stream
    Source(Path("decode_attn/csrc/decode_attn.cu"), (),
           {name: [_PTR] * 5 + [_INT] * 8 + [_PTR]
            for name in ("decode_attn_f32", "decode_attn_bf16")}),
    # q, k, v, q_pos, k_pos, tile map, out | B, Sq, Sk, H, KV, D, causal,
    # window, n_pad | stream
    Source(Path("prefill_attn/csrc/prefill_attn.cu"), (),
           {name: [_PTR] * 7 + [_INT] * 9 + [_PTR]
            for name in ("prefill_attn_f32", "prefill_attn_bf16")}),
    # xh, B, C, dt, a_log, y, final state, states, G, la, la_last | B, S,
    # H, P, N, Q | stream
    Source(Path("ssd_scan/csrc/ssd_scan.cu"), (),
           {name: [_PTR] * 11 + [_INT] * 6 + [_PTR]
            for name in ("ssd_scan_f32", "ssd_scan_bf16")}),
    # the Mamba-2 decode core B14 (two launches): zxbcdt, conv cache,
    # state, conv_w, conv_b, A_log, D, dt_bias, u, out | B, H, P, N, w |
    # stream
    Source(Path("ssm_decode/csrc/ssm_decode.cu"), EXACT_FLAGS,
           {name: [_PTR] * 10 + [_INT] * 5 + [_PTR]
            for name in ("ssm_decode_f32", "ssm_decode_bf16")}),
    # xg, top_idx, valid, top_w, w_gate, w_up, w_down, h, ye | G, t, d, E,
    # Ck, ff, regime | stream
    Source(Path("moe_ffn/csrc/moe_ffn.cu"), (),
           {name: [_PTR] * 9 + [_INT] * 7 + [_PTR]
            for name in ("moe_ffn_f32", "moe_ffn_bf16")}),
    # the training loss B11: K1 + combine (h, w, labels, part, lse, stats,
    # loss | N, d, V, vocab, col0, w stored [d, V], splits), the combine
    # alone (part, labels, lse, stats, loss | N, splits), K2 (h, w, labels,
    # lse, scale, dl | N, d, V, vocab, col0, w stored [d, V]) and K3 (a, b,
    # c_in, out, work, sem | M, N, K, a stored [K][M], b stored [K][N],
    # split, float32 out) | stream
    Source(Path("linear_ce/csrc/linear_ce.cu"), (),
           {**{f"linear_ce_fwd_{t}": [_PTR] * 7 + [_INT] * 7 + [_PTR]
               for t in ("f32", "bf16")},
            "linear_ce_combine": [_PTR] * 5 + [_INT] * 2 + [_PTR],
            **{f"linear_ce_dlogits_{t}": [_PTR] * 6 + [_INT] * 6 + [_PTR]
               for t in ("f32", "bf16")},
            **{f"linear_ce_gemm_{t}": [_PTR] * 6 + [_INT] * 7 + [_PTR]
               for t in ("f32", "bf16")}}),
    # the optimizer programs: B12's chunk pass (table, partials | L, C), its
    # finish (table, partials, leaf sums, norm, scale | L, C, mode |
    # max_norm, 1e-9) and B13 (table, lr, bc1, bc2, scale | L, C | b1,
    # 1 - b1, b2, 1 - b2, eps, weight decay) | stream
    Source(Path("adamw/csrc/adamw.cu"), EXACT_FLAGS,
           {"adamw_norm_partials": [_PTR] * 2 + [_INT] * 2 + [_PTR],
            "adamw_norm_finish": [_PTR] * 5 + [_INT] * 3 + [_DBL] * 2
            + [_PTR],
            "adamw_update": [_PTR] * 5 + [_INT] * 2 + [_DBL] * 6 + [_PTR]}),
    # vec, bits, C, mask, load, out | Us, K2, N, M, mode0, mode1, gamma |
    # delta | stream; and its fast-path divide: a, b, q | n | stream
    Source(Path("ee_gate/csrc/quant_signature.cu"), EXACT_FLAGS,
           {"quant_signature": [_PTR] * 6 + [_INT] * 7 + [_DBL] + [_PTR],
            "quant_signature_divide": [_PTR] * 3 + [_INT] + [_PTR]}),
)


@dataclass
class KernelLibrary:
    libs: Dict[str, ctypes.CDLL]       # source file name -> its library
    paths: List[Path]
    build_seconds: float     # wall time of the parallel builds, 0.0 if reused
    log: str                 # nvcc's output (ptxas register/smem report)

    def fn(self, name: str):
        """The C entry point ``name``, from whichever library holds it."""
        for src in SOURCES:
            if name in src.entry_points:
                return getattr(self.libs[src.path.name], name)
        raise KeyError(f"no CUDA entry point {name!r}")


_LIBRARY: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the port's "
                       "CUDA kernels cannot be built")


def _flags(src: Source) -> Tuple[str, ...]:
    return BASE_FLAGS + src.flags


def _out_path(src: Source) -> Path:
    h = hashlib.sha256((KERNELS / src.path).read_bytes())
    h.update(" ".join(_flags(src)).encode())
    return BUILD_DIR / f"{src.path.stem}_{h.hexdigest()[:16]}.so"


def _build_all(todo: List[Tuple[Source, Path]]) -> Tuple[float, str]:
    """Compile every (source, library) pair at once, one nvcc each."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(src), "-o", str(tmp), str(KERNELS / src.path)]
        procs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, tmp, out, proc in procs:
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{log}")
        else:
            os.replace(tmp, out)   # atomic: never half-loaded by a reader
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0, "".join(logs)


def load_library() -> KernelLibrary:
    """Every kernel library of the port, built first if this checkout has
    none."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    outs = [_out_path(src) for src in SOURCES]
    todo = [(src, out) for src, out in zip(SOURCES, outs) if not out.exists()]
    seconds, log = _build_all(todo) if todo else (0.0, "")
    libs = {}
    for src, out in zip(SOURCES, outs):
        lib = ctypes.CDLL(str(out))
        for name, argtypes in src.entry_points.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[src.path.name] = lib
    _LIBRARY = KernelLibrary(libs=libs, paths=outs, build_seconds=seconds,
                             log=log)
    return _LIBRARY


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM):
    the split plans of the dense product and the exit gate aim at it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(name: str, device, *args) -> None:
    """Launch C entry point ``name`` on ``device``'s current stream; a
    refused launch raises (it never ran, and no synchronize reports it)."""
    fn = load_library().fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
