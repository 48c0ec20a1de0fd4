"""Build and load the minplus CUDA library.

The kernel sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which ctypes
loads.  The build runs at first use, from the checkout's own sources, into
``build/`` at the repository root, keyed by a hash of the sources and the
flags: a second process finds the library and skips the build.  Nothing is
built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "banded_minplus.cu",)
#: ``-fmad=false`` keeps every add a plain IEEE add (no contraction), which
#: the bit-exactness against the reference rests on; ``-Xptxas -v`` puts the
#: registers and shared memory of each kernel into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"

_ENTRY_POINTS = ("banded_chain_f64", "banded_chain_f32")


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float     # 0.0 when an earlier build was reused
    log: str                 # nvcc's output (ptxas register/smem report)


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
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the minplus "
                       "CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out: Path) -> tuple:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{log}")
    os.replace(tmp, out)         # atomic: a concurrent build never half-loads
    return seconds, log


def load_library() -> KernelLibrary:
    """The loaded minplus library, built first if this checkout has none."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out = BUILD_DIR / f"minplus_{_digest()}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        seconds, log = _build(out)
    lib = ctypes.CDLL(str(out))
    for name in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _LIBRARY = KernelLibrary(lib=lib, path=out, build_seconds=seconds, log=log)
    return _LIBRARY
