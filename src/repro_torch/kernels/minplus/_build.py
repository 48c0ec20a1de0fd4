"""Build and load the minplus CUDA libraries.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library of its own with a plain C interface,
which ctypes loads.  The builds run at first use, from the checkout's own
sources, into ``build/`` at the repository root, one ``nvcc`` per source,
all started together.  Each library is keyed by a hash of its source and
the flags, so a second process finds it and skips the build.  Nothing is
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
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``-fmad=false`` keeps every add a plain IEEE add (no contraction), which
#: the bit-exactness against the reference rests on; ``-Xptxas -v`` puts the
#: registers and shared memory of each kernel into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
#: source -> its C entry points and their argument types (device pointers,
#: int sizes, then the stream); every entry point returns a cudaError_t.
ENTRY_POINTS: Dict[str, Dict[str, List]] = {
    "banded_minplus.cu": {
        name: [_PTR] * 5 + [_INT] * 5 + [_PTR]
        for name in ("banded_chain_f64", "banded_chain_f32")},
    "banded_minplus_kbest.cu": {
        name: [_PTR] * 6 + [_INT] * 6 + [_PTR]
        for name in ("banded_chain_kbest_f64", "banded_chain_kbest_f32")},
}
SOURCES = tuple(CSRC / name for name in ENTRY_POINTS)


@dataclass
class KernelLibrary:
    libs: Dict[str, ctypes.CDLL]       # source file name -> its library
    paths: List[Path]
    build_seconds: float     # wall time of the parallel builds, 0.0 if reused
    log: str                 # nvcc's output (ptxas register/smem report)

    def fn(self, name: str):
        """The C entry point ``name``, from whichever library holds it."""
        for src, names in ENTRY_POINTS.items():
            if name in names:
                return getattr(self.libs[src], name)
        raise KeyError(f"no minplus entry point {name!r}")


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


def _out_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"


def _build_all(todo: List[Tuple[Path, Path]]) -> Tuple[float, str]:
    """Compile every (source, library) pair at once, one nvcc each."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
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
    """The loaded minplus libraries, built first if this checkout has none."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    outs = [_out_path(src) for src in SOURCES]
    todo = [(src, out) for src, out in zip(SOURCES, outs) if not out.exists()]
    seconds, log = _build_all(todo) if todo else (0.0, "")
    libs = {}
    for src, out in zip(SOURCES, outs):
        lib = ctypes.CDLL(str(out))
        for name, argtypes in ENTRY_POINTS[src.name].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[src.name] = lib
    _LIBRARY = KernelLibrary(libs=libs, paths=outs, build_seconds=seconds,
                             log=log)
    return _LIBRARY
