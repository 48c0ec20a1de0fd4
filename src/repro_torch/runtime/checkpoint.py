"""Checkpointing: atomic, step-tagged tree save/restore with zstd.

Port of ``repro/runtime/checkpoint.py`` with the same on-disk layout, so a
checkpoint written by either package loads in the other through
:func:`load_arrays`.

``zstandard`` is optional: without it, saves are uncompressed npz bytes
under the same layout and restore transparently handles both (it sniffs the
zstd frame magic); restoring a compressed checkpoint without the module
raises a clear ModuleNotFoundError.

Layout:   <dir>/step_<N>/ { manifest.json, arrays.npz.zst }
Writes go to a temp dir + atomic rename, so a crash mid-save never corrupts
the latest checkpoint.  ``restore_latest`` resumes from the newest complete
checkpoint; damaged or partial directories are skipped.

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
numpy arrays, scalars or torch tensors (saved through ``.detach().cpu()``).
It flattens as jax flattens a pytree: dict keys in sorted order, a
NamedTuple's fields in field order, ``None`` leaves dropped, and each leaf
keyed by the ``/``-joined path of its dict keys, field names and sequence
indices (an ``AdamWState`` gives ``opt/step``, ``opt/mu/...``,
``opt/nu/...``, as the reference names it).  bfloat16 leaves are stored
as a ``uint16`` view under the dtype string ``"bfloat16"``;
:func:`load_arrays` and :func:`restore` return that ``uint16`` array
(view it as ``torch.bfloat16``).
"""
from __future__ import annotations

import io
import json
import os
import pathlib
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

try:
    import zstandard
except ModuleNotFoundError:      # optional: fall back to uncompressed npz
    zstandard = None

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz.zst"

#: zstd frame magic — restore sniffs it to pick the decompressor, so saves
#: from environments with and without ``zstandard`` interoperate.
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _leaves(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in jax's flatten order: sorted dict keys, a
    NamedTuple's fields in field order and named by field, sequence order,
    ``None`` dropped."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _as_array(leaf) -> Tuple[np.ndarray, str]:
    """(storable host array, manifest dtype string) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        v = t.numpy()
    else:
        v = np.asarray(leaf)
    if v.dtype.kind == "V" or str(v.dtype) == "bfloat16":
        return v.view(np.uint16), "bfloat16"
    return v, str(v.dtype)


def _flatten(tree) -> List[Tuple[str, np.ndarray, str]]:
    return [("/".join(path),) + _as_array(leaf)
            for path, leaf in _leaves(tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from ``leaves``
    (dicts come back in sorted key order, as jax rebuilds them; a
    NamedTuple comes back as its own type)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        return out if isinstance(like, list) else tuple(out)
    return next(leaves)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         extra: Optional[Dict] = None) -> str:
    """Atomically write ``tree`` as step ``step``; prune old checkpoints."""
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)

    buf = io.BytesIO()
    np.savez(buf, **{k: v for k, v, _ in flat})
    if zstandard is not None:
        comp = zstandard.ZstdCompressor(level=3).compress(buf.getvalue())
    else:
        comp = buf.getvalue()    # uncompressed npz under the same filename

    manifest = {
        "step": int(step),
        "time": time.time(),
        "keys": [k for k, _, _ in flat],
        "dtypes": {k: d for k, _, d in flat},
        "shapes": {k: list(v.shape) for k, v, _ in flat},
        "extra": extra or {},
    }
    tmp = tempfile.mkdtemp(dir=base, prefix=".tmp_")
    try:
        (pathlib.Path(tmp) / ARRAYS).write_bytes(comp)
        (pathlib.Path(tmp) / MANIFEST).write_text(json.dumps(manifest))
        final = base / f"step_{step:012d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _prune(base, keep)
    return str(final)


def _prune(base: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in base.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def _complete(p: pathlib.Path) -> bool:
    return (p / MANIFEST).exists() and (p / ARRAYS).exists()


def available_steps(ckpt_dir: str) -> List[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return []
    out = []
    for p in sorted(base.iterdir()):
        if p.is_dir() and p.name.startswith("step_") and _complete(p):
            out.append(int(p.name.split("_")[1]))
    return out


def _read_arrays(base: pathlib.Path) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Read and verify one ``step_<N>`` directory → (arrays, manifest).

    Raises on any damage: truncated/corrupt ``arrays.npz.zst``, keys or
    shapes that disagree with the manifest, unreadable manifest.  Callers
    that must survive damage (``restore_latest``) catch and skip.
    """
    raw = (base / ARRAYS).read_bytes()
    if raw[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise ModuleNotFoundError(
                f"checkpoint {base} is zstd-compressed but the 'zstandard' "
                "module is not installed — install zstandard to restore it")
        raw = zstandard.ZstdDecompressor().decompress(raw)
    arrays = dict(np.load(io.BytesIO(raw)))
    manifest = json.loads((base / MANIFEST).read_text())
    keys = manifest.get("keys", [])
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise KeyError(f"checkpoint {base}: arrays missing manifest keys "
                       f"{missing[:5]}")
    for k in keys:
        want = manifest.get("shapes", {}).get(k)
        if want is not None and list(arrays[k].shape) != list(want):
            raise ValueError(f"checkpoint {base}: {k} shape "
                             f"{list(arrays[k].shape)} != manifest {want}")
    return arrays, manifest


def load_arrays(ckpt_dir: str, step: int) -> Tuple[Dict[str, np.ndarray],
                                                   Dict]:
    """Load a checkpoint as a flat ``{key: array}`` dict plus its manifest.

    Unlike :func:`restore` this needs no shape-matched ``like`` tree, so it
    suits state whose leaf shapes vary run-to-run (e.g. a cohort-state
    table whose row count depends on churn history).  Keys are the
    ``/``-joined tree paths produced by :func:`save`; a bfloat16 leaf comes
    back as its ``uint16`` view (``manifest["dtypes"]`` says
    ``"bfloat16"``).
    """
    base = pathlib.Path(ckpt_dir) / f"step_{step:012d}"
    return _read_arrays(base)


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like`` (a tree of arrays/tensors,
    read for its shapes); the leaves come back as host arrays."""
    base = pathlib.Path(ckpt_dir) / f"step_{step:012d}"
    arrays, _ = _read_arrays(base)
    leaves = []
    for path, ref in _leaves(like):
        key = "/".join(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        want = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(want)}")
        leaves.append(arr)
    return _unflatten(like, iter(leaves))


def restore_latest(ckpt_dir: str, like) -> Optional[Tuple[int, Any]]:
    for step in reversed(available_steps(ckpt_dir)):
        try:
            return step, restore(ckpt_dir, step, like)
        except Exception:
            continue  # damaged checkpoint: fall back to the previous one
    return None
