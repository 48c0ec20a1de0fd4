"""The port's checkpoint store (``repro_torch.runtime.checkpoint``) vs the
JAX package's.

Counterpart of the checkpoint tests of ``tests/test_runtime.py``: round
trip, pruning, the damaged / truncated / manifest-mismatch fallbacks,
partial temp dirs and ``load_arrays``' flat keys, on trees of torch tensors
and numpy arrays.  Beyond them: a tree saved by either package loads
through the other's ``load_arrays`` with the same keys, dtypes and bytes;
the two manifests of one tree agree on ``keys``, ``dtypes`` and
``shapes``; and both directions hold with ``zstandard`` absent (the
uncompressed layout).
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import checkpoint as rck

from repro_torch.runtime import checkpoint as ckpt


@pytest.fixture()
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpts")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": [torch.ones(2),
                             torch.zeros(3, dtype=torch.bfloat16)]}}


def _np_tree(seed=0):
    """One tree as numpy leaves (bf16 as its uint16 bits) and as jax
    arrays, from a seed: the same bytes in both packages' forms."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((4, 8)).astype(np.float32)
    bf = (rng.integers(0, 2 ** 16, 5, dtype=np.uint16) & 0x7F7F)
    flags = rng.random(6) < 0.5
    ints = rng.integers(-9, 9, (3, 2))
    np_tree = {"z": {"w": a, "flags": flags}, "m": [ints, np.float64(2.5)],
               "bf": torch.from_numpy(bf.view(np.int16).copy())
               .view(torch.bfloat16)}
    jx_tree = {"z": {"w": jnp.asarray(a), "flags": jnp.asarray(flags)},
               "m": [ints, np.float64(2.5)],
               "bf": jnp.asarray(bf).view(jnp.bfloat16)}
    return np_tree, jx_tree, bf


def test_checkpoint_roundtrip(tmp_ckpt):
    tree = _tree()
    ckpt.save(tmp_ckpt, 7, tree)
    assert ckpt.available_steps(tmp_ckpt) == [7]
    like = {"a": torch.zeros(4, 8),
            "nested": {"b": torch.zeros(10, dtype=torch.int32),
                       "c": [torch.zeros(2),
                             torch.ones(3, dtype=torch.bfloat16)]}}
    got = ckpt.restore(tmp_ckpt, 7, like)
    bf = got["nested"]["c"][1]
    assert bf.dtype == np.uint16            # bf16 comes back as its bits
    assert torch.equal(torch.from_numpy(bf.view(np.int16).copy())
                       .view(torch.bfloat16), tree["nested"]["c"][1])
    for a, b in ((tree["a"], got["a"]),
                 (tree["nested"]["b"], got["nested"]["b"]),
                 (tree["nested"]["c"][0], got["nested"]["c"][0])):
        assert isinstance(b, np.ndarray) and str(a.dtype)[6:] == str(b.dtype)
        assert np.array_equal(a.numpy(), b)
    got_np = ckpt.restore(tmp_ckpt, 7, {"a": np.zeros((4, 8))})
    assert np.array_equal(got_np["a"], tree["a"].numpy())


def test_checkpoint_prune_and_latest(tmp_ckpt):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_ckpt, s, tree, keep=3)
    assert ckpt.available_steps(tmp_ckpt) == [3, 4, 5]
    step, _ = ckpt.restore_latest(tmp_ckpt, tree)
    assert step == 5
    assert ckpt.restore_latest(tmp_ckpt + "_none", tree) is None


def test_checkpoint_damaged_fallback(tmp_ckpt):
    tree = _tree()
    ckpt.save(tmp_ckpt, 1, tree)
    ckpt.save(tmp_ckpt, 2, tree)
    p = pathlib.Path(tmp_ckpt) / "step_000000000002" / ckpt.ARRAYS
    p.write_bytes(b"garbage")
    step, _ = ckpt.restore_latest(tmp_ckpt, tree)
    assert step == 1


def test_checkpoint_atomicity_no_partial_dirs(tmp_ckpt):
    ckpt.save(tmp_ckpt, 1, _tree())
    names = [p.name for p in pathlib.Path(tmp_ckpt).iterdir()]
    assert all(not n.startswith(".tmp_") for n in names)


def test_checkpoint_truncated_arrays_fall_back(tmp_ckpt):
    tree = _tree()
    ckpt.save(tmp_ckpt, 1, tree)
    ckpt.save(tmp_ckpt, 2, tree)
    p = pathlib.Path(tmp_ckpt) / "step_000000000002" / ckpt.ARRAYS
    p.write_bytes(p.read_bytes()[:30])      # cut mid-frame
    step, _ = ckpt.restore_latest(tmp_ckpt, tree)
    assert step == 1


def test_checkpoint_manifest_mismatch_falls_back(tmp_ckpt):
    tree = _tree()
    ckpt.save(tmp_ckpt, 1, tree)
    ckpt.save(tmp_ckpt, 2, tree)
    mpath = pathlib.Path(tmp_ckpt) / "step_000000000002" / ckpt.MANIFEST
    man = json.loads(mpath.read_text())
    man["shapes"]["a"] = [9, 9]             # arrays no longer match
    mpath.write_text(json.dumps(man))
    step, _ = ckpt.restore_latest(tmp_ckpt, tree)
    assert step == 1
    man["shapes"]["a"] = [4, 8]
    man["keys"].append("ghost/leaf")
    mpath.write_text(json.dumps(man))
    with pytest.raises(KeyError, match="ghost"):
        ckpt.load_arrays(tmp_ckpt, 2)
    step, _ = ckpt.restore_latest(tmp_ckpt, tree)
    assert step == 1


def test_checkpoint_partial_tmp_dir_is_ignored(tmp_ckpt):
    tree = _tree()
    ckpt.save(tmp_ckpt, 3, tree)
    leftover = pathlib.Path(tmp_ckpt) / ".tmp_abandoned"
    leftover.mkdir()
    (leftover / ckpt.MANIFEST).write_text("{}")
    (pathlib.Path(tmp_ckpt) / "step_000000000009").mkdir()
    assert ckpt.available_steps(tmp_ckpt) == [3]
    step, _ = ckpt.restore_latest(tmp_ckpt, tree)
    assert step == 3


def test_load_arrays_roundtrip_flat_keys(tmp_ckpt):
    tree = _tree()
    ckpt.save(tmp_ckpt, 4, tree, extra={"trace_pos": 11})
    arrays, manifest = ckpt.load_arrays(tmp_ckpt, 4)
    assert manifest["extra"]["trace_pos"] == 11
    assert set(arrays) == {"a", "nested/b", "nested/c/0", "nested/c/1"}
    np.testing.assert_array_equal(arrays["nested/b"], np.arange(10))
    assert manifest["dtypes"]["nested/c/1"] == "bfloat16"
    assert arrays["nested/c/1"].dtype == np.uint16
    assert torch.equal(torch.from_numpy(arrays["nested/c/1"].view(np.int16))
                       .view(torch.bfloat16), tree["nested"]["c"][1])


def test_flatten_order_is_jax_order(tmp_ckpt):
    """Dict keys sorted whatever the insertion order, ``None`` dropped,
    sequence indices in the path."""
    tree = {"b": [np.ones(2), None, (np.zeros(1), np.int64(3))],
            "a": {"z": 1, "y": np.float32(2)}, "c": None}
    ckpt.save(tmp_ckpt, 1, tree)
    _, man = ckpt.load_arrays(tmp_ckpt, 1)
    assert man["keys"] == ["a/y", "a/z", "b/0", "b/2/0", "b/2/1"]
    assert man["dtypes"]["a/z"] == "int64"
    assert man["dtypes"]["a/y"] == "float32"


def _same_load(a, b, bf):
    (fa, ma), (fb, mb) = a, b
    assert ma["keys"] == mb["keys"]
    assert ma["dtypes"] == mb["dtypes"]
    assert ma["shapes"] == mb["shapes"]
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), k
    assert np.asarray(fb["bf"]).view(np.uint16).tobytes() == bf.tobytes()


@pytest.mark.parametrize("zstd", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_cross_package_load_both_ways(tmp_path, monkeypatch, zstd, seed):
    """A tree saved by the reference loads through the port's
    ``load_arrays`` and the reverse, with equal keys, dtypes, shapes and
    bytes; both packages' own loads agree with the other's."""
    if not zstd:
        monkeypatch.setattr(ckpt, "zstandard", None)
        monkeypatch.setattr(rck, "zstandard", None)
    np_tree, jx_tree, bf = _np_tree(seed)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    rck.save(d_ref, 5, jx_tree, extra={"who": "ref"})
    ckpt.save(d_port, 5, np_tree, extra={"who": "port"})
    magic = (pathlib.Path(d_port) / "step_000000000005"
             / ckpt.ARRAYS).read_bytes()[:4]
    assert (magic == ckpt._ZSTD_MAGIC) == zstd
    # the two manifests of one tree
    _same_load(rck.load_arrays(d_ref, 5), ckpt.load_arrays(d_port, 5), bf)
    # reference-written, port-read; port-written, reference-read
    _same_load(rck.load_arrays(d_ref, 5), ckpt.load_arrays(d_ref, 5), bf)
    _same_load(rck.load_arrays(d_port, 5), ckpt.load_arrays(d_port, 5), bf)
    assert ckpt.load_arrays(d_ref, 5)[1]["extra"] == {"who": "ref"}
    assert rck.load_arrays(d_port, 5)[1]["extra"] == {"who": "port"}


def test_compressed_checkpoint_without_zstandard_raises(tmp_ckpt,
                                                        monkeypatch):
    ckpt.save(tmp_ckpt, 1, _tree())
    monkeypatch.setattr(ckpt, "zstandard", None)
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        ckpt.load_arrays(tmp_ckpt, 1)
    assert ckpt.restore_latest(tmp_ckpt, _tree()) is None


def test_restore_rejects_missing_and_misshapen_leaves(tmp_ckpt):
    ckpt.save(tmp_ckpt, 1, _tree())
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(tmp_ckpt, 1, {"nope": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_ckpt, 1, {"a": torch.zeros(3)})
