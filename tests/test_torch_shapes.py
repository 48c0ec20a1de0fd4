"""The port's shapes without allocation against the reference's
``jax.eval_shape`` trees.

For every runnable (arch x shape) cell, the 480B-parameter arctic and the
398B-parameter jamba included, ``runtime.steps.input_specs`` (the train
state of ``train_state_shapes``, ``params_shapes``,
``models.transformer.cache_shape_dtypes`` and ``batch_specs``) equals the
reference's ``ShapeDtypeStruct`` tree in path, shape and dtype, and every
leaf of the port's lies on the ``meta`` device.  ``step_for`` hands back
the port's ``build_*_step`` functions with the reference's argument
names, and its prefill entry is the last position of ``forward_train``'s
final logits.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import transformer as RT
from repro.runtime import steps as RS
from repro.sharding.specs import _path_str

import repro_torch.configs as PC
from repro_torch.models import transformer as TT
from repro_torch.runtime import steps as PS

CELLS = RC.all_cells()


def port_flat(tree, prefix=()):
    """{path: (shape, dtype name, device type)} of a tree of dicts and
    NamedTuples of tensors, paths as the reference's ``_path_str``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(port_flat(getattr(tree, k), prefix + (k,)))
        return out
    return {"/".join(prefix): (tuple(tree.shape),
                               str(tree.dtype).replace("torch.", ""),
                               tree.device.type)}


def ref_flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): (tuple(x.shape), str(x.dtype)) for p, x in leaves}


def _same(port_tree, ref_tree):
    got, want = port_flat(port_tree), ref_flat(ref_tree)
    assert sorted(got) == sorted(want)
    for path, (shape, dtype, device) in got.items():
        assert (shape, dtype) == want[path], path
        assert device == "meta", path
    return got


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    cfg, ref_cfg = PC.get(arch), RC.get(arch)
    got = PS.input_specs(cfg, PC.SHAPES[shape])
    want = RS.input_specs(ref_cfg, RC.SHAPES[shape])
    assert list(got) == list(want)
    flat = _same(got, want)
    if shape == "train_4k":
        # params, both moments and the step
        assert sum(p.startswith("state/params/") for p in flat) * 3 + 1 + \
            len(got["batch"]) == len(flat)


@pytest.mark.parametrize("arch", ["arctic-480b", "jamba-1.5-large-398b",
                                  "granite-34b"])
def test_optimized_trees_equal_the_reference(arch):
    """``optimized`` changes the moments' dtype (``master_weights``) and
    the KV cache's (``kv_cache_dtype="int8"``, granite)."""
    cfg = PC.get(arch, optimized=True)
    ref_cfg = RC.get(arch, optimized=True)
    _same(PS.train_state_shapes(cfg), RS.train_state_shapes(ref_cfg))
    _same(TT.cache_shape_dtypes(cfg, 4, 300),
          RT.cache_shape_dtypes(ref_cfg, 4, 300))


@pytest.mark.parametrize("arch", list(PC.ARCH_NAMES))
def test_reduced_shapes_equal_the_built_trees(arch):
    """On a reduced config the meta trees equal the trees ``init_model``,
    ``init_train_state`` and ``init_caches`` build on the CPU."""
    cfg = PC.get(arch, reduced=True)

    def real(tree):
        return {k: v[:2] for k, v in port_flat(tree).items()}

    def meta(tree):
        flat = port_flat(tree)
        assert all(d == "meta" for _, _, d in flat.values())
        return {k: v[:2] for k, v in flat.items()}

    assert meta(PS.params_shapes(cfg)) == real(TT.init_model(cfg,
                                                             device="cpu"))
    assert meta(PS.train_state_shapes(cfg)) == real(
        PS.init_train_state(cfg, device="cpu"))
    if cfg.has_decoder:
        assert meta(TT.cache_shape_dtypes(cfg, 3, 40)) == real(
            TT.init_caches(cfg, 3, 40, device="cpu"))


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b",
                                  "qwen3-4b"])
def test_batch_specs_equal_the_reference(arch):
    got = PS.batch_specs(PC.get(arch), 5, 33)
    want = RS.batch_specs(RC.get(arch), 5, 33)
    assert list(got) == list(want)
    _same(got, want)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "hubert-xlarge",
                                  "mamba2-1.3b"])
def test_step_for_names_the_reference_arguments(arch, kind):
    cfg, ref_cfg = PC.get(arch, reduced=True), RC.get(arch, reduced=True)
    shape = PC.ShapeSpec("s", 16, 2, kind)
    if kind == "decode" and not cfg.has_decoder:
        with pytest.raises(ValueError, match="encoder-only"):
            PS.input_specs(cfg, shape)
        return
    step, names = PS.step_for(cfg, shape)
    _, ref_names = RS.step_for(ref_cfg, RC.ShapeSpec("s", 16, 2, kind))
    assert names == ref_names
    assert set(names) == set(PS.input_specs(cfg, shape))
    assert callable(step)


def test_prefill_entry_is_the_last_final_logits():
    cfg = PC.get("qwen3-4b", reduced=True)
    params = TT.init_model(cfg, seed=3, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)), dtype=torch.int32)
    step, names = PS.step_for(cfg, PC.ShapeSpec("s", 12, 2, "prefill"))
    got = step(params, {"tokens": toks})
    want = TT.forward_train(params, cfg, {"tokens": toks})["final"][:, -1]
    assert got.shape == (2, cfg.padded_vocab)
    assert torch.equal(got, want)


def test_meta_shapes_allocate_nothing():
    """arctic-480b's train state (bf16 parameters and moments, about
    2.9 TB) on meta."""
    state = PS.train_state_shapes(PC.get("arctic-480b"))
    flat = port_flat(state)
    nbytes = sum(int(np.prod(s)) * torch.empty((), dtype=getattr(
        torch, d)).element_size() for s, d, _ in flat.values())
    assert 2.9e12 < nbytes < 2.91e12
    assert {d for _, _, d in flat.values()} == {"meta"}
