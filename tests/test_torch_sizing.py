"""The port's sizing against the reference's, exactly (no tolerance).

* ``configs``: ``SHAPES``, ``OPTIMIZED_OVERRIDES``, ``get(optimized=)``,
  ``sub_quadratic`` and the cell lists (``runnable_cells``, ``all_cells``,
  ``skipped_cells``).
* ``launch/flops``: ``param_count`` and ``active_param_count`` for the ten
  architectures, baseline and optimized.
* ``launch/analytic``: ``fwd_flops_per_token`` (split and whole) for every
  runnable cell, and ``analytic_cost`` on the meshes (16, 16), (2, 16, 16)
  and (2, 4); ``launch/roofline.model_flops`` for every cell.
* ``models.layers.mlp_flops``, ``models.attention.attn_flops_per_token``
  with and without a sliding window, ``core.scenarios.TABLE_VI_CONFIGS``.
* ``launch/roofline.parse_collectives`` on the same HLO text: iota and
  explicit ``replica_groups``, ``-start`` / ``-done`` ops, tuple shapes,
  layouts and every collective.

Everything is host Python: plain floats in the reference's order of
operations, so the numbers are ``==``.
"""
import dataclasses
import math

import pytest

import repro.configs as RC
from repro.configs.registry import OPTIMIZED_OVERRIDES as REF_OVERRIDES
from repro.core.scenarios import TABLE_VI_CONFIGS as REF_TABLE_VI
from repro.launch import analytic as RA
from repro.launch import flops as RF
from repro.launch import roofline as RR
from repro.models.attention import attn_flops_per_token as ref_attn_flops
from repro.models.layers import mlp_flops as ref_mlp_flops

import repro_torch.configs as PC
from repro_torch.configs.registry import OPTIMIZED_OVERRIDES
from repro_torch.core.scenarios import TABLE_VI_CONFIGS
from repro_torch.launch import analytic as PA
from repro_torch.launch import flops as PF
from repro_torch.launch import roofline as PR
from repro_torch.models.attention import attn_flops_per_token
from repro_torch.models.layers import mlp_flops

ARCHS = list(RC.ARCH_NAMES)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}
CELLS = [(a, s) for a, s in RC.all_cells()]


def _cfgs(arch, optimized):
    return (RC.get(arch, optimized=optimized),
            PC.get(arch, optimized=optimized))


# ---------------------------------------------------------------------------
# configs and cells
# ---------------------------------------------------------------------------

def test_shapes_and_overrides_equal_the_reference():
    assert list(PC.SHAPES) == list(RC.SHAPES)
    for k in RC.SHAPES:
        assert dataclasses.asdict(PC.SHAPES[k]) == \
            dataclasses.asdict(RC.SHAPES[k])
    assert OPTIMIZED_OVERRIDES == REF_OVERRIDES


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_get_optimized_equals_the_reference(arch, optimized, reduced):
    want = RC.get(arch, optimized=optimized, reduced=reduced)
    got = PC.get(arch, optimized=optimized, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_runnable_cells_and_sub_quadratic_equal_the_reference(arch):
    assert PC.runnable_cells(arch) == RC.runnable_cells(arch)
    for opt in (False, True):
        ref, port = _cfgs(arch, opt)
        assert PC.sub_quadratic(port) == RC.sub_quadratic(ref)


def test_cell_lists_equal_the_reference():
    assert PC.all_cells() == RC.all_cells()
    assert PC.skipped_cells() == RC.skipped_cells()
    assert len(PC.all_cells()) + len(PC.skipped_cells()) == \
        len(PC.ARCH_NAMES) * len(PC.SHAPES)


def test_get_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown architecture"):
        PC.get("no-such-arch", optimized=True)


# ---------------------------------------------------------------------------
# parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_the_reference(arch, optimized):
    ref, port = _cfgs(arch, optimized)
    assert PF.param_count(port) == RF.param_count(ref)
    assert PF.active_param_count(port) == RF.active_param_count(ref)
    assert PF.param_count(port, active=True) == \
        RF.param_count(ref, active=True)
    assert isinstance(PF.param_count(port), int)


def test_param_count_is_the_formula_not_the_tree():
    """The formula leaves out the q/k norms and the SSM conv bias, as the
    reference's does: the built tree of qwen3-4b is larger by 2 head_dim
    a layer, mamba2-1.3b's by d_inner + 2N a layer."""
    from repro_torch.models import transformer as TT
    from repro_torch.runtime.steps import params_shapes
    for arch, extra in (("qwen3-4b", lambda c: 2 * c.head_dim_),
                        ("mamba2-1.3b",
                         lambda c: c.ssm_expand * c.d_model
                         + 2 * c.ssm_state),
                        ("phi3-medium-14b", lambda c: 0)):
        cfg = PC.get(arch)
        tree = TT.param_count(params_shapes(cfg))
        assert tree - PF.param_count(cfg) == cfg.n_layers * extra(cfg)


# ---------------------------------------------------------------------------
# FLOPs and the analytic cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_fwd_flops_per_token_equals_the_reference(arch, shape, optimized):
    ref, port = _cfgs(arch, optimized)
    s_ref, s_port = RC.SHAPES[shape], PC.SHAPES[shape]
    assert PA.fwd_flops_per_token(port, s_port) == \
        RA.fwd_flops_per_token(ref, s_ref)
    assert PA.fwd_flops_per_token(port, s_port, split=True) == \
        RA.fwd_flops_per_token(ref, s_ref, split=True)
    assert PR.model_flops(port, s_port) == RR.model_flops(ref, s_ref)
    assert PA._cache_bytes_total(port, s_port) == \
        RA._cache_bytes_total(ref, s_ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_cost_equals_the_reference(arch, shape, optimized, mesh):
    ref, port = _cfgs(arch, optimized)
    axes = MESHES[mesh]
    chips = math.prod(axes.values())
    want = RA.analytic_cost(ref, RC.SHAPES[shape], chips, dict(axes))
    got = PA.analytic_cost(port, PC.SHAPES[shape], chips, dict(axes))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.flops > 0 and got.hbm_bytes > 0


def test_remat_factors_equal_the_reference():
    assert PA._REMAT_FACTOR == RA._REMAT_FACTOR


@pytest.mark.parametrize("d,ff", [(64, 128), (2560, 9728), (7168, 4864),
                                  (8192, 24576)])
def test_mlp_flops_equals_the_reference(d, ff):
    assert mlp_flops(d, ff) == ref_mlp_flops(d, ff)


@pytest.mark.parametrize("window", [None, 0, 4096])
@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if RC.get(a).n_heads > 0])
def test_attn_flops_per_token_equals_the_reference(arch, window):
    """With the config's own window (``None``), none, and a 4,096 window,
    at contexts below, at and past it."""
    ref, port = _cfgs(arch, False)
    if window is not None:
        ref = dataclasses.replace(ref, sliding_window=window)
        port = dataclasses.replace(port, sliding_window=window)
    for kv in (1, 4095, 4096, 4097, 32_768, 524_288):
        assert attn_flops_per_token(port, kv) == ref_attn_flops(ref, kv)


def test_table_vi_configs_equal_the_reference():
    assert TABLE_VI_CONFIGS == REF_TABLE_VI


# ---------------------------------------------------------------------------
# the collective parser
# ---------------------------------------------------------------------------

HLO_LINES = [
    # explicit groups, layout braces, an all-reduce
    "%all-reduce.1 = f32[16,4096]{1,0} all-reduce(f32[16,4096]{1,0} %p), "
    "channel_id=1, replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add",
    # iota groups [groups, size]
    "%all-gather.2 = bf16[256,1024]{1,0} all-gather(bf16[16,1024]{1,0} %x), "
    "channel_id=2, replica_groups=[16,16]<=[256], dimensions={0}",
    # an async pair: the -start counts, the -done does not
    "%ag-start = (bf16[16,1024]{1,0}, bf16[256,1024]{1,0}) "
    "all-gather-start(bf16[16,1024]{1,0} %x), replica_groups=[2,8]<=[16], "
    "dimensions={0}",
    "%ag-done = bf16[256,1024]{1,0} all-gather-done((bf16[16,1024]{1,0}, "
    "bf16[256,1024]{1,0}) %ag-start)",
    "%reduce-scatter.3 = f32[4,128]{1,0} reduce-scatter(f32[64,128]{1,0} "
    "%y), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, "
    "dimensions={0}, to_apply=%add",
    # a tuple result
    "%all-to-all.4 = (s8[8,32]{1,0}, s8[8,32]{1,0}) all-to-all(s8[8,32]{1,0}"
    " %a, s8[8,32]{1,0} %b), replica_groups={{0,1}}",
    "%collective-permute.5 = u32[1024]{0} collective-permute(u32[1024]{0} "
    "%z), source_target_pairs={{0,1},{1,0}}",
    # empty groups: the default group size
    "%ars = f32[8]{0} all-reduce-start(f32[8]{0} %w), replica_groups={}, "
    "to_apply=%add",
    "%ard = f32[8]{0} all-reduce-done(f32[8]{0} %ars)",
    "%cps = (f16[2,3]{1,0}, f16[2,3]{1,0}, u32[], u32[]) "
    "collective-permute-start(f16[2,3]{1,0} %q), "
    "source_target_pairs={{0,1}}",
    # scalars, unknown element types and non-collective ops
    "%ar.6 = (f64[], c64[4], pred[3], token[]) all-reduce(f64[] %s), "
    "replica_groups=[1,4]<=[4], to_apply=%add",
    "%add.7 = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)",
    "ROOT %tuple = (f32[8]{0}) tuple(f32[8]{0} %add.7)",
    "HloModule jit_step, entry_computation_layout={(f32[8]{0})->f32[8]{0}}",
    "",
]


def _stats(mod, text, **kw):
    return dataclasses.asdict(mod.parse_collectives(text, **kw))


@pytest.mark.parametrize("i", range(len(HLO_LINES)))
def test_parse_collectives_line_equals_the_reference(i):
    line = HLO_LINES[i]
    for kw in ({}, {"default_group": 8}):
        assert _stats(PR, line, **kw) == _stats(RR, line, **kw)


def test_parse_collectives_module_equals_the_reference():
    text = "\n".join(HLO_LINES)
    got = _stats(PR, text)
    assert got == _stats(RR, text)
    assert set(got["counts"]) == {"all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"}
    assert got["counts"]["all-gather"] == 2
    assert got["wire_bytes"] > 0
