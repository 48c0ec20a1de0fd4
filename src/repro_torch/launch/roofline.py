"""Roofline analysis of a step, from the analytic cost model.

Port of ``repro/launch/roofline.py``.  Three terms per (arch x shape x
mesh), all in seconds per step per card:

  compute    = FLOPs_per_card / peak_FLOP/s
  memory     = bytes_per_card / HBM_bw
  collective = wire_bytes_per_card / link_bw

The port compiles no HLO, so its dry run passes ``analytic`` (the
``launch/analytic.py`` cost) and an empty ``hlo_text``; the hardware
table is ``launch/mesh.HW`` (the H100's).  ``parse_collectives``, the
reference's text parser of post-partitioning HLO, is kept whole: it
applies ring-algorithm wire-byte formulas per collective op (group size n
from replica_groups):

  all-reduce       2 * S * (n-1)/n     (S = local operand bytes)
  all-gather       R * (n-1)/n         (R = gathered result bytes)
  reduce-scatter   S * (n-1)/n
  all-to-all       S * (n-1)/n
  collective-permute  S
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass, field
from typing import Dict

from .flops import active_param_count

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([\d,\s]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    """Total bytes of possibly-tuple HLO shape string before the op name."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))           # [groups, group_size]
    m = _GROUPS_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip()])
    return default


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_op: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)


def parse_collectives(hlo_text: str, default_group: int = 2
                      ) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if "=" not in stripped:
            continue
        lhs, _, rhs = stripped.partition("=")
        rhs = rhs.strip()
        op = None
        for cand in _COLLECTIVES:
            # match "all-gather(", "all-gather-start(" but not -done / -update
            if re.search(rf"\b{cand}(-start)?\(", rhs):
                op = cand
                break
        if op is None:
            continue
        # result shape precedes the op name on the rhs (strip layout braces)
        shape_part = rhs.split(op)[0]
        shape_part = re.sub(r"\{[^}]*\}", "", shape_part)
        result_bytes = _shape_bytes(shape_part)
        n = max(2, _group_size(rhs, default_group))
        if op == "all-reduce":
            wire = 2 * result_bytes * (n - 1) / n
        elif op == "all-gather":
            wire = result_bytes * (n - 1) / n
        elif op == "reduce-scatter":
            # result is the scattered shard; input = result * n
            wire = result_bytes * (n - 1)
        elif op == "all-to-all":
            wire = result_bytes * (n - 1) / n
        else:  # collective-permute
            wire = result_bytes
        stats.wire_bytes += wire
        stats.by_op[op] = stats.by_op.get(op, 0.0) + wire
        stats.counts[op] = stats.counts.get(op, 0) + 1
    return stats


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # analytic per-card costs (launch/analytic.py)
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_total: float
    useful_flops_ratio: float            # MODEL_FLOPS / (analytic_FLOPs*chips)
    memory_per_chip_gb: float
    collective_detail: Dict[str, float]
    collective_counts: Dict[str, int]
    analytic_detail: Dict[str, float] = field(default_factory=dict)
    # a compiler's cost snapshot: 0 in the port, which compiles nothing
    hlo_flops_snapshot: float = 0.0
    hlo_bytes_snapshot: float = 0.0
    hlo_wire_snapshot: float = 0.0
    notes: str = ""

    def to_json(self) -> dict:
        return asdict(self)


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            cost: dict, mem_stats, hlo_text: str, model_flops_total: float,
            hw: dict, analytic=None) -> Roofline:
    hlo_flops = float(cost.get("flops", 0.0))
    hlo_bytes = float(cost.get("bytes accessed", 0.0))
    coll = parse_collectives(hlo_text)
    if analytic is not None:
        flops, byts, wire = (analytic.flops, analytic.hbm_bytes,
                             analytic.wire_bytes)
        adetail = dict(analytic.detail)
    else:
        flops, byts, wire = hlo_flops, hlo_bytes, coll.wire_bytes
        adetail = {}
    t_c = flops / hw["peak_flops_bf16"]
    t_m = byts / hw["hbm_bw"]
    t_x = wire / hw["ici_bw_per_link"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * chips
    ratio = model_flops_total / total_flops if total_flops else 0.0
    mem_gb = 0.0
    if mem_stats is not None:
        mem_gb = (mem_stats.argument_size_in_bytes
                  + mem_stats.output_size_in_bytes
                  + mem_stats.temp_size_in_bytes
                  - mem_stats.alias_size_in_bytes) / 1e9
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, bytes_per_chip=byts,
        wire_bytes_per_chip=wire,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck,
        model_flops_total=model_flops_total,
        useful_flops_ratio=ratio,
        memory_per_chip_gb=mem_gb,
        collective_detail=coll.by_op,
        collective_counts=coll.counts,
        analytic_detail=adetail,
        hlo_flops_snapshot=hlo_flops,
        hlo_bytes_snapshot=hlo_bytes,
        hlo_wire_snapshot=coll.wire_bytes,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the 6*N*D / 2*N*B reference)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """6*N_active*D for training, 2*N_active*tokens for inference steps."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
