"""Production mesh descriptions, a real ``DeviceMesh`` over them, and the
H100 constants of the roofline.

Port of ``repro/launch/mesh.py``.  The reference builds a jax ``Mesh`` of
256 or 512 devices; the port's ``make_production_mesh`` /
``make_test_mesh`` return a ``MeshDesc``, the axis names and sizes that
the spec code (``sharding/specs.py``), the sharding context and the
analytic cost model read.  Shapes: (16, 16) = 256 cards with ("data",
"model") axes; (2, 16, 16) = 512 cards with a leading pure-DP "pod" axis.
Building a description touches no device.

``device_mesh(desc, device_type)`` builds a
``torch.distributed.device_mesh.DeviceMesh`` of that shape and those axis
names over the initialised default process group, whose world size must
be the mesh's; it raises otherwise and falls back to nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MeshDesc:
    """A device mesh as data: axis names, major to minor, and sizes."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshDesc(axes, shape)


def make_test_mesh(shape: Tuple[int, ...] = (2, 4),
                   axes: Tuple[str, ...] = ("data", "model")) -> MeshDesc:
    """A small mesh for the sharding tests (8 cards by default)."""
    return MeshDesc(tuple(axes), tuple(shape))


def device_mesh(desc: MeshDesc, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``desc``'s shape and axis names over the
    initialised default process group, one rank a mesh position."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"device_mesh({desc}) needs an initialised "
                           f"process group (torch.distributed."
                           f"init_process_group)")
    world = dist.get_world_size()
    if world != desc.size:
        raise RuntimeError(f"mesh {desc.shape} needs {desc.size} ranks, the "
                           f"process group has {world}")
    return init_device_mesh(device_type, desc.shape,
                            mesh_dim_names=desc.axis_names)


#: NVIDIA H100 SXM5 constants for the roofline model (per card), from
#: NVIDIA's H100 Tensor Core GPU data sheet: dense BF16 Tensor Core peak
#: 989 TFLOP/s (1,979 with sparsity), HBM3 3.35 TB/s, and NVLink 4 at
#: 900 GB/s a card over 18 links, i.e. 50 GB/s a link both ways, 25 GB/s
#: each way.  ``ici_bw_per_link`` keeps the reference's key so that
#: ``roofline.analyze`` reads either table.  No multi-card figure has been
#: measured on the port: the collective term is the data sheet's.
HW = dict(
    peak_flops_bf16=989e12,      # FLOP/s
    hbm_bw=3.35e12,              # B/s
    ici_bw_per_link=25e9,        # B/s, one NVLink 4 link, one direction
)
