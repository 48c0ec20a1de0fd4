"""Architecture configs of the port (a copy of the reference's, as data),
and the dry run's input shapes and cells."""
from .base import SHAPES, ArchConfig, LayerSpec, ShapeSpec
from .registry import (ARCH_NAMES, all_cells, get, runnable_cells,
                       skipped_cells, sub_quadratic)

__all__ = ["SHAPES", "ArchConfig", "LayerSpec", "ShapeSpec", "ARCH_NAMES",
           "all_cells", "get", "runnable_cells", "skipped_cells",
           "sub_quadratic"]
