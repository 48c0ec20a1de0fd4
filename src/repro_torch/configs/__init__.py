"""Architecture configs of the port (a copy of the reference's, as data)."""
from .base import ArchConfig, LayerSpec
from .registry import ARCH_NAMES, get

__all__ = ["ArchConfig", "LayerSpec", "ARCH_NAMES", "get"]
