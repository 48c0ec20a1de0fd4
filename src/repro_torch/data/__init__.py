"""Synthetic data: the LM token stream and class-conditional images."""
from .synthetic import LMStreamConfig, SyntheticLMStream, synthetic_images

__all__ = ["LMStreamConfig", "SyntheticLMStream", "synthetic_images"]
