"""Optimizers and gradient utilities: AdamW, global-norm clipping, the
cosine schedule and gradient compression."""
from .adamw import (AdamW, AdamWState, clip_by_global_norm, compress_grads,
                    cosine_schedule, decompress_grads, global_norm)

__all__ = ["AdamW", "AdamWState", "clip_by_global_norm", "compress_grads",
           "cosine_schedule", "decompress_grads", "global_norm"]
