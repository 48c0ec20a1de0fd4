"""Optimizers and gradient utilities: AdamW, global-norm clipping, the
train step's clip and update in one, the cosine schedule and gradient
compression."""
from .adamw import (AdamW, AdamWState, clip_and_update, clip_by_global_norm,
                    compress_grads, cosine_schedule, decompress_grads,
                    global_norm)

__all__ = ["AdamW", "AdamWState", "clip_and_update", "clip_by_global_norm",
           "compress_grads", "cosine_schedule", "decompress_grads",
           "global_norm"]
