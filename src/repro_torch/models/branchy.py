"""The paper's branchy DNNs: B-LeNet, B-AlexNet, B-ResNet (Sec. IV).

Port of ``repro/models/branchy.py``.  A :class:`BranchyModel` is a chain
of backbone blocks, some of which carry an early-exit head:

  net = b_lenet().init(seed=0, device=None)       # draws the parameters
  logits_per_exit, feats = net.apply(x)           # all exits
  pred, exit_idx = net.infer(x, thresholds)       # gated inference
  loss = net.loss(x, labels)                      # BranchyNet joint loss
  profile = net.extract_profile()                 # -> core.DNNProfile

Inputs are ``[B, H, W, C]`` as the reference takes them, so a caller's
arrays go to either package unchanged; inside, activations are NCHW (see
``cnn_layers``).  ``apply`` is the reference's forward and shadows
``nn.Module.apply(fn)`` (call ``nn.Module.apply(net, fn)`` for that).
The forward and ``value_and_grad`` run with TF32 off (``no_tf32``), so a
float32 model computes in float32 whatever the caller's global flags say.

``infer`` gates each exit with the exit-gate kernel B6 (``ee_gate``: the
max softmax probability as ``exp(m - lse)`` and the first-occurrence
argmax), one launch an exit on a CUDA tensor, and its plain version on a
CPU tensor.  Its confidence may differ from the reference's
``softmax().max()`` in the last ulp, so a sample whose confidence lies
within an ulp of its threshold may take the other side.

Block boundaries and feature-map sizes follow Table III (each block's
output feature count is the paper's "number of features" column); exit
placement follows Table VI.  ``extract_profile`` turns the model into the
Plane-2 ``DNNProfile`` with true MAC counts and cut sizes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..core.dnn_profile import DNNProfile, ExitSpec
from ..kernels.ee_gate.ops import ee_gate
from .cnn_layers import (Conv, Dense, Flatten, GlobalAvgPool, MaxPool,
                         Residual, Sequential, Shape)
from .layers import no_tf32


class BranchyModel(nn.Module):
    def __init__(self, name: str, input_shape: Shape,
                 blocks: Sequence[Sequential], exits: Dict[int, Sequential],
                 n_classes: int):
        super().__init__()
        self.name = name
        self.input_shape = tuple(input_shape)          # (H, W, C)
        self.blocks = nn.ModuleList(blocks)
        self.exits = nn.ModuleDict({str(b): h for b, h in exits.items()})
        self.n_classes = n_classes

    # -- parameters -----------------------------------------------------------
    def init(self, *, seed: int = 0, device: DeviceLike = None
             ) -> "BranchyModel":
        """Draw every parameter (He normal, zero biases) from a seeded
        ``torch.Generator`` on ``device`` (default ``cuda:0``), block by
        block, each exit head after its block; returns the model."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        shape = self.input_shape
        for i, blk in enumerate(self.blocks):
            shape = blk.init(gen, shape, dev)
            if str(i) in self.exits:
                self.exits[str(i)].init(gen, shape, dev)
        return self

    # -- forward --------------------------------------------------------------
    def apply(self, x: torch.Tensor, *, up_to_block: Optional[int] = None
              ) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
        """Run blocks 0..up_to_block on ``x`` [B, H, W, C]; returns
        ({block_idx: exit logits [B, n_classes]}, the last block's output,
        NHWC as the reference returns it)."""
        last = len(self.blocks) - 1 if up_to_block is None else up_to_block
        logits: Dict[int, torch.Tensor] = {}
        with no_tf32():
            h = x.permute(0, 3, 1, 2)
            for i in range(last + 1):
                h = self.blocks[i](h)
                if str(i) in self.exits:
                    logits[i] = self.exits[str(i)](h)
        return logits, (h.permute(0, 2, 3, 1) if h.dim() == 4 else h)

    forward = apply

    def exit_blocks(self) -> List[int]:
        return sorted(int(b) for b in self.exits)

    # -- gated inference (per-sample dynamic depth) -----------------------------
    @torch.no_grad()
    def infer(self, x: torch.Tensor, thresholds: Sequence[float]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Confidence-gated early-exit inference.

        A sample exits at the first exit whose max-softmax confidence clears
        its threshold (``conf >= threshold``; the last exit takes the rest).
        Returns (predictions [B] int32, exit index [B] int32).  All exits
        are computed; each is gated by B6 on CUDA, its plain version on
        the CPU.
        """
        logits, _ = self.apply(x)
        eb = self.exit_blocks()
        if len(thresholds) < len(eb) - 1:
            raise ValueError(f"{len(eb)} exits need {len(eb) - 1} "
                             f"thresholds, got {len(thresholds)}")
        B = x.shape[0]
        pred = torch.zeros(B, dtype=torch.int32, device=x.device)
        exit_idx = torch.full((B,), len(eb) - 1, dtype=torch.int32,
                              device=x.device)
        decided = torch.zeros(B, dtype=torch.bool, device=x.device)
        for j, b in enumerate(eb):
            conf, arg = ee_gate(logits[b].contiguous())
            if j == len(eb) - 1:
                take = ~decided
            else:
                take = ~decided & (conf >= thresholds[j])
            pred = torch.where(take, arg, pred)
            exit_idx = torch.where(take, j, exit_idx)
            decided = decided | take
        return pred, exit_idx

    def loss(self, x: torch.Tensor, labels: torch.Tensor,
             exit_weights: Optional[Sequence[float]] = None) -> torch.Tensor:
        """BranchyNet joint loss: weighted mean of per-exit cross-entropies."""
        logits, _ = self.apply(x)
        eb = self.exit_blocks()
        w = ([1.0] * len(eb)) if exit_weights is None else list(exit_weights)
        idx = labels.long()[:, None]
        total = 0.0
        for j, b in enumerate(eb):
            logp = F.log_softmax(logits[b], dim=-1)
            ce = -torch.gather(logp, -1, idx).mean()
            total = total + w[j] * ce
        return total / sum(w)

    def value_and_grad(self, x: torch.Tensor, labels: torch.Tensor,
                       exit_weights: Optional[Sequence[float]] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(joint loss, {parameter name: gradient}), forward and backward
        with TF32 off."""
        names, params = zip(*self.named_parameters())
        with no_tf32():
            loss = self.loss(x, labels, exit_weights)
            grads = torch.autograd.grad(loss, params)
        return loss.detach(), dict(zip(names, grads))

    # -- profile extraction -----------------------------------------------------
    def extract_profile(self, *, bits_per_feature: int = 8,
                        accuracies: Optional[Sequence[float]] = None,
                        phis: Optional[Sequence[float]] = None) -> DNNProfile:
        """Measured Plane-2 profile: true MACs and true cut sizes."""
        shape = self.input_shape
        block_ops, cut_bits, shapes = [], [], []
        for blk in self.blocks:
            block_ops.append(blk.macs(shape))
            shape = blk.out_shape(shape)
            shapes.append(shape)
            cut_bits.append(float(np.prod(shape)) * bits_per_feature)
        eb = self.exit_blocks()
        n_e = len(eb)
        acc = list(accuracies) if accuracies is not None else \
            list(np.linspace(0.5, 0.9, n_e))
        phi = list(phis) if phis is not None else [1.0 / n_e] * n_e
        exits = []
        for j, b in enumerate(eb):
            head = self.exits[str(b)]
            exits.append(ExitSpec(
                block=b, ops=head.macs(shapes[b]),
                out_bits=self.n_classes * bits_per_feature,
                accuracy=float(acc[j]), phi=float(phi[j])))
        return DNNProfile(name=f"{self.name}:measured",
                          input_bits=float(np.prod(self.input_shape))
                          * bits_per_feature,
                          block_ops=block_ops, cut_bits=cut_bits, exits=exits)


# ---------------------------------------------------------------------------
# Model definitions (Table III feature-count-faithful)
# ---------------------------------------------------------------------------

def b_lenet(n_classes: int = 10) -> BranchyModel:
    """B-LeNet: 2 conv + 2 pool + 3 FC backbone, 1 early exit (2 exits total).

    Block outputs: 28x28x6 = 4704, 10x10x16 = 1600, 120 (Table III)."""
    blocks = (
        Sequential((Conv(6, 5, 1, "SAME"),)),                     # -> 4704
        Sequential((MaxPool(2, 2), Conv(16, 5, 1, "VALID"))),      # -> 1600
        Sequential((MaxPool(2, 2), Flatten(), Dense(120, use_relu=True))),
    )
    exits = {
        0: Sequential((MaxPool(4, 4), Flatten(), Dense(n_classes))),
        2: Sequential((Dense(84, use_relu=True), Dense(n_classes))),
    }
    return BranchyModel("b-lenet", (28, 28, 1), blocks, exits, n_classes)


def b_alexnet(n_classes: int = 10) -> BranchyModel:
    """B-AlexNet: 5 conv blocks, exits at blocks 1, 3, 5 (Table VI).

    Block outputs: 55x55x96 = 290400, 27x27x256 = 186624, 13x13x384 = 64896,
    13x13x384 = 64896, 13x13x256 = 43264 (Table III)."""
    blocks = (
        Sequential((Conv(96, 11, 4, "VALID"),)),                   # 55x55x96
        Sequential((MaxPool(3, 2), Conv(256, 5, 1, "SAME"))),       # 27x27x256
        Sequential((MaxPool(3, 2), Conv(384, 3, 1, "SAME"))),       # 13x13x384
        Sequential((Conv(384, 3, 1, "SAME"),)),                     # 13x13x384
        Sequential((Conv(256, 3, 1, "SAME"),)),                     # 13x13x256
    )
    exits = {
        0: Sequential((MaxPool(3, 2), Conv(96, 3, 1, "SAME"),
                       GlobalAvgPool(), Dense(n_classes))),
        2: Sequential((Conv(256, 3, 1, "SAME"), GlobalAvgPool(),
                       Dense(n_classes))),
        4: Sequential((GlobalAvgPool(), Dense(n_classes))),
    }
    return BranchyModel("b-alexnet", (227, 227, 3), blocks, exits, n_classes)


def b_resnet(n_classes: int = 10, *, blocks_per_stage: int = 2
             ) -> BranchyModel:
    """B-ResNet: CIFAR ResNet backbone in 5 blocks, exits at 1, 3, 5.

    Block outputs: 32x32x16 = 16384 (x3), 8x8x64 = 4096 (x2), per Table III.
    ``blocks_per_stage=18`` gives the full ResNet-110; the default keeps CPU
    tests fast (depth is a config knob, not an architecture change)."""
    n = blocks_per_stage

    def res(features, count, stride=1):
        return [Residual(features, stride if i == 0 else 1)
                for i in range(count)]

    blocks = (
        Sequential([Conv(16, 3, 1, "SAME")] + res(16, n)),   # 32x32x16
        Sequential(res(16, n)),                              # 16384
        Sequential(res(16, n)),                              # 16384
        Sequential(res(32, n, 2) + res(64, n, 2)),           # 8x8x64 = 4096
        Sequential(res(64, n)),                              # 4096
    )
    exits = {b: Sequential((GlobalAvgPool(), Dense(n_classes)))
             for b in (0, 2, 4)}
    return BranchyModel("b-resnet", (32, 32, 3), blocks, exits, n_classes)


PAPER_MODELS = {"b-lenet": b_lenet, "b-alexnet": b_alexnet, "b-resnet": b_resnet}
#: Table III block output feature counts, for validation.
TABLE_III_FEATURES = {
    "b-lenet": [4704, 1600, 120],
    "b-alexnet": [290400, 186624, 64896, 64896, 43264],
    "b-resnet": [16384, 16384, 16384, 4096, 4096],
}
