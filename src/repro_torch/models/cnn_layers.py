"""CNN layers of the paper's branchy DNNs, as ``nn.Module``s with MAC
accounting.

Port of ``repro/models/cnn_layers.py``.  Each layer keeps the reference's
shape arithmetic verbatim, on ``(H, W, C)`` shapes:

  out_shape(in_shape)  -> the output shape of one sample
  macs(in_shape)       -> multiply-accumulates a sample

which ``BranchyModel.extract_profile`` turns into the placement problem's
Plane-2 profile, so it must agree with the reference bit for bit.  A layer
holds no parameters until ``init(gen, in_shape, device)`` draws them (He
normal from an explicit ``torch.Generator``) and returns the output shape.

Inside, the layers use PyTorch's idiom: NCHW activations, OIHW
convolution weights, ``[out, in]`` dense weights, ``F.conv2d`` /
``F.max_pool2d`` / ``F.linear`` (the reference's convolutions are XLA ops,
not Pallas kernels, so the library is the port's route here).  Three
places where that idiom differs from the reference's NHWC arithmetic are
taken care of:

* SAME padding is XLA's: ``total = max((oh - 1) * s + k - h, 0)`` with
  ``total // 2`` before and the rest after; an uneven split (at stride 2
  on an even map, 0 before and 1 after, which PyTorch's symmetric
  ``padding=`` cannot express) is padded explicitly with ``F.pad``;
* ``Flatten`` (and a ``Dense`` fed a map) flattens in NHWC order, so the
  features meet the dense weight's rows in the reference's order;
* ``MaxPool`` is VALID: no padding, no ``ceil_mode``.

TF32: cuDNN runs float32 convolutions in TF32 unless told not to; the
reference's float32 convolutions are exact.  The branchy models run their
forward and their training step under ``layers.no_tf32()``, so their
results do not depend on a global flag.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Shape = Tuple[int, ...]


def _he_init(gen: torch.Generator, shape, fan_in: int, device) -> nn.Parameter:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return nn.Parameter(w * math.sqrt(2.0 / fan_in))


def _zeros(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=torch.float32, device=device))


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _nhwc_flat(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W*C] in the reference's NHWC order; a [B, F]
    input passes through."""
    if x.dim() == 4:
        x = x.permute(0, 2, 3, 1)
    return x.reshape(x.shape[0], -1)


class Conv(nn.Module):
    def __init__(self, features: int, kernel: int, stride: int = 1,
                 padding: str = "SAME", use_relu: bool = True):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.features, self.kernel, self.stride = features, kernel, stride
        self.padding, self.use_relu = padding, use_relu
        self.w: Optional[nn.Parameter] = None       # [O, I, kh, kw]
        self.b: Optional[nn.Parameter] = None

    def extra_repr(self) -> str:
        return (f"{self.features}, kernel={self.kernel}, "
                f"stride={self.stride}, {self.padding}, relu={self.use_relu}")

    def out_shape(self, in_shape: Shape) -> Shape:
        h, w, c = in_shape
        if self.padding == "SAME":
            oh = -(-h // self.stride)
            ow = -(-w // self.stride)
        else:
            oh = (h - self.kernel) // self.stride + 1
            ow = (w - self.kernel) // self.stride + 1
        return (oh, ow, self.features)

    def init(self, gen: torch.Generator, in_shape: Shape, device) -> Shape:
        c = in_shape[-1]
        fan_in = self.kernel * self.kernel * c
        self.w = _he_init(gen, (self.features, c, self.kernel, self.kernel),
                          fan_in, device)
        self.b = _zeros(self.features, device)
        return self.out_shape(in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (0, 0)
        if self.padding == "SAME":
            top, bottom = same_pads(x.shape[2], self.kernel, self.stride)
            left, right = same_pads(x.shape[3], self.kernel, self.stride)
            if (top, left) == (bottom, right):
                pad = (top, left)        # symmetric: the convolution pads
            else:
                x = F.pad(x, (left, right, top, bottom))
        y = F.conv2d(x, self.w, self.b, stride=self.stride, padding=pad)
        return F.relu(y) if self.use_relu else y

    def macs(self, in_shape: Shape) -> float:
        oh, ow, _ = self.out_shape(in_shape)
        c = in_shape[-1]
        return float(self.kernel * self.kernel * c * self.features * oh * ow)


class MaxPool(nn.Module):
    def __init__(self, window: int, stride: int):
        super().__init__()
        self.window, self.stride = window, stride

    def out_shape(self, in_shape: Shape) -> Shape:
        h, w, c = in_shape
        oh = (h - self.window) // self.stride + 1
        ow = (w - self.window) // self.stride + 1
        return (oh, ow, c)

    def init(self, gen, in_shape: Shape, device) -> Shape:
        return self.out_shape(in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.window, self.stride)

    def macs(self, in_shape: Shape) -> float:
        return 0.0


class GlobalAvgPool(nn.Module):
    def out_shape(self, in_shape: Shape) -> Shape:
        return (in_shape[-1],)

    def init(self, gen, in_shape: Shape, device) -> Shape:
        return self.out_shape(in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3))

    def macs(self, in_shape: Shape) -> float:
        return 0.0


class Flatten(nn.Module):
    def out_shape(self, in_shape: Shape) -> Shape:
        return (int(np.prod(in_shape)),)

    def init(self, gen, in_shape: Shape, device) -> Shape:
        return self.out_shape(in_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc_flat(x)

    def macs(self, in_shape: Shape) -> float:
        return 0.0


class Dense(nn.Module):
    def __init__(self, features: int, use_relu: bool = False):
        super().__init__()
        self.features, self.use_relu = features, use_relu
        self.w: Optional[nn.Parameter] = None       # [out, in]
        self.b: Optional[nn.Parameter] = None

    def extra_repr(self) -> str:
        return f"{self.features}, relu={self.use_relu}"

    def out_shape(self, in_shape: Shape) -> Shape:
        return (self.features,)

    def init(self, gen: torch.Generator, in_shape: Shape, device) -> Shape:
        fan_in = int(np.prod(in_shape))
        self.w = _he_init(gen, (self.features, fan_in), fan_in, device)
        self.b = _zeros(self.features, device)
        return (self.features,)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_nhwc_flat(x), self.w, self.b)
        return F.relu(y) if self.use_relu else y

    def macs(self, in_shape: Shape) -> float:
        return float(np.prod(in_shape)) * self.features


class Residual(nn.Module):
    """Basic 2-conv residual block (ResNet CIFAR style); a 1x1 projection
    on the skip path where the width or the stride changes."""

    def __init__(self, features: int, stride: int = 1):
        super().__init__()
        self.features, self.stride = features, stride
        self.c1 = Conv(features, 3, stride, "SAME", use_relu=True)
        self.c2 = Conv(features, 3, 1, "SAME", use_relu=False)
        self.proj: Optional[Conv] = None

    def _needs_proj(self, in_shape: Shape) -> bool:
        return in_shape[-1] != self.features or self.stride != 1

    def out_shape(self, in_shape: Shape) -> Shape:
        return self.c2.out_shape(self.c1.out_shape(in_shape))

    def init(self, gen: torch.Generator, in_shape: Shape, device) -> Shape:
        s1 = self.c1.init(gen, in_shape, device)
        s2 = self.c2.init(gen, s1, device)
        if self._needs_proj(in_shape):
            self.proj = Conv(self.features, 1, self.stride, "SAME",
                             use_relu=False)
            self.proj.init(gen, in_shape, device)
        return s2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c2(self.c1(x))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + y)

    def macs(self, in_shape: Shape) -> float:
        m = self.c1.macs(in_shape)
        s1 = self.c1.out_shape(in_shape)
        m += self.c2.macs(s1)
        if self._needs_proj(in_shape):
            m += Conv(self.features, 1, self.stride).macs(in_shape)
        return m


class Sequential(nn.Module):
    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def init(self, gen: torch.Generator, in_shape: Shape, device) -> Shape:
        shape = in_shape
        for lyr in self.layers:
            shape = lyr.init(gen, shape, device)
        return shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lyr in self.layers:
            x = lyr(x)
        return x

    def out_shape(self, in_shape: Shape) -> Shape:
        shape = in_shape
        for lyr in self.layers:
            shape = lyr.out_shape(shape)
        return shape

    def macs(self, in_shape: Shape) -> float:
        total = 0.0
        shape = in_shape
        for lyr in self.layers:
            total += lyr.macs(shape)
            shape = lyr.out_shape(shape)
        return total
