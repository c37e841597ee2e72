"""ResNet-50 backbone with frozen batch norm (NCHW) — the counterpart of
:mod:`irn_tpu.models.resnet`, with the reference's torch module names
(``conv1``, ``bn1``, ``layer{1..4}.{i}.conv{1..3}/bn{1..3}/downsample.{0,1}``).

- Bottleneck [3, 4, 6, 3]; per-layer strides and dilations; the first block
  of every layer ignores the layer dilation (reference resnet50.py:86).
- Batch norm always normalizes with the stored running statistics, eps
  1e-5, in the JAX package's arithmetic (x * inv + shift).
- Optional extent masking: activations beyond a true (h, w) extent are
  zeroed before every spatial op, so a padded buffer reproduces an
  exact-size run inside the extent (make_cam needs it; IRNet does not).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

Extent = Optional[Tuple[int, int]]


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with immutable running statistics (buffers) and affine
    ``weight``/``bias`` parameters."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rs = torch.rsqrt(self.running_var + self.eps)
        inv = self.weight * rs
        shift = self.bias - self.running_mean * self.weight * rs
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def _extent_mask(x: torch.Tensor, extent: Extent) -> torch.Tensor:
    """Zero NCHW activations at/beyond a true (eh, ew) spatial extent."""
    if extent is None:
        return x
    eh, ew = extent
    rows = torch.arange(x.shape[2], device=x.device)[:, None] < eh
    cols = torch.arange(x.shape[3], device=x.device)[None, :] < ew
    return x * (rows & cols).to(x.dtype)[None, None]


def _halve_extent(extent: Extent) -> Extent:
    """Extent after a stride-2 k3/p1, k7/p3 conv or maxpool: ceil(e / 2)."""
    if extent is None:
        return None
    eh, ew = extent
    return (eh - 1) // 2 + 1, (ew - 1) // 2 + 1


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
          padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride, dilation) -> 1x1(x4) with identity/projection skip."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, project: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride,
                           dilation=dilation, padding=dilation)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(cin, planes * 4, 1, stride=stride),
                          FrozenBatchNorm2d(planes * 4))
            if project else None
        )

    def forward(self, x: torch.Tensor, extent: Extent = None) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = _extent_mask(out, extent)  # before the spatial conv
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet50(nn.Module):
    """Stage-feature extractor: returns the ``stem`` (64 ch, stride 4) and
    ``c2``..``c5`` (256/512/1024/2048 ch) NCHW features."""

    def __init__(self, strides: Sequence[int] = (2, 2, 2, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 blocks: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.strides = tuple(strides)
        self.conv1 = _conv(3, 64, 7, stride=strides[0], padding=3)
        self.bn1 = FrozenBatchNorm2d(64)
        planes = (64, 128, 256, 512)
        layer_strides = (1, strides[1], strides[2], strides[3])
        cin = 64
        for li in range(4):
            layer = []
            for bi in range(blocks[li]):
                first = bi == 0
                layer.append(Bottleneck(
                    cin, planes[li],
                    stride=layer_strides[li] if first else 1,
                    # reference quirk: the first block ignores the dilation
                    dilation=1 if first else dilations[li],
                    project=first,
                ))
                cin = planes[li] * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x: torch.Tensor, extent: Extent = None):
        feats = {}
        x = F.relu(self.bn1(self.conv1(x)))
        if self.strides[0] == 2:
            extent = _halve_extent(extent)
        x = _extent_mask(x, extent)  # before the spatial maxpool
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        extent = _halve_extent(extent)
        feats["stem"] = x
        for li, name in enumerate(("c2", "c3", "c4", "c5")):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x, extent)
                if block.stride == 2:
                    extent = _halve_extent(extent)
            feats[name] = x
        return feats
