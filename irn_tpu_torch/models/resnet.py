"""ResNet-50 backbone with frozen batch norm (NCHW) — the counterpart of
:mod:`irn_tpu.models.resnet`, with the reference's torch module names
(``conv1``, ``bn1``, ``layer{1..4}.{i}.conv{1..3}/bn{1..3}/downsample.{0,1}``).

- Bottleneck [3, 4, 6, 3]; per-layer strides and dilations; the first block
  of every layer ignores the layer dilation (reference resnet50.py:86).
- Batch norm always normalizes with the stored running statistics, eps
  1e-5, in the JAX package's arithmetic (x * inv + shift). Its calibrate
  mode (train_cam without a pretrained backbone) first writes the batch
  mean and population variance into those statistics.
- Optional extent masking: activations beyond a true (h, w) extent are
  zeroed before every spatial op, so a padded buffer reproduces an
  exact-size run inside the extent (make_cam needs it; IRNet does not).
- ``stop_grad_after`` names the last feature through which no gradient
  flows (``"c3"``: the CAM net's detach after layer2); the layers up to it
  run without autograd, which keeps none of their activations.
- ``dtype``: the compute dtype (float32, the parameters' own, or
  bfloat16), the JAX module's ``dtype``. The input is cast to it at
  entry, each convolution's f32 weight is cast to it (round to nearest
  even), batch norm computes its scale and shift in f32 and casts them to
  it; ReLU, the extent mask, the max pool and the residual adds run in it.
  The parameters, the statistics and their gradients stay f32. A
  convolution handed another dtype than its own raises, so no layer falls
  back to f32 quietly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

Extent = Optional[Tuple[int, int]]

# Feature names in forward order; ``stop_grad_after`` refers to these.
FEATURE_NAMES = ("stem", "c2", "c3", "c4", "c5")


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

    def forward(self, x: torch.Tensor, calibrate: bool = False
                ) -> torch.Tensor:
        """``calibrate``: write the batch's per-channel mean and population
        variance (over N, H, W, in f32) into the running statistics first,
        so this forward and every later one normalize with them."""
        if calibrate:
            with torch.no_grad():
                xf = x.float()
                mean = xf.mean(dim=(0, 2, 3))
                var = (xf - mean[None, :, None, None]).square().mean(
                    dim=(0, 2, 3))
                self.running_mean.copy_(mean)
                self.running_var.copy_(var)
        rs = torch.rsqrt(self.running_var + self.eps)
        # in f32, then cast to x's dtype (torch would promote a bf16 x to
        # f32 against them)
        inv = (self.weight * rs).to(x.dtype)
        shift = (self.bias - self.running_mean * self.weight * rs).to(x.dtype)
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


class Conv2d(nn.Conv2d):
    """A bias-free ``nn.Conv2d`` with an f32 weight that computes in
    ``dtype`` (Flax's ``nn.Conv(dtype=...)``). For float32 that is the
    weight's own dtype (so a model converted by ``.double()`` computes in
    f64); for bfloat16 the weight is cast per call where autograd needs
    the cast, else once per weight version and device (inference, a frozen
    layer). An input of another dtype raises."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, bias=False, **kw)
        self.cast_to = None if dtype == torch.float32 else dtype
        self._cast = None
        self._cast_key = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.cast_to or self.weight.dtype

    def _weight(self) -> torch.Tensor:
        w = self.weight
        if self.cast_to is None:
            return w
        if torch.is_grad_enabled() and w.requires_grad:
            return w.to(self.cast_to)
        key = (w.device, w.data_ptr(), w._version)
        if self._cast_key != key:
            self._cast = w.detach().to(self.cast_to)
            self._cast_key = key
        return self._cast

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.compute_dtype:
            raise TypeError(f"a {self.compute_dtype} convolution got a "
                            f"{x.dtype} input")
        return self._conv_forward(x, self._weight(), None)


def _conv(cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1,
          padding: int = 0, dtype: torch.dtype = torch.float32) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=padding,
                  dilation=dilation, dtype=dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride, dilation) -> 1x1(x4) with identity/projection skip."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, project: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, planes, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride,
                           dilation=dilation, padding=dilation, dtype=dtype)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(cin, planes * 4, 1, stride=stride,
                                dtype=dtype),
                          FrozenBatchNorm2d(planes * 4))
            if project else None
        )

    def forward(self, x: torch.Tensor, extent: Extent = None,
                calibrate: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), calibrate))
        out = _extent_mask(out, extent)  # before the spatial conv
        out = F.relu(self.bn2(self.conv2(out), calibrate))
        out = self.bn3(self.conv3(out), calibrate)
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(conv(x), calibrate)
        return F.relu(out + residual)


class ResNet50(nn.Module):
    """Stage-feature extractor: returns the ``stem`` (64 ch, stride 4) and
    ``c2``..``c5`` (256/512/1024/2048 ch) NCHW features, in ``dtype``."""

    def __init__(self, strides: Sequence[int] = (2, 2, 2, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"compute dtype {dtype}: float32 and bfloat16 are ported")
        self.strides = tuple(strides)
        self.conv1 = _conv(3, 64, 7, stride=strides[0], padding=3,
                           dtype=dtype)
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
                    project=first, dtype=dtype,
                ))
                cin = planes[li] * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (the input is cast to it at entry)."""
        return self.conv1.compute_dtype

    def forward(self, x: torch.Tensor, extent: Extent = None,
                stop_grad_after: Optional[str] = None,
                calibrate: bool = False):
        """``stop_grad_after``: a feature of :data:`FEATURE_NAMES`; it and
        every feature before it are computed without autograd.
        ``calibrate``: every batch norm writes this batch's statistics
        before it normalizes (see :class:`FrozenBatchNorm2d`)."""
        if stop_grad_after is not None and stop_grad_after not in FEATURE_NAMES:
            raise ValueError(f"unknown feature {stop_grad_after!r}")
        cut = (FEATURE_NAMES.index(stop_grad_after)
               if stop_grad_after is not None else -1)
        grad = torch.is_grad_enabled()
        feats = {}
        x = x.to(self.dtype)
        with torch.set_grad_enabled(grad and cut < 0):
            x = F.relu(self.bn1(self.conv1(x), calibrate))
            if self.strides[0] == 2:
                extent = _halve_extent(extent)
            x = _extent_mask(x, extent)  # before the spatial maxpool
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        extent = _halve_extent(extent)
        feats["stem"] = x
        for li, name in enumerate(FEATURE_NAMES[1:]):
            with torch.set_grad_enabled(grad and li + 1 > cut):
                for block in getattr(self, f"layer{li + 1}"):
                    x = block(x, extent, calibrate)
                    if block.stride == 2:
                        extent = _halve_extent(extent)
            feats[name] = x
        return feats
