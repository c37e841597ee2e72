"""IRNet: class-boundary and displacement-field decoders over a frozen
ResNet-50 (NCHW) — the counterpart of :mod:`irn_tpu.models.irn`, with the
reference's torch module names (net/resnet50_irn.py): ``resnet50.*``,
``fc_edge1..6``, ``fc_dp1..7`` (``fc_dp7.0/.1/.3``) and
``mean_shift.running_mean``. So :func:`irn_tpu_torch.utils.weights.convert_irn_net`
(a copy of ``irn_tpu.utils.weights.convert_irn_net``) maps this module's
``state_dict()`` to the JAX variables and
:func:`irn_tpu_torch.utils.weights.irn_from_jax` maps them back.

- Boundary branch: per-stage bias-free 1x1 conv -> GroupNorm(4, 32, eps
  1e-5) -> bilinear x2/x4 (stride-8/16 stages) -> ReLU; cropped to edge2's
  size; concat(160) -> 1x1 conv with bias -> 1-channel logit at stride 4.
- Displacement branch: fc_dp1..7 to a 2-channel (dy, dx) field at stride
  4, minus the calibrated mean at eval (MeanShift).
- ``dtype`` is the backbone's compute dtype; the heads take its features
  upcast to f32 and compute in f32 (the JAX heads have no dtype, so Flax
  promotes their bf16 inputs), so edge and dp are f32 either way.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from irn_tpu_torch.models.resnet import ResNet50


def _conv_gn(cin: int, cout: int, groups: int, upsample: int = 1):
    """Sequential(conv, GroupNorm[, Upsample], ReLU): indices .0 and .1
    carry the weights, as in the reference."""
    layers = [nn.Conv2d(cin, cout, 1, bias=False),
              nn.GroupNorm(groups, cout, eps=1e-5)]
    if upsample != 1:
        layers.append(nn.Upsample(scale_factor=upsample, mode="bilinear",
                                  align_corners=False))
    layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class MeanShift(nn.Module):
    """Subtracts the calibrated displacement mean (reference MeanShift)."""

    def __init__(self, channels: int = 2):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x - self.running_mean[None, :, None, None]


class IRNet(nn.Module):
    """Two-headed inter-pixel relation network over a frozen backbone."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnet50 = ResNet50(strides=(2, 2, 2, 1), dtype=dtype)
        self.fc_edge1 = _conv_gn(64, 32, 4)
        self.fc_edge2 = _conv_gn(256, 32, 4)
        self.fc_edge3 = _conv_gn(512, 32, 4, upsample=2)
        self.fc_edge4 = _conv_gn(1024, 32, 4, upsample=4)
        self.fc_edge5 = _conv_gn(2048, 32, 4, upsample=4)
        self.fc_edge6 = nn.Conv2d(160, 1, 1, bias=True)
        self.fc_dp1 = _conv_gn(64, 64, 8)
        self.fc_dp2 = _conv_gn(256, 128, 16)
        self.fc_dp3 = _conv_gn(512, 256, 16)
        self.fc_dp4 = _conv_gn(1024, 256, 16, upsample=2)
        self.fc_dp5 = _conv_gn(2048, 256, 16, upsample=2)
        self.fc_dp6 = _conv_gn(768, 256, 16, upsample=2)
        self.fc_dp7 = nn.Sequential(
            nn.Conv2d(448, 256, 1, bias=False),
            nn.GroupNorm(16, 256, eps=1e-5),
            nn.ReLU(),
            nn.Conv2d(256, 2, 1, bias=False),
        )
        self.mean_shift = MeanShift(2)

    def features(self, x: torch.Tensor):
        """The backbone's stage features, computed without autograd: the
        backbone is fully frozen (JAX ``stop_grad_after="c5"``), so
        training keeps none of its activations."""
        with torch.no_grad():
            return self.resnet50(x)

    def heads(self, f, apply_mean_shift: bool = False):
        """Stage features -> (edge logit [B, 1, h4, w4], displacement
        [B, 2, h4, w4]) in the heads' dtype (f32); MeanShift only when
        ``apply_mean_shift`` (never in training)."""
        dt = self.fc_edge6.weight.dtype  # the heads' own (f32)
        x1, x2, x3, x4, x5 = (f[k].to(dt)
                              for k in ("stem", "c2", "c3", "c4", "c5"))

        e2 = self.fc_edge2(x2)
        h2, w2 = e2.shape[-2:]
        e1 = self.fc_edge1(x1)[..., :h2, :w2]
        e3 = self.fc_edge3(x3)[..., :h2, :w2]
        e4 = self.fc_edge4(x4)[..., :h2, :w2]
        e5 = self.fc_edge5(x5)[..., :h2, :w2]
        edge = self.fc_edge6(torch.cat([e1, e2, e3, e4, e5], dim=1))

        d1 = self.fc_dp1(x1)
        d2 = self.fc_dp2(x2)
        d3 = self.fc_dp3(x3)
        h3, w3 = d3.shape[-2:]
        d4 = self.fc_dp4(x4)[..., :h3, :w3]
        d5 = self.fc_dp5(x5)[..., :h3, :w3]
        d_up3 = self.fc_dp6(torch.cat([d3, d4, d5], dim=1))[..., :h2, :w2]
        dp = self.fc_dp7(torch.cat([d1[..., :h2, :w2], d2, d_up3], dim=1))
        if apply_mean_shift:
            dp = self.mean_shift(dp)
        return edge, dp

    def forward(self, x: torch.Tensor, apply_mean_shift: bool = False):
        """x: [B, 3, H, W] -> (edge logit [B, 1, h4, w4],
        displacement [B, 2, h4, w4])."""
        return self.heads(self.features(x), apply_mean_shift)


@torch.no_grad()
def init_irnet(model: IRNet, generator: torch.Generator) -> IRNet:
    """Seeded random weights (no pretrained file needed): convs drawn from
    ``generator`` as normals scaled by 1/sqrt(fan_in) (the LeCun scale of
    the Flax default init), biases zero, GroupNorm/BN affine at identity,
    BN statistics at (0, 1)."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
            w = torch.empty(mod.weight.shape, dtype=torch.float32)
            w.normal_(0.0, 1.0, generator=generator)
            mod.weight.copy_(w / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
    return model
