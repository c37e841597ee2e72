"""Multi-label CAM classifier (NCHW) — the counterpart of
:mod:`irn_tpu.models.cam` with the reference's torch module names
(net/resnet50_cam.py): ``resnet50.*`` and the head ``classifier``.

- ResNet-50 backbone, strides (2, 2, 2, 1), frozen batch norm. In training
  no gradient flows through ``stop_grad_at`` (default ``"c3"``, the
  reference's detach after layer2, resnet50_cam.py:28): the stem and layers
  1-2 run without autograd, layers 3-4 and the head train.
- Head: bias-free 1x1 conv 2048 -> 20. :meth:`CAMNet.forward` applies it
  after global average pooling (logits, resnet50_cam.py:33-35);
  :meth:`CAMNet.cam` applies it before pooling and takes the ReLU, the
  per-class activation maps of inference (resnet50_cam.py:65-66).
- :meth:`CAMNet.calibrate_stats` writes one batch's statistics into every
  frozen batch norm (train_cam without a pretrained backbone).
- Flip fusion is the make_cam stage's (``pipeline/stages_cam.py``).
- ``dtype`` is the backbone's compute dtype; the head has none (f32, as
  the JAX ``classifier``): the pooled or per-pixel c5 is upcast into it,
  so logits and maps are f32 either way. The pooling runs in the backbone's
  dtype, as ``jnp.mean`` of a bf16 c5 does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from irn_tpu_torch.models.resnet import Extent, ResNet50


class CAMNet(nn.Module):
    """ResNet-50 multi-label classifier with a CAM inference path.

    ``stop_grad_at``: the feature through which training gradients are
    blocked; None trains the whole backbone."""

    def __init__(self, n_classes: int = 20,
                 stop_grad_at: Optional[str] = "c3",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_classes = n_classes
        self.stop_grad_at = stop_grad_at
        self.resnet50 = ResNet50(strides=(2, 2, 2, 1), dtype=dtype)
        self.classifier = nn.Conv2d(2048, n_classes, 1, bias=False)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """Classification logits [B, n_classes] of NCHW images; ``train``
        blocks gradients through ``stop_grad_at`` (the values are the
        same either way)."""
        feats = self.resnet50(
            x, stop_grad_after=self.stop_grad_at if train else None)
        x = feats["c5"].mean(dim=(2, 3), keepdim=True)
        return self.classifier(x.to(self.classifier.weight.dtype)).flatten(1)

    @torch.no_grad()
    def calibrate_stats(self, x: torch.Tensor) -> torch.Tensor:
        """One calibration forward: every frozen batch norm writes this
        batch's statistics and normalizes with them. Returns the pooled
        c5 features [B, 2048] in the backbone's dtype."""
        return self.resnet50(x, calibrate=True)["c5"].mean(dim=(2, 3))

    def cam(self, x: torch.Tensor, extent: Extent = None) -> torch.Tensor:
        """Per-class activation maps [B, n_classes, h, w] (stride 16).

        ``extent``: the true (h, w) when ``x`` is a padded buffer; the
        backbone masks beyond it, so in-extent maps match an exact-size
        run."""
        c5 = self.resnet50(x, extent)["c5"]
        return F.relu(self.classifier(c5.to(self.classifier.weight.dtype)))


def multilabel_soft_margin_loss(logits: torch.Tensor,
                                targets: torch.Tensor) -> torch.Tensor:
    """The mean over batch and classes of -(y log sigmoid(x) + (1 - y) log
    sigmoid(-x)), as ``torch.nn.functional.multilabel_soft_margin_loss``
    and the JAX package's function."""
    per_class = -(targets * F.logsigmoid(logits)
                  + (1.0 - targets) * F.logsigmoid(-logits))
    return per_class.mean()
