"""Multi-label CAM classifier (NCHW) — the counterpart of
:mod:`irn_tpu.models.cam` with the reference's torch module names
(net/resnet50_cam.py): ``resnet50.*`` and the head ``classifier``.

- ResNet-50 backbone, strides (2, 2, 2, 1), frozen batch norm.
- Head: bias-free 1x1 conv 2048 -> 20. :meth:`CAMNet.forward` applies it
  after global average pooling (logits, resnet50_cam.py:33-35);
  :meth:`CAMNet.cam` applies it before pooling and takes the ReLU, the
  per-class activation maps of inference (resnet50_cam.py:65-66).
- Flip fusion is the make_cam stage's (``pipeline/stages_cam.py``).

The training-time gradient stop after layer2 (``stop_grad_at``) waits for
train_cam.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from irn_tpu_torch.models.resnet import Extent, ResNet50


class CAMNet(nn.Module):
    """ResNet-50 multi-label classifier with a CAM inference path."""

    def __init__(self, n_classes: int = 20):
        super().__init__()
        self.n_classes = n_classes
        self.resnet50 = ResNet50(strides=(2, 2, 2, 1))
        self.classifier = nn.Conv2d(2048, n_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Classification logits [B, n_classes] of NCHW images."""
        x = self.resnet50(x)["c5"].mean(dim=(2, 3), keepdim=True)
        return self.classifier(x).flatten(1)

    def cam(self, x: torch.Tensor, extent: Extent = None) -> torch.Tensor:
        """Per-class activation maps [B, n_classes, h, w] (stride 16).

        ``extent``: the true (h, w) when ``x`` is a padded buffer; the
        backbone masks beyond it, so in-extent maps match an exact-size
        run."""
        return F.relu(self.classifier(self.resnet50(x, extent)["c5"]))
