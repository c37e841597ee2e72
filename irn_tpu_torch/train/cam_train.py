"""CAM classifier training — the counterpart of
:mod:`irn_tpu.train.cam_train` (stage contract: step/train_cam.py of the
reference).

One step: the CAMNet training forward (no autograd through the stem and
layers 1-2 under ``stop_grad_at="c3"``), the multilabel soft-margin loss,
the backward and the poly SGD step over the CAM groups (head 10x). Under
``--model_dtype bfloat16`` layers 3-4 train through bf16 convolutions
whose f32 weights are cast in the forward, so the parameters and their
gradients stay f32; the loss is taken on the f32 logits. The evaluation
step is the same forward and loss without autograd."""

from __future__ import annotations

import torch

from irn_tpu_torch.models.cam import CAMNet, multilabel_soft_margin_loss
from irn_tpu_torch.train.optim import PolySGD


def make_train_step(model: CAMNet, optimizer: PolySGD):
    """step(images [B, 3, H, W] f32, labels [B, 20] f32) -> the loss, a
    device scalar (no sync): forward, loss, backward, optimizer step."""

    def train_step(images: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
        loss = multilabel_soft_margin_loss(model(images, train=True), labels)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def make_eval_step(model: CAMNet):
    """eval(images, labels) -> the loss of the inference forward."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
        return multilabel_soft_margin_loss(model(images, train=False), labels)

    return eval_step
