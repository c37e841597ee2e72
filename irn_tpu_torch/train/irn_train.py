"""IRNet training — the counterpart of :mod:`irn_tpu.train.irn_train`
(stage contract: step/train_irn.py of the reference).

The loss side runs as two pairs of kernels: the path max (K13a forward,
K13b backward), then the affinity labels, the four masked affinity /
displacement losses and the reference's weighting in one pass each way
(K16 forward and backward), from the reduced label map on the device; no
per-pair mask or loss map is made. Under ``--model_dtype bfloat16`` the
frozen backbone runs in bf16 without autograd and the heads in f32, so
K13a, K16 and K13b see f32 as in an f32 run. After training, the
displacement mean calibrates MeanShift (train_irn.py:95-107). The stage's ``.train`` checkpoint is
:func:`irn_tpu_torch.train.optim.train_state`'s."""

from __future__ import annotations

from typing import Dict

import torch

from irn_tpu_torch.models.irn import IRNet
from irn_tpu_torch.ops import affinity
from irn_tpu_torch.ops import paths
from irn_tpu_torch.train.optim import PolySGD


def build_train_geometry(crop_size: int = 512, radius: int = 10
                         ) -> affinity.PathTable:
    """The path table of ``radius`` for crops of ``crop_size`` pixels (a
    stride-4 grid of crop_size // 4 cells, which must hold a window)."""
    table = affinity.path_table(paths.build_path_set(radius))
    grid = crop_size // 4
    if grid - table.rf < 1 or grid - 2 * table.rf < 1:
        raise ValueError(f"crop {crop_size} (grid {grid}) has no valid "
                         f"window at radius {radius}")
    return table


def make_train_step(model: IRNet, optimizer: PolySGD,
                    table: affinity.PathTable, group=None):
    """step(images [B, 3, H, W] f32, reduced_labels [B, H/4, W/4] int) ->
    the four loss scalars and ``loss``, on the device (no sync): forward,
    path max (K13a), loss (K16), backward (K16, K13b, the heads), optimizer
    step.

    Data-parallel: ``model`` is DDP's wrap with summed gradients
    (``mesh.data_parallel(..., sum_gradients=True)``) and ``group`` the
    ranks' group; each rank's batch is its rows of the global batch. The
    loss is then the global batch's on every rank (``affinity.irn_loss``
    sums K16's stats over the group), its gradient with respect to each
    rank's rows is that rank's share, and the summed gradients are the
    global batch's, as JAX's data-parallel step computes them. DDP's
    default averaging of per-rank losses would divide each rank's terms by
    its own label counts instead."""

    def train_step(images: torch.Tensor, reduced_labels: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        edge_logit, dp = model(images)
        maxed = affinity.path_max(
            torch.sigmoid(edge_logit[:, 0]).contiguous(), table)
        loss, metrics = affinity.irn_loss(maxed, dp, reduced_labels, table,
                                          group)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        return out

    return train_step


def make_dp_mean_step(model: IRNet):
    """Per-batch displacement means for the MeanShift calibration
    (train_irn.py:95-107): the mean over batch and space per channel."""

    @torch.no_grad()
    def dp_mean_step(images: torch.Tensor) -> torch.Tensor:
        _, dp = model(images)
        return dp.mean(dim=(0, 2, 3))  # [2]

    return dp_mean_step


@torch.no_grad()
def calibrate_mean_shift(model: IRNet, dp_means) -> None:
    """Write mean(dp_means) into the model's MeanShift (``stats['dp_mean']``
    of the JAX layout)."""
    mean = torch.stack(list(dp_means)).mean(0)
    model.mean_shift.running_mean.copy_(mean.float())
