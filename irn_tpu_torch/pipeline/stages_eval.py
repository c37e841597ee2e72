"""eval_sem_seg for the port: :func:`irn_tpu.pipeline.stages_eval.eval_sem_seg`
(confusion-matrix mIoU through the reused, numpy-only
:mod:`irn_tpu.eval.semseg`) with label PNGs read by Pillow (``image_io``), so it runs on
hosts without imageio (which the JAX stage module imports)."""

from __future__ import annotations

import os

import numpy as np

from irn_tpu.eval import semseg
from irn_tpu.pipeline.config import Config
from irn_tpu_torch.data import voc12
from irn_tpu_torch.data.image_io import imread


def _gt_ids(cfg: Config):
    """The VOC segmentation split named by ``eval_set`` when present, else
    the infer list (as the JAX stage)."""
    split = os.path.join(cfg.voc12_root, "ImageSets", "Segmentation",
                         cfg.eval_set + ".txt")
    if cfg.eval_set and os.path.exists(split):
        return voc12.load_img_name_list(split)
    return voc12.load_img_name_list(cfg.infer_list)


def eval_sem_seg(cfg: Config, device=None):
    """Confusion-matrix mIoU of ``sem_seg_out_dir`` against the VOC ground
    truth (a host computation: ``device`` is accepted for the uniform
    stage signature and unused)."""
    conf = np.zeros((21, 21), np.int64)
    for name in _gt_ids(cfg):
        pred = imread(
            os.path.join(cfg.sem_seg_out_dir, name + ".png")
        ).astype(np.int64)
        pred[pred == 255] = 0  # eval_sem_seg.py:15
        gt = imread(
            os.path.join(cfg.voc12_root, "SegmentationClass", name + ".png")
        )
        semseg.accumulate_confusion(conf, pred, gt)
    scores = semseg.scores_from_confusion(conf)
    print(scores["fp"][0], scores["fn"][0])
    print(np.nanmean(scores["fp"][1:]), np.nanmean(scores["fn"][1:]))
    print({"iou": scores["iou"], "miou": scores["miou"]})
    return scores
