"""eval_sem_seg for the port: the counterpart of
``irn_tpu.pipeline.stages_eval.eval_sem_seg`` (confusion-matrix mIoU), with
its own copies of the three numpy functions of ``irn_tpu.eval.semseg`` that
the port's eval stages use (:func:`accumulate_confusion`,
:func:`scores_from_confusion`, :func:`decode_cam_to_labels`) and label
PNGs read by Pillow (``image_io``), so it runs on hosts without imageio
(which the JAX stage module imports)."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from irn_tpu_torch.data import voc12
from irn_tpu_torch.data.image_io import imread
from irn_tpu_torch.pipeline.config import Config


def accumulate_confusion(conf: np.ndarray, pred: np.ndarray, gt: np.ndarray,
                         ignore: int = 255) -> None:
    """In-place one-image update of a fixed-size [n, n] confusion matrix
    (rows gt, columns pred). Void gt (``ignore`` or negative) and labels
    >= n are dropped, as the reference's ``confusion[:21, :21]`` crop
    (step/eval_sem_seg.py:21)."""
    n = conf.shape[0]
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    gt = np.asarray(gt).reshape(-1).astype(np.int64)
    if pred.shape != gt.shape:
        raise ValueError("pred/gt shape mismatch")
    valid = (gt >= 0) & (gt != ignore) & (gt < n) & (pred >= 0) & (pred < n)
    np.add.at(conf, (gt[valid], pred[valid]), 1)


def scores_from_confusion(conf: np.ndarray) -> Dict:
    """Per-class IoU, its nan-mean, and the fp / fn shares of each class's
    union."""
    gtj = conf.sum(axis=1)
    resj = conf.sum(axis=0)
    diag = np.diag(conf)
    denom = gtj + resj - diag
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = diag / denom
        fp = 1.0 - gtj / denom
        fn = 1.0 - resj / denom
    return {"iou": iou, "miou": float(np.nanmean(iou)), "fp": fp, "fn": fn}


def decode_cam_to_labels(high_res_cam: np.ndarray, keys: np.ndarray,
                         bg_thres: float) -> np.ndarray:
    """Threshold-pad background, then argmax (eval_cam.py:14-18): [K, H, W]
    normalized maps of the 0-based classes ``keys`` -> [H, W] labels in
    {0} | keys + 1. An image whose maps are all zero decodes to
    background wherever bg_thres > 0."""
    padded = np.concatenate(
        [np.full((1,) + high_res_cam.shape[1:], bg_thres, high_res_cam.dtype),
         high_res_cam],
        axis=0,
    )
    keymap = np.pad(np.asarray(keys) + 1, (1, 0), mode="constant")
    return keymap[np.argmax(padded, axis=0)]


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
        accumulate_confusion(conf, pred, gt)
    scores = scores_from_confusion(conf)
    print(scores["fp"][0], scores["fn"][0])
    print(np.nanmean(scores["fp"][1:]), np.nanmean(scores["fn"][1:]))
    print({"iou": scores["iou"], "miou": scores["miou"]})
    return scores
