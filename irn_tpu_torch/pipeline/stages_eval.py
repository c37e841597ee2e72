"""eval_sem_seg, eval_ins_seg and make_cocoann for the port: the
counterparts of ``irn_tpu.pipeline.stages_eval`` (confusion-matrix mIoU,
VOC instance AP50, the COCO json), with
its own copies of the three numpy functions of ``irn_tpu.eval.semseg`` that
the port's eval stages use (:func:`accumulate_confusion`,
:func:`scores_from_confusion`, :func:`decode_cam_to_labels`) and label
PNGs read by Pillow (``image_io``), so they run on hosts without imageio
(which the JAX stage module imports). The AP and the COCO export are the
port's copies in :mod:`irn_tpu_torch.eval`."""

from __future__ import annotations

import itertools
import os
from typing import Dict

import numpy as np

from irn_tpu_torch.data import voc12
from irn_tpu_torch.data.image_io import imread
from irn_tpu_torch.eval import coco, insseg
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


def eval_ins_seg(cfg: Config, device=None):
    """VOC instance AP at IoU 0.5 of ``ins_seg_out_dir`` against the
    SegmentationObject / SegmentationClass ground truth (a host
    computation, streamed one image at a time; ``device`` is unused)."""
    names = _gt_ids(cfg)

    def records():
        for name in names:
            ins = np.load(os.path.join(cfg.ins_seg_out_dir, name + ".npy"),
                          allow_pickle=True).item()
            obj = imread(os.path.join(cfg.voc12_root, "SegmentationObject",
                                      name + ".png"))
            cls = imread(os.path.join(cfg.voc12_root, "SegmentationClass",
                                      name + ".png"))
            masks, labels = insseg.load_voc_instance_gt(obj, cls)
            yield (np.asarray(ins["mask"], bool), np.asarray(ins["class"]),
                   np.asarray(ins["score"]), masks, labels)

    def field(f, k):
        return (r[k] for r in f)

    # tee'd views over one record generator, zipped in lockstep by the
    # evaluator, keep one image's masks resident
    fields = itertools.tee(records(), 5)
    result = insseg.eval_instance_segmentation_voc(
        *(field(f, k) for k, f in enumerate(fields)), iou_thresh=0.5
    )
    print("0.5iou:", result)
    return result


def make_cocoann(cfg: Config, device=None):
    """The COCO json of ``ins_seg_out_dir`` at ``coco_ann_path``
    (``coco_seg_format`` polygon needs OpenCV; rle does not). ``device``
    is unused."""
    records = []
    for name in _gt_ids(cfg):
        ins = np.load(os.path.join(cfg.ins_seg_out_dir, name + ".npy"),
                      allow_pickle=True).item()
        if "size" not in ins:
            ins["size"] = ins["mask"].shape[1:] if len(ins["mask"]) else (0, 0)
        ins["name"] = name
        records.append(ins)
    os.makedirs(os.path.dirname(cfg.coco_ann_path) or ".", exist_ok=True)
    out = coco.export_instances(
        records, cfg.coco_ann_path, segmentation_format=cfg.coco_seg_format
    )
    print(f"wrote {cfg.coco_ann_path}: {len(out['images'])} images, "
          f"{len(out['annotations'])} annotations")
    return out
