"""VOC instance-segmentation AP (chainercv replacement): the port's copy
of ``irn_tpu.eval.insseg`` (numpy only).

Reimplements ``chainercv.evaluations.eval_instance_segmentation_voc``
semantics for the eval_ins_seg stage (step/eval_ins_seg.py:22-23):
per-class greedy matching of score-ranked predicted masks to ground-truth
masks at an IoU threshold, then all-points VOC average precision."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return inter / union if union > 0 else 0.0


def _voc_ap(prec: np.ndarray, rec: np.ndarray) -> float:
    """All-points interpolated AP (chainercv use_07_metric=False)."""
    mpre = np.concatenate(([0.0], np.nan_to_num(prec), [0.0]))
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_instance_segmentation_voc(
    pred_masks: Sequence[np.ndarray],
    pred_labels: Sequence[np.ndarray],
    pred_scores: Sequence[np.ndarray],
    gt_masks: Sequence[np.ndarray],
    gt_labels: Sequence[np.ndarray],
    iou_thresh: float = 0.5,
) -> Dict:
    """Per-image lists of ([R, H, W] bool masks, [R] class ids, [R] scores).

    Returns {'ap': per-class array, 'map': mean over classes with gt}.
    """
    n_pos: Dict[int, int] = defaultdict(int)
    scores: Dict[int, List[float]] = defaultdict(list)
    match: Dict[int, List[int]] = defaultdict(list)

    for pm, pl, ps, gm, gl in zip(
        pred_masks, pred_labels, pred_scores, gt_masks, gt_labels
    ):
        pm = np.asarray(pm, bool)
        pl = np.asarray(pl, np.int64)
        ps = np.asarray(ps, np.float64)
        gm = np.asarray(gm, bool)
        gl = np.asarray(gl, np.int64)
        for cls in np.unique(np.concatenate([pl, gl])).tolist():
            p_sel = pl == cls
            order = np.argsort(-ps[p_sel], kind="stable")
            cls_masks = pm[p_sel][order]
            cls_scores = ps[p_sel][order]
            g_sel = gm[gl == cls]
            n_pos[cls] += int(g_sel.shape[0])
            scores[cls].extend(cls_scores.tolist())
            taken = np.zeros(g_sel.shape[0], bool)
            for mask in cls_masks:
                if g_sel.shape[0] == 0:
                    match[cls].append(0)
                    continue
                ious = np.array([mask_iou(mask, g) for g in g_sel])
                best = int(np.argmax(ious))
                if ious[best] >= iou_thresh and not taken[best]:
                    taken[best] = True
                    match[cls].append(1)
                else:
                    match[cls].append(0)

    classes = sorted(n_pos.keys() | scores.keys())
    n_cls = (max(classes) + 1) if classes else 0
    ap = np.full(n_cls, np.nan)
    for cls in classes:
        if n_pos[cls] == 0:
            continue
        sc = np.asarray(scores[cls])
        mt = np.asarray(match[cls])
        order = np.argsort(-sc, kind="stable")
        mt = mt[order]
        tp = np.cumsum(mt == 1)
        fp = np.cumsum(mt == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = tp / (tp + fp)
        rec = tp / n_pos[cls]
        ap[cls] = _voc_ap(prec, rec)
    return {"ap": ap, "map": float(np.nanmean(ap)) if n_cls else float("nan")}


def load_voc_instance_gt(seg_obj_png: np.ndarray, seg_cls_png: np.ndarray):
    """(masks [R, H, W] bool, labels [R] 0-based classes) from VOC
    SegmentationObject + SegmentationClass pngs (255 = void)."""
    ids = [i for i in np.unique(seg_obj_png) if i not in (0, 255)]
    masks, labels = [], []
    for i in ids:
        vals, counts = np.unique(seg_cls_png[seg_obj_png == i], return_counts=True)
        keep = [(v, c) for v, c in zip(vals, counts) if v not in (0, 255)]
        if not keep:
            # instance entirely background/void in SegmentationClass —
            # dropping it is correct; the old 'else 0' fallback labeled
            # it aeroplane, inflating n_pos[0] with an unmatchable mask
            # and deflating that class's AP (found by review)
            continue
        masks.append(seg_obj_png == i)
        labels.append(int(max(keep, key=lambda t: t[1])[0]) - 1)
    stacked = (np.stack(masks) if masks
               else np.zeros((0,) + seg_obj_png.shape, bool))
    return stacked, np.asarray(labels, np.int64)
