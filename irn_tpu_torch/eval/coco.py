"""COCO-format export of instance pseudo-labels (make_cocoann capability):
the port's copy of ``irn_tpu.eval.coco``, on the port's ``CAT_LIST`` and
``rle_encode``. Polygon export imports ``cv2`` when it is called; a host
without OpenCV exports ``segmentation_format="rle"`` only.

Replaces pycococreatortools (step/make_cocoann.py): builds image records
and annotations from the ins_seg stage outputs. Segmentations default to
polygons traced from the masks with tolerance=0 (the reference's call —
pycococreatortools ``create_annotation_info(..., tolerance=0)``,
step/make_cocoann.py:43-44 — performs no contour simplification);
uncompressed COCO RLE is available via ``segmentation_format="rle"`` for
consumers that prefer lossless masks."""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

from irn_tpu_torch.data.voc12 import CAT_LIST
from irn_tpu_torch.ops.cc import rle_encode


def binary_mask_to_polygons(
    mask: np.ndarray, tolerance: float = 2.0
) -> List[List[float]]:
    """Trace a binary mask's boundaries into COCO polygons
    [[x1, y1, x2, y2, ...], ...].

    Mirrors pycococreatortools' binary_mask_to_polygon (skimage
    find_contours on the zero-padded mask + approximate_polygon with
    ``tolerance``): contours come from cv2.findContours on the padded
    mask and are Douglas-Peucker simplified with cv2.approxPolyDP.
    Degenerate (<3 point) rings are dropped; interior (hole) contours are
    emitted as separate polygons, matching the reference tool's behavior.
    """
    import cv2

    padded = np.pad(np.asarray(mask, np.uint8), 1)
    contours, _ = cv2.findContours(
        padded, cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE
    )
    polygons: List[List[float]] = []
    for contour in contours:
        approx = cv2.approxPolyDP(contour, float(tolerance), True)
        if approx.shape[0] < 3:
            continue
        pts = approx.reshape(-1, 2).astype(np.float64) - 1.0  # un-pad
        pts = np.clip(pts, 0.0, None)
        polygons.append(pts.reshape(-1).tolist())
    return polygons


def image_info(image_id: int, file_name: str, width: int, height: int) -> Dict:
    return {
        "id": image_id,
        "file_name": file_name,
        "width": width,
        "height": height,
        "license": None,
        "url": None,
        "date_captured": None,
    }


def mask_bbox(mask: np.ndarray) -> List[float]:
    ys, xs = np.where(mask)
    if ys.size == 0:
        return [0.0, 0.0, 0.0, 0.0]
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    return [x0, y0, x1 - x0 + 1.0, y1 - y0 + 1.0]


def annotation_info(ann_id: int, image_id: int, category_id: int,
                    mask: np.ndarray, score: float | None = None,
                    segmentation_format: str = "polygon",
                    tolerance: float = 0.0) -> Dict | None:
    """tolerance=0 matches the reference exactly (make_cocoann.py:44
    passes tolerance=0 — no Douglas-Peucker simplification of the mask
    contours; pass >0 to opt into smaller jsons)."""
    if segmentation_format == "polygon":
        seg = binary_mask_to_polygons(mask, tolerance)
        if not seg:
            # pycococreatortools returns None for untraceable masks; the
            # reference appends that None verbatim (a null entry in the
            # json, make_cocoann.py:42-45) — we skip instead, a
            # deliberate divergence (null annotations break COCO
            # consumers)
            return None
    else:
        seg = rle_encode(mask)
    ann = {
        "id": ann_id,
        "image_id": image_id,
        "category_id": int(category_id),
        "iscrowd": 0,
        "area": float(mask.sum()),
        "bbox": mask_bbox(mask),
        "segmentation": seg,
    }
    if score is not None:
        ann["score"] = float(score)
    return ann


def voc_categories() -> List[Dict]:
    return [
        {"id": i + 1, "name": c, "supercategory": "object"}
        for i, c in enumerate(CAT_LIST)
    ]


def image_id_from_name(name: str) -> int:
    """'2007_000032' -> 2007000032 (the reference's id scheme,
    make_cocoann.py:27)."""
    return int(name[:4] + name[5:])


def export_instances(
    records: Sequence[Dict],
    out_path: str,
    score_floor: float = 1e-5,
    segmentation_format: str = "polygon",
    tolerance: float = 0.0,
) -> Dict:
    """Write a COCO json from per-image instance records.

    Each record: {"name", "size": (h, w), "score": [N], "mask": [N, h, w],
    "class": [N] 0-based VOC class ids}. Instances below ``score_floor``
    are dropped (make_cocoann.py:38-39)."""
    out = {
        "type": "instances",
        "images": [],
        "annotations": [],
        "categories": voc_categories(),
    }
    ann_id = 1
    for rec in records:
        h, w = rec["size"]
        img_id = image_id_from_name(rec["name"])
        out["images"].append(image_info(img_id, rec["name"] + ".jpg", w, h))
        for score, mask, cls in zip(rec["score"], rec["mask"], rec["class"]):
            if score < score_floor:
                continue
            ann = annotation_info(
                ann_id, img_id, int(cls) + 1, mask, float(score),
                segmentation_format=segmentation_format,
                tolerance=tolerance,
            )
            if ann is None:
                continue
            out["annotations"].append(ann)
            ann_id += 1
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out
