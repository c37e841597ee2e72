"""Synthetic VOC-like tree, the same draws as
:func:`irn_tpu.data.synthetic.generate` (same seed, same arrays), written
through the port's image I/O so hosts without imageio can make it:

    <root>/JPEGImages/<id>.jpg          RGB images with colored class blobs
    <root>/SegmentationClass/<id>.png    semantic gt (0 bg, 1..20)
    <root>/SegmentationObject/<id>.png   instance gt (0 bg, 1..K)
    <root>/train.txt, val.txt            id lists
    <root>/cls_labels.npy                {id: float32[20]} multi-hot dict
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from irn_tpu_torch.data import image_io

# distinct colors per class id (1..20)
_COLORS = (np.stack(np.meshgrid([60, 130, 200], [60, 130, 200], [60, 130, 200]),
                    -1).reshape(-1, 3)[:20]).astype(np.int32)


def generate(root: str, n_images: int = 8, size: int = 120,
             max_side_jitter: int = 40, n_classes: int = 20,
             seed: int = 0) -> Tuple[str, str]:
    """Write the tree; returns (train_list_path, val_list_path)."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "JPEGImages")
    sem_dir = os.path.join(root, "SegmentationClass")
    ins_dir = os.path.join(root, "SegmentationObject")
    for d in (img_dir, sem_dir, ins_dir):
        os.makedirs(d, exist_ok=True)

    names = []
    labels = {}
    for i in range(n_images):
        name = f"2007_{i:06d}"
        names.append(name)
        h = size + int(rng.integers(0, max_side_jitter + 1))
        w = size + int(rng.integers(0, max_side_jitter + 1))
        img = rng.integers(150, 255, (h, w, 3)).astype(np.uint8)
        sem = np.zeros((h, w), np.uint8)
        ins = np.zeros((h, w), np.uint8)
        multi = np.zeros((n_classes,), np.float32)
        for b in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(1, n_classes + 1))
            cy = rng.integers(h // 4, 3 * h // 4)
            cx = rng.integers(w // 4, 3 * w // 4)
            ry, rx = rng.integers(h // 8, h // 4), rng.integers(w // 8, w // 4)
            yy, xx = np.mgrid[0:h, 0:w]
            mask = ((yy - cy) / max(ry, 1)) ** 2 + ((xx - cx) / max(rx, 1)) ** 2 < 1
            color = _COLORS[cls - 1]
            img[mask] = (color + rng.integers(-20, 20, 3)).clip(0, 255)
            sem[mask] = cls
            ins[mask] = b + 1
            multi[cls - 1] = 1.0
        labels[name] = multi
        image_io.imwrite(os.path.join(img_dir, name + ".jpg"), img)
        image_io.imwrite(os.path.join(sem_dir, name + ".png"), sem)
        image_io.imwrite(os.path.join(ins_dir, name + ".png"), ins)

    train = names[: max(1, (3 * len(names)) // 4)]
    val = names[max(1, (3 * len(names)) // 4):] or names[-1:]
    train_path = os.path.join(root, "train.txt")
    val_path = os.path.join(root, "val.txt")
    with open(train_path, "w") as f:
        f.write("\n".join(train) + "\n")
    with open(val_path, "w") as f:
        f.write("\n".join(val) + "\n")
    np.save(os.path.join(root, "cls_labels.npy"), labels)  # dict payload
    return train_path, val_path


def write_gt_cams(root: str, names, cam_dir: str) -> None:
    """Stand-in make_cam output for smoke runs and tests: per image, a
    ``<cam_dir>/<id>.npy`` dict whose seed rows are the present classes'
    GT masks at stride 4, softened to 0.05 / 0.85."""
    os.makedirs(cam_dir, exist_ok=True)
    for name in names:
        sem = image_io.imread(
            os.path.join(root, "SegmentationClass", name + ".png"))
        cls = np.unique(sem[(sem > 0) & (sem < 255)])
        h4, w4 = (sem.shape[0] - 1) // 4 + 1, (sem.shape[1] - 1) // 4 + 1
        cam = np.stack([
            (sem[::4, ::4] == c).astype(np.float32) * 0.8 + 0.05 for c in cls
        ])[:, :h4, :w4]
        np.save(os.path.join(cam_dir, name + ".npy"),
                {"keys": (cls - 1).astype(np.int64), "cam": cam,
                 "high_res": None})
