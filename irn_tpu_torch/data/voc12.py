"""The raw-image source make_sem_seg reads (the JAX package's
``voc12.ImageDataset(..., img_normal=False)``), on the port's image I/O."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from irn_tpu_torch.data import image_io

IMG_FOLDER_NAME = "JPEGImages"


def load_img_name_list(path: str) -> List[str]:
    """Read an id list ("2007_000032" per line) as strings."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def get_img_path(img_name: str, voc12_root: str) -> str:
    return os.path.join(voc12_root, IMG_FOLDER_NAME, img_name + ".jpg")


class RawImageDataset:
    """Indexable {name, img [H, W, 3] uint8} over an id list."""

    def __init__(self, img_name_list_path: str, voc12_root: str):
        self.img_name_list = load_img_name_list(img_name_list_path)
        self.voc12_root = voc12_root

    def __len__(self) -> int:
        return len(self.img_name_list)

    def __getitem__(self, idx: int) -> Dict:
        name = self.img_name_list[idx]
        img = image_io.imread(get_img_path(name, self.voc12_root))
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        return {"name": name, "img": np.ascontiguousarray(img[..., :3])}
