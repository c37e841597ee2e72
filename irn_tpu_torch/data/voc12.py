"""PASCAL VOC 2012 sources of the port: the counterparts of
``irn_tpu.data.voc12``'s id lists, class-label dictionaries,
``ImageDataset`` and ``ClassificationDataset`` with ``img_normal=False``
and no augmentation (what make_cam, cam_to_ir_label and make_sem_seg
read), on the port's image I/O. The augmenting and multi-scale datasets
wait for train_cam and train_irn."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from irn_tpu_torch.data import image_io

IMG_FOLDER_NAME = "JPEGImages"
ANNOT_FOLDER_NAME = "Annotations"

CAT_LIST = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
N_CAT = len(CAT_LIST)
CAT_NAME_TO_NUM = {c: i for i, c in enumerate(CAT_LIST)}


def load_img_name_list(path: str) -> List[str]:
    """Read an id list ("2007_000032" per line) as strings."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def load_image_label_from_xml(img_name: str, voc12_root: str) -> np.ndarray:
    from xml.dom import minidom

    path = os.path.join(voc12_root, ANNOT_FOLDER_NAME, img_name + ".xml")
    elems = minidom.parse(path).getElementsByTagName("name")
    label = np.zeros((N_CAT,), np.float32)
    for e in elems:
        cat = e.firstChild.data
        if cat in CAT_NAME_TO_NUM:
            label[CAT_NAME_TO_NUM[cat]] = 1.0
    return label


def load_label_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a cls_labels .npy dict; reference-style int keys (2007000032)
    get their underscore back."""
    raw = np.load(path, allow_pickle=True).item()
    out: Dict[str, np.ndarray] = {}
    for k, v in raw.items():
        if isinstance(k, str):
            out[k] = np.asarray(v, np.float32)
        else:
            s = str(int(k))
            out[s[:4] + "_" + s[4:]] = np.asarray(v, np.float32)
    return out


def make_label_dict(img_name_list: Sequence[str],
                    voc12_root: str) -> Dict[str, np.ndarray]:
    """The multi-hot dict from VOC XML annotations."""
    return {n: load_image_label_from_xml(n, voc12_root) for n in img_name_list}


def get_img_path(img_name: str, voc12_root: str) -> str:
    return os.path.join(voc12_root, IMG_FOLDER_NAME, img_name + ".jpg")


class ImageDataset:
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


class ClassificationDataset(ImageDataset):
    """Adds the 20-way multi-hot ``label`` from ``label_dict``."""

    def __init__(self, img_name_list_path: str, voc12_root: str,
                 label_dict: Dict[str, np.ndarray]):
        super().__init__(img_name_list_path, voc12_root)
        self.label_list = [label_dict[n] for n in self.img_name_list]

    def __getitem__(self, idx: int) -> Dict:
        out = super().__getitem__(idx)
        out["label"] = self.label_list[idx]
        return out
