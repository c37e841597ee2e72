"""PASCAL VOC 2012 sources of the port: the counterparts of
``irn_tpu.data.voc12``'s id lists, class-label dictionaries,
``ImageDataset`` (with train_cam's ``resize_long``),
``ClassificationDataset``, ``MultiScaleDataset``, ``SegmentationDataset``
and ``AffinityDataset``, on the port's image I/O (Pillow, which is imageio's
own JPEG/PNG plugin: the same pixels). The augmenting datasets derive each
sample's generator from (seed, epoch, index) as the JAX ones do
(:class:`EpochSeeded`), so the same seed and epoch give the same arrays.

One default differs: the port's ``ImageDataset`` does not normalise unless
asked (``img_normal=False``; the inference stages upload uint8 and
normalise on the device), where the JAX class normalises by default, so
train_cam passes ``img_normal=True`` to both of its datasets.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from irn_tpu_torch.data import image_io
from irn_tpu_torch.data import transforms as T

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


def read_label_png(path: str) -> np.ndarray:
    """Label PNG -> integer index plane (palette PNGs stay index planes, as
    VOC's ground truth needs)."""
    return image_io.imread(path)


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


def _as_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3]


class EpochSeeded:
    """Per-sample generators derived from ``(seed, epoch, idx)``:
    deterministic for any number of loader threads, and drawn anew each
    epoch. :class:`irn_tpu_torch.data.loader.BatchLoader` calls
    :meth:`set_epoch` at the start of every epoch."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def sample_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self._epoch, int(idx)))


class ImageDataset(EpochSeeded):
    """Indexable {name, img [H, W, 3]} over an id list: uint8 unless
    ``img_normal``, then resized to a random long side (``resize_long``),
    scaled (``rescale``), normalised, flipped (``hor_flip``) and cropped
    (``crop_size``; ``crop_method`` "random", else top-left) in the JAX
    class's order."""

    def __init__(self, img_name_list_path: str, voc12_root: str,
                 resize_long: Optional[Tuple[int, int]] = None,
                 rescale: Optional[Tuple[float, float]] = None,
                 img_normal: bool = True, hor_flip: bool = False,
                 crop_size: Optional[int] = None,
                 crop_method: Optional[str] = None, seed: int = 0):
        super().__init__(seed)
        self.img_name_list = load_img_name_list(img_name_list_path)
        self.voc12_root = voc12_root
        self.resize_long = resize_long
        self.rescale = rescale
        self.img_normal = img_normal
        self.hor_flip = hor_flip
        self.crop_size = crop_size
        self.crop_method = crop_method

    def __len__(self) -> int:
        return len(self.img_name_list)

    def read_image(self, name: str) -> np.ndarray:
        return _as_rgb(image_io.imread(get_img_path(name, self.voc12_root)))

    def __getitem__(self, idx: int) -> Dict:
        name = self.img_name_list[idx]
        rng = self.sample_rng(idx)
        img = self.read_image(name)
        if self.resize_long:
            img = T.random_resize_long(img, *self.resize_long, rng=rng)
        if self.rescale:
            img = T.random_scale(img, self.rescale, 3, rng=rng)
        if self.img_normal:
            img = T.normalize(img)
        if self.hor_flip:
            img = T.random_lr_flip(img, rng=rng)
        if self.crop_size:
            if self.crop_method == "random":
                img = T.random_crop(img, self.crop_size, 0, rng=rng)
            else:
                img = T.top_left_crop(img, self.crop_size, 0)
        return {"name": name, "img": np.ascontiguousarray(img)}


class ClassificationDataset(ImageDataset):
    """Adds the 20-way multi-hot ``label`` from ``label_dict``."""

    def __init__(self, img_name_list_path: str, voc12_root: str,
                 label_dict: Dict[str, np.ndarray], **kw):
        super().__init__(img_name_list_path, voc12_root, **kw)
        self.label_list = [label_dict[n] for n in self.img_name_list]

    def __getitem__(self, idx: int) -> Dict:
        out = super().__getitem__(idx)
        out["label"] = self.label_list[idx]
        return out


class MultiScaleDataset(ClassificationDataset):
    """Per-image multi-scale (image, flip) stacks of normalised images
    (dataloader.py:175-205): ``img`` is a list of [2, H_s, W_s, 3], one
    per scale, and ``size`` the original (H, W)."""

    def __init__(self, img_name_list_path: str, voc12_root: str,
                 label_dict: Dict[str, np.ndarray],
                 scales: Sequence[float] = (1.0,)):
        super().__init__(img_name_list_path, voc12_root, label_dict)
        self.scales = tuple(scales)

    def __getitem__(self, idx: int) -> Dict:
        name = self.img_name_list[idx]
        img = self.read_image(name)
        ms = []
        for s in self.scales:
            s_img = img if s == 1 else T.pil_rescale(img, s, 3)
            s_img = T.normalize(s_img)
            ms.append(np.stack([s_img, np.fliplr(s_img)], axis=0))
        return {"name": name, "img": ms, "size": (img.shape[0], img.shape[1]),
                "label": self.label_list[idx]}


class SegmentationDataset(EpochSeeded):
    """Image + label map from ``label_dir`` (dataloader.py:207-253): one
    scale draw, flip and crop box for both, the label padded with 255."""

    def __init__(self, img_name_list_path: str, label_dir: str,
                 crop_size: int, voc12_root: str,
                 rescale: Optional[Tuple[float, float]] = None,
                 img_normal: bool = True, hor_flip: bool = False,
                 crop_method: str = "random", seed: int = 0):
        super().__init__(seed)
        self.img_name_list = load_img_name_list(img_name_list_path)
        self.voc12_root = voc12_root
        self.label_dir = label_dir
        self.rescale = rescale
        self.crop_size = crop_size
        self.img_normal = img_normal
        self.hor_flip = hor_flip
        self.crop_method = crop_method

    def __len__(self) -> int:
        return len(self.img_name_list)

    def __getitem__(self, idx: int) -> Dict:
        name = self.img_name_list[idx]
        rng = self.sample_rng(idx)
        img = _as_rgb(image_io.imread(get_img_path(name, self.voc12_root)))
        label = read_label_png(os.path.join(self.label_dir, name + ".png"))
        if self.rescale:
            img, label = T.random_scale((img, label), self.rescale, (3, 0),
                                        rng=rng)
        if self.img_normal:
            img = T.normalize(img)
        if self.hor_flip:
            img, label = T.random_lr_flip((img, label), rng=rng)
        if self.crop_method == "random":
            img, label = T.random_crop((img, label), self.crop_size, (0, 255),
                                       rng=rng)
        else:
            img = T.top_left_crop(img, self.crop_size, 0)
            label = T.top_left_crop(label, self.crop_size, 255)
        return {"name": name, "img": np.ascontiguousarray(img),
                "label": np.ascontiguousarray(label)}


class AffinityDataset(SegmentationDataset):
    """Adds the stride-4 nearest-downscaled label; the per-pair affinity
    masks are computed on the device
    (:func:`irn_tpu_torch.ops.affinity.affinity_labels_2d`)."""

    def __getitem__(self, idx: int) -> Dict:
        out = super().__getitem__(idx)
        out["reduced_label"] = T.pil_rescale(out["label"], 0.25, 0).astype(
            np.int32
        )
        return out
