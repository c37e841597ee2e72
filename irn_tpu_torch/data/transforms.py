"""The port's copies of the host-side image helpers of
``irn_tpu.data.transforms`` that make_cam needs (numpy and PIL only): the
ImageNet normalisation constants, the PIL rescale (bicubic for images,
nearest for label maps, as misc/imutils.py of the reference) and the
strided-size arithmetic, and make_ins_seg's ``compress_range``. The
training augmentations wait for train_cam and train_irn."""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def pil_resize(img: np.ndarray, size: Tuple[int, int], order: int) -> np.ndarray:
    """Resize an HW(C) array to (h, w) with PIL: order 3 bicubic, 0
    nearest; other orders raise."""
    from PIL import Image

    if size[0] == img.shape[0] and size[1] == img.shape[1]:
        return img
    if order == 3:
        resample = Image.BICUBIC
    elif order == 0:
        resample = Image.NEAREST
    else:
        raise ValueError(f"unsupported resize order {order} (use 0 or 3)")
    return np.asarray(Image.fromarray(img).resize(size[::-1], resample))


def pil_rescale(img: np.ndarray, scale: float, order: int) -> np.ndarray:
    h, w = img.shape[:2]
    return pil_resize(
        img, (int(np.round(h * scale)), int(np.round(w * scale))), order
    )


def get_strided_size(size: Tuple[int, int], stride: int) -> Tuple[int, int]:
    return ((size[0] - 1) // stride + 1, (size[1] - 1) // stride + 1)


def get_strided_up_size(size: Tuple[int, int], stride: int) -> Tuple[int, int]:
    s = get_strided_size(size, stride)
    return s[0] * stride, s[1] * stride


def compress_range(arr: np.ndarray) -> np.ndarray:
    """Renumber labels to a dense 0..K range (imutils.py:182-190)."""
    uniques = np.unique(arr)
    remap = np.zeros(int(uniques.max()) + 1, np.int32)
    remap[uniques] = np.arange(uniques.shape[0])
    out = remap[arr]
    return out - out.min()
