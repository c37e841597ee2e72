"""The port's copies of the host-side image helpers of
``irn_tpu.data.transforms`` (numpy and PIL only, HWC): the ImageNet
normalisation constants, the PIL rescale (bicubic for images, nearest for
label maps, as misc/imutils.py of the reference), the strided-size
arithmetic, make_ins_seg's ``compress_range``, and the train stages'
augmentations (train_cam's random long-side resize, random scale,
left-right flip, random crop into a padded canvas, top-left and centre
crops, normalisation), whose randomness flows through an explicit
``np.random.Generator``: the same generator state gives the same arrays as
the JAX package."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

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


def random_resize_long(
    img: np.ndarray, min_long: int, max_long: int, rng: np.random.Generator
) -> np.ndarray:
    """Bicubic rescale so the long side is a draw from [min_long,
    max_long]."""
    target = int(rng.integers(min_long, max_long + 1))
    h, w = img.shape[:2]
    scale = target / max(h, w)
    return pil_rescale(img, scale, 3)


def random_scale(
    arrays: Union[np.ndarray, Sequence[np.ndarray]],
    scale_range: Tuple[float, float],
    orders: Union[int, Sequence[int]],
    rng: np.random.Generator,
):
    """Rescale one array, or several by one draw (one order each)."""
    scale = scale_range[0] + rng.random() * (scale_range[1] - scale_range[0])
    if isinstance(arrays, np.ndarray):
        return pil_rescale(arrays, scale, orders)  # type: ignore[arg-type]
    return tuple(pil_rescale(a, scale, o) for a, o in zip(arrays, orders))


def random_lr_flip(
    arrays: Union[np.ndarray, Sequence[np.ndarray]], rng: np.random.Generator
):
    if rng.integers(0, 2) == 0:
        return arrays
    if isinstance(arrays, np.ndarray):
        return np.fliplr(arrays)
    return tuple(np.fliplr(a) for a in arrays)


def random_crop_box(
    imgsize: Tuple[int, int], cropsize: int, rng: np.random.Generator
):
    """(cont_top, cont_bot, cont_left, cont_right, img_top, img_bot,
    img_left, img_right) — container and source windows for a random crop
    into a padded canvas (imutils.py:55-78)."""
    h, w = imgsize
    ch = min(cropsize, h)
    cw = min(cropsize, w)
    w_space = w - cropsize
    h_space = h - cropsize

    if w_space > 0:
        cont_left = 0
        img_left = int(rng.integers(0, w_space + 1))
    else:
        cont_left = int(rng.integers(0, -w_space + 1))
        img_left = 0
    if h_space > 0:
        cont_top = 0
        img_top = int(rng.integers(0, h_space + 1))
    else:
        cont_top = int(rng.integers(0, -h_space + 1))
        img_top = 0
    return (cont_top, cont_top + ch, cont_left, cont_left + cw,
            img_top, img_top + ch, img_left, img_left + cw)


def _canvas(img: np.ndarray, cropsize: int, fill) -> np.ndarray:
    if img.ndim == 3:
        return np.full((cropsize, cropsize, img.shape[2]), fill, img.dtype)
    return np.full((cropsize, cropsize), fill, img.dtype)


def crop_with_box(img: np.ndarray, box, cropsize: int, fill) -> np.ndarray:
    out = _canvas(img, cropsize, fill)
    out[box[0]:box[1], box[2]:box[3]] = img[box[4]:box[5], box[6]:box[7]]
    return out


def random_crop(
    arrays: Union[np.ndarray, Sequence[np.ndarray]],
    cropsize: int,
    fills,
    rng: np.random.Generator,
):
    """Crop one array, or several through one box (one fill each)."""
    single = isinstance(arrays, np.ndarray)
    if single:
        arrays = (arrays,)
        fills = (fills,)
    box = random_crop_box(arrays[0].shape[:2], cropsize, rng)
    outs = tuple(crop_with_box(a, box, cropsize, f)
                 for a, f in zip(arrays, fills))
    return outs[0] if single else outs


def top_left_crop(img: np.ndarray, cropsize: int, fill) -> np.ndarray:
    h, w = img.shape[:2]
    ch, cw = min(cropsize, h), min(cropsize, w)
    out = _canvas(img, cropsize, fill)
    out[:ch, :cw] = img[:ch, :cw]
    return out


def center_crop(img: np.ndarray, cropsize: int, fill=0) -> np.ndarray:
    """The centred ``cropsize`` window, or the image centred in a
    ``fill`` canvas along a side shorter than it."""
    h, w = img.shape[:2]
    ch, cw = min(cropsize, h), min(cropsize, w)
    sh, sw = h - cropsize, w - cropsize
    cont_top = 0 if sh > 0 else int(round(-sh / 2))
    img_top = int(round(sh / 2)) if sh > 0 else 0
    cont_left = 0 if sw > 0 else int(round(-sw / 2))
    img_left = int(round(sw / 2)) if sw > 0 else 0
    out = _canvas(img, cropsize, fill)
    out[cont_top:cont_top + ch, cont_left:cont_left + cw] = \
        img[img_top:img_top + ch, img_left:img_left + cw]
    return out


def normalize(img: np.ndarray,
              mean: np.ndarray = IMAGENET_MEAN,
              std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """uint8 HWC -> float32 normalized (voc12/dataloader.py:65-78)."""
    return ((img.astype(np.float32) / 255.0) - mean) / std


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
