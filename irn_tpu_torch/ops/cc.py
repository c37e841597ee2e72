"""Connected components and COCO run-length encoding: the port's copy of
``irn_tpu.ops.cc`` (the reference's ``skimage.measure.label`` with
connectivity 1 and the pycocotools RLE encoder), on the port's own native
library (:mod:`irn_tpu_torch.ops.native`, built from ``native/`` at first
use), with the same scipy / numpy fallbacks where no C++ compiler is
found."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from irn_tpu_torch.ops import native


def label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connectivity labeling of a binary mask: (labels [h, w] int32 with
    components numbered 1..K in row-major first-appearance order, K)."""
    m = np.ascontiguousarray(mask.astype(np.uint8))
    lib = native.load()
    if lib is not None:
        out = np.empty(m.shape, np.int32)
        k = lib.irn_label_components(
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            m.shape[0], m.shape[1],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out, int(k)
    from scipy import ndimage

    lab, k = ndimage.label(m, structure=np.array([[0, 1, 0], [1, 1, 1],
                                                  [0, 1, 0]]))
    return lab.astype(np.int32), int(k)


def to_one_hot(labels: np.ndarray,
               maximum_val: Optional[int] = None) -> np.ndarray:
    """[K, h, w] boolean one-hot of an int map (misc/pyutils.py:86-101)."""
    if maximum_val is None:
        maximum_val = int(labels.max()) + 1
    flat = labels.reshape(-1)
    one_hot = np.zeros((maximum_val, flat.shape[0]), bool)
    one_hot[flat, np.arange(flat.shape[0])] = True
    return one_hot.reshape((maximum_val,) + labels.shape)


def rle_encode(mask: np.ndarray) -> Dict:
    """COCO uncompressed RLE (column-major runs, zeros first)."""
    m = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = m.shape
    lib = native.load()
    if lib is not None:
        buf = np.empty(h * w + 1, np.uint32)
        n = lib.irn_rle_encode(
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        counts = buf[:n].tolist()
    else:
        flat = m.T.reshape(-1)  # Fortran order
        changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        bounds = np.concatenate([[0], changes, [flat.size]])
        counts = np.diff(bounds).tolist()
        if flat[0] == 1:  # RLE starts with a zero-run
            counts = [0] + counts
    return {"counts": [int(c) for c in counts], "size": [int(h), int(w)]}


def rle_decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in rle["counts"]:
        flat[pos : pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T  # column-major
