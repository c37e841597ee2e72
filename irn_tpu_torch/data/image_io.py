"""Image file I/O for the port, through Pillow.

The JAX package reads and writes images with ``imageio`` at module level
(``irn_tpu.data.voc12``, ``irn_tpu.data.synthetic``, the stages). A host
may have Pillow without imageio; imageio's own JPEG/PNG plugin is Pillow,
so the port decodes the same pixels with Pillow alone. Pillow is not
imported until an image is read or written."""

from __future__ import annotations

import numpy as np


def imread(path: str) -> np.ndarray:
    """Decode an image file to a numpy array (HxW or HxWxC); palette PNGs
    stay index planes, as ``irn_tpu.data.voc12.read_label_png``."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def imwrite(path: str, arr: np.ndarray) -> None:
    """Encode ``arr`` (uint8 HxW or HxWx3) by the path's extension; JPEG at
    quality 75 (imageio's default)."""
    from PIL import Image

    kw = {"quality": 75} if path.lower().endswith((".jpg", ".jpeg")) else {}
    Image.fromarray(np.ascontiguousarray(arr)).save(path, **kw)
