"""Bilinear resize with torch ``F.interpolate(align_corners=False)``
semantics: half-pixel source coordinates, border clamping, no antialias —
the counterpart of :mod:`irn_tpu.ops.resize` (which reproduces exactly
this in JAX)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize the last two (spatial) dims of [..., H, W] to ``size``."""
    flat = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    out = F.interpolate(flat, size=tuple(size), mode="bilinear",
                        align_corners=False)
    return out.reshape(x.shape[:-2] + tuple(size))


def resize_bilinear_dynamic(src: torch.Tensor, src_true: Tuple[int, int],
                            out_true: Tuple[int, int],
                            out_cap: Tuple[int, int]) -> torch.Tensor:
    """The counterpart of ``irn_tpu.ops.resize.resize_bilinear_dynamic``:
    [..., H_cap, W_cap] with valid content in [0, src_true) resized
    half-pixel from the true source extent to the true output extent, in an
    ``out_cap`` buffer that is zero beyond ``out_true``.

    The JAX function takes the extents as traced scalars (one program for
    every size). Here they are Python ints, so crop, ``F.interpolate`` and
    zero-pad compute the same function."""
    (sh, sw), (oh, ow) = src_true, out_true
    if not (0 < sh <= src.shape[-2] and 0 < sw <= src.shape[-1]):
        raise ValueError(f"source extent {src_true} vs buffer "
                         f"{tuple(src.shape[-2:])}")
    if not (0 < oh <= out_cap[0] and 0 < ow <= out_cap[1]):
        raise ValueError(f"output extent {out_true} vs cap {tuple(out_cap)}")
    out = resize_bilinear(src[..., :sh, :sw], (oh, ow))
    return F.pad(out, (0, out_cap[1] - ow, 0, out_cap[0] - oh))
