"""Bilinear resize with torch ``F.interpolate(align_corners=False)``
semantics: half-pixel source coordinates, border clamping, no antialias —
the counterpart of :func:`irn_tpu.ops.resize.resize_bilinear` (which
reproduces exactly this in JAX). The dynamic-extent variant
(``resize_bilinear_dynamic``) arrives with make_cam."""

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
